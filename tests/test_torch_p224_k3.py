"""The port's multi-party path over a curve: k=3 mix-servers, threshold
2, Fiat–Shamir, over the NIST curve P-224, against `vmn_tpu` on the CPU.

The port's golden mix (tools/make_golden.py's k=3 run: P-224, width 1,
n=3, `SeededSource(f"golden-party{j}")`, `SeededSource(b"golden-ciphs")`,
the three parties in threads), run once for the module, rewrites party
1's transcript and the verifier's test vectors that `vmn_tpu` wrote
(tests/golden/nizkp_p224_k3, test_vectors_p224_k3.json, by
tests/torch_make_wide_golden.py); the parties agree, the plaintext
multiset is preserved, and the kernel wrappers the mix calls are
recorded: each is one whose kernel converts at a padded modulus.  The
interactive coin flipping over P-224 (`vmn_tpu`'s setup of
tests/test_mixnet_ec.py) gives the coins `vmn_tpu` gave
(tests/golden/coinflip_p224_k3.json).  On a CUDA device only (skipped
here): the golden mix on the card.

Tolerance: exact equality of bytes, test vectors and coins.
"""

import json
from pathlib import Path

import pytest

import torch_make_wide_golden as W
from torch_port_util import (  # noqa: F401 (cuda_device: fixture)
    GOLDEN, TV_NAMES, assert_same_transcript, cuda_device, p224_coins,
    record_calls, run_parties,
)
from vmn_tpu_torch.ops import mont_kernels as K

NIZKP, TVS = (GOLDEN / name for name in W.fixture_names("P-224-k3"))
KP, T, N = 3, 2, 3


def k3_golden_mix(device, root: Path):
    """The k=3, t=2 golden mix over P-224 by the port on `device`:
    (party 1's nizkp dir, messages, each party's plaintext points,
    the port verifier's test vectors on party 1's transcript)."""
    from vmn_tpu_torch.arith.ec import ECqPGroup
    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.protocol import elgamal
    from vmn_tpu_torch.protocol.com.board import LocalBoardHub
    from vmn_tpu_torch.protocol.context import ProtocolParams
    from vmn_tpu_torch.protocol.mixnet.party import MixNetParty
    from vmn_tpu_torch.protocol.mixnet.verifier import FiatShamirVerifier

    group = ECqPGroup.named("P-224", device=device)
    params = ProtocolParams(sid="Golden", k=KP, threshold=T, pgroup=group)
    hub = LocalBoardHub(KP)

    def keygen(j):
        party = MixNetParty(params, hub.board(j),
                            SeededSource(f"golden-party{j}".encode()),
                            str(root / f"P{j:02d}"))
        party.keygen()
        return party

    parties = run_parties(KP, keygen)
    pk = parties[1].full_public_key()
    msgs = [group.encode_message(f"{i:08d}".encode()) for i in range(N)]
    r = group.ring.random((N,), SeededSource(b"golden-ciphs"), 0)
    ciphs = elgamal.encrypt(pk, group.from_affine(msgs), r)
    hub2 = LocalBoardHub(KP)

    def mix(j):
        parties[j].board = hub2.board(j)
        return parties[j].session("golden", 1).mix(ciphs).to_affine()

    plain = run_parties(KP, mix)
    nizkp = root / "P01" / "nizkp.golden"
    verifier = FiatShamirVerifier(params, nizkp, test_vectors=TV_NAMES)
    assert verifier.verify(expected_type="mixing").ok
    return nizkp, msgs, plain, verifier.tv


@pytest.fixture(scope="module")
def k3_mix(tmp_path_factory):
    """The golden mix on the CPU and the kernel wrappers it called."""
    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        record_calls(mp, calls)
        mix = k3_golden_mix("cpu", tmp_path_factory.mktemp("port_p224_k3"))
    return (*mix, calls)


def test_port_rewrites_p224_k3_golden_transcript(k3_mix):
    assert_same_transcript(k3_mix[0], NIZKP)


def test_port_verifier_writes_p224_k3_test_vectors(k3_mix):
    assert k3_mix[3] == json.loads(TVS.read_text())


def test_p224_k3_parties_agree_and_preserve_the_multiset(k3_mix):
    _, msgs, plain, _, _ = k3_mix
    assert plain[1] == plain[2] == plain[3]
    assert sorted(plain[1]) == sorted(msgs)


def test_p224_k3_mix_calls_only_converting_wrappers(k3_mix):
    """The kernel wrappers the k=3 golden run calls (keygen, mix and
    verify): products and powers (H1, H2), scalar multiples (H5) and
    additions (H8), every one a wrapper whose kernel converts at a
    padded modulus; H3, H4, K7's combine and H7, whose wrappers raise at
    P-224 on the card, are not called."""
    calls = k3_mix[4]
    assert {"mont_mul", "mont_exp", "ec_scalar_mul", "ec_point_add"} <= set(
        calls) <= K.CONVERTS


def test_p224_coinflip_matches_vmn_tpu():
    """The jointly flipped coins of three parties over P-224 (the generic
    dealing of `_prepare_coins_generic`, ECArray commitments) equal the
    coins `vmn_tpu` flipped with the same setup."""
    want = json.loads((GOLDEN / W.COINS_FILE).read_text())["coins"]
    assert p224_coins() == [want] * W.COIN_K


@pytest.mark.cuda
def test_cuda_p224_k3_golden_mix_rewrites_the_transcript(tmp_path,
                                                         cuda_device):
    """The k=3 golden mix on the card: vmn_tpu's transcript and test
    vectors, byte for byte."""
    nizkp, msgs, plain, tv = k3_golden_mix(cuda_device, tmp_path)
    assert_same_transcript(nizkp, NIZKP)
    assert tv == json.loads(TVS.read_text())
    assert sorted(plain[1]) == sorted(msgs)

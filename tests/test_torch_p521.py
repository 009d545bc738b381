"""The port's k=1 mix at the NIST curve P-521 (field and ring of L = 33
limbs, an odd count) against `vmn_tpu` on the CPU.

The port's golden mix (the inputs of tools/make_golden.py: P-521, n=3,
`SeededSource(b"golden-party")`, `SeededSource(b"golden-ciphs")`)
rewrites the transcript that `vmn_tpu` wrote (tests/golden/nizkp_p521_k1,
by tests/torch_make_wide_golden.py) byte for byte, preserves the
plaintext multiset, and `vmn_tpu`'s verifier accepts the port's
transcript with the 41 test vectors of tests/golden/test_vectors_p521.json.
The port's verifier on `vmn_tpu`'s transcript is
tests/test_torch_p521_verify.py (a file of its own, so that the test
workers run the two beside each other); the kernels are
tests/test_torch_p521_kernels.py.  On a CUDA device only (skipped here):
the golden mix on the card.

Tolerance: exact equality of bytes.
"""

import json
from pathlib import Path

import pytest

from torch_port_util import (  # noqa: F401 (cuda_device: fixture)
    TV_NAMES, cuda_device, golden_files,
)
from vmn_tpu_torch.arith.ec import ECqPGroup as TGroup

GOLDEN = Path(__file__).parent / "golden" / "nizkp_p521_k1"
N = 3


def _golden_mix(device, out: Path):
    """The golden k=1 mix of tools/make_golden.py by the port on `device`:
    (nizkp dir, messages, plaintext points)."""
    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.protocol import elgamal
    from vmn_tpu_torch.protocol.com.board import LocalBoardHub
    from vmn_tpu_torch.protocol.context import ProtocolParams
    from vmn_tpu_torch.protocol.mixnet.party import MixNetParty

    group = TGroup.named("P-521", device=device)
    params = ProtocolParams(sid="Golden", k=1, threshold=1, pgroup=group)
    party = MixNetParty(params, LocalBoardHub(1).board(1),
                        SeededSource(b"golden-party"), str(out))
    pk = party.keygen()
    msgs = [group.encode_message(f"{i:08d}".encode()) for i in range(N)]
    r = group.ring.random((N,), SeededSource(b"golden-ciphs"), 0)
    ciphs = elgamal.encrypt(pk, group.from_affine(msgs), r)
    party.board = LocalBoardHub(1).board(1)
    plain = party.session("golden", 1).mix(ciphs)
    return out / "nizkp.golden", msgs, plain.to_affine()


def _same_transcript(nizkp: Path) -> None:
    assert golden_files(nizkp) == golden_files(GOLDEN)
    for rel in golden_files(GOLDEN):
        assert (nizkp / rel).read_bytes() == (GOLDEN / rel).read_bytes(), rel


@pytest.fixture(scope="module")
def port_mix(tmp_path_factory):
    """The golden mix run by the port on the CPU (about 130 s of plain
    521-bit scalar multiples)."""
    return _golden_mix("cpu", tmp_path_factory.mktemp("port_golden_p521"))


def test_port_rewrites_golden_p521_transcript(port_mix):
    _same_transcript(port_mix[0])


def test_port_p521_mix_preserves_plaintext_multiset(port_mix):
    _, msgs, plain = port_mix
    assert sorted(plain) == sorted(msgs)


def test_vmn_tpu_verifier_accepts_port_p521_transcript(port_mix):
    """vmn_tpu's verifier on the port's transcript: accepted, with the 41
    test vectors it froze for its own."""
    from vmn_tpu.arith.ec import ECqPGroup
    from vmn_tpu.protocol.context import ProtocolParams
    from vmn_tpu.protocol.mixnet.verifier import FiatShamirVerifier

    params = ProtocolParams(sid="Golden", k=1, threshold=1,
                            pgroup=ECqPGroup.named("P-521"))
    v = FiatShamirVerifier(params, port_mix[0], test_vectors=TV_NAMES)
    assert v.verify(expected_type="mixing").ok
    want = json.loads((GOLDEN.parent / "test_vectors_p521.json").read_text())
    assert len(want) == 41 and v.tv == want


@pytest.mark.cuda
def test_cuda_p521_golden_mix_rewrites_the_transcript(tmp_path, cuda_device):
    """The golden mix on the card (the kernels at W' = 20): vmn_tpu's
    transcript, byte for byte."""
    _same_transcript(_golden_mix(cuda_device, tmp_path)[0])

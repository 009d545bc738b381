"""The port's P-256 k=1 mix path end to end on the CPU, against the
committed golden transcript that `vmn_tpu` wrote
(tests/golden/nizkp_p256_k1, inputs of tools/make_golden.py: P-256, k=1,
n=3, `SeededSource(b"golden-party")`, `SeededSource(b"golden-ciphs")`).

`tests/test_golden.py` holds the same golden to `vmn_tpu`, so the byte
equality checked here also means that `vmn_tpu`'s verifier accepts the
port's transcript; it is not run a second time.

Tolerance: exact equality of every transcript byte.
"""

import shutil
from pathlib import Path

import pytest

import torch_port_util  # noqa: F401 (torch thread count)
from vmn_tpu_torch.arith.ec import ECqPGroup
from vmn_tpu_torch.crypto.randomsource import SeededSource
from vmn_tpu_torch.eio.bytetree import lazy_from_bytes
from vmn_tpu_torch.protocol import elgamal
from vmn_tpu_torch.protocol.com.board import LocalBoardHub
from vmn_tpu_torch.protocol.context import ProtocolParams
from vmn_tpu_torch.protocol.mixnet.party import MixNetParty
from vmn_tpu_torch.protocol.mixnet.verifier import FiatShamirVerifier

GOLDEN = Path(__file__).parent / "golden" / "nizkp_p256_k1"
N = 3


def _params():
    return ProtocolParams(sid="Golden", k=1, threshold=1,
                          pgroup=ECqPGroup.named("P-256", device="cpu"))


def _files(root: Path):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


@pytest.fixture(scope="module")
def port_mix(tmp_path_factory):
    """The golden mix run by the port; returns (nizkp dir, messages,
    plaintext points)."""
    out = tmp_path_factory.mktemp("port_golden_p256")
    params = _params()
    group = params.pgroup
    party = MixNetParty(params, LocalBoardHub(1).board(1),
                        SeededSource(b"golden-party"), str(out))
    pk = party.keygen()
    msgs = [group.encode_message(f"{i:08d}".encode()) for i in range(N)]
    r = group.ring.random((N,), SeededSource(b"golden-ciphs"), 0)
    ciphs = elgamal.encrypt(pk, group.from_affine(msgs), r)
    # the port encrypts to the bytes vmn_tpu wrote, and reads those bytes
    golden_ciphs = (GOLDEN / "Ciphertexts.bt").read_bytes()
    assert ciphs.to_bytetree().to_bytes() == golden_ciphs
    ciphs = elgamal.ciph_group(group, 1).elem_from_bytetree(
        lazy_from_bytes(golden_ciphs), N)
    party.board = LocalBoardHub(1).board(1)
    plain = party.session("golden", 1).mix(ciphs)
    return out / "nizkp.golden", msgs, plain.to_affine()


def test_port_rewrites_golden_p256_transcript(port_mix):
    nizkp, _, _ = port_mix
    assert _files(nizkp) == _files(GOLDEN)
    for rel in _files(GOLDEN):
        assert (nizkp / rel).read_bytes() == (GOLDEN / rel).read_bytes(), rel


def test_port_p256_mix_preserves_plaintext_multiset(port_mix):
    _, msgs, plain = port_mix
    assert sorted(plain) == sorted(msgs)


def test_port_verifier_accepts_vmn_tpu_p256_transcript():
    res = FiatShamirVerifier(_params(), GOLDEN).verify(expected_type="mixing")
    assert res.ok


def test_port_verifier_rejects_flipped_p256_reply_byte(tmp_path):
    nizkp = tmp_path / "nizkp"
    shutil.copytree(GOLDEN, nizkp)
    reply = nizkp / "proofs" / "PoSReply01.bt"
    raw = bytearray(reply.read_bytes())
    raw[-1] ^= 0x01
    reply.write_bytes(bytes(raw))
    res = FiatShamirVerifier(_params(), nizkp).verify(expected_type="mixing")
    assert not res.ok


def test_port_group_names_match_p256_test_vectors():
    """The verifier's bas.* group test vectors are the groups' reprs; over
    P-256 they must read as vmn_tpu wrote them
    (tests/golden/test_vectors_p256.json), whatever the device."""
    import json

    from vmn_tpu_torch.protocol.context import ProtocolContext

    want = json.loads((GOLDEN.parent / "test_vectors_p256.json").read_text())
    ctx = ProtocolContext(_params())
    width = int(want["par.omega"])
    assert repr(ctx.ciph_group(width)) == want["bas.C_omega"]
    assert repr(ctx.plain_group(width)) == want["bas.M_omega"]
    assert repr(ctx.plain_group(width).ring) == want["bas.R_omega"]

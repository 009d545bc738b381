"""The port's k=1 mix path end to end on the CPU, against the committed
golden transcript that `vmn_tpu` wrote (tests/golden/nizkp_test256_k1,
inputs of tools/make_golden.py: test256, k=1, n=5,
`SeededSource(b"golden-party")`, `SeededSource(b"golden-ciphs")`).

Tolerance: exact equality of every transcript byte.
"""

import json
import shutil
from pathlib import Path

import pytest

import torch_port_util  # noqa: F401 (torch thread count)
from torch_port_util import TV_NAMES
from vmn_tpu_torch.arith.pgroup import ModPGroup
from vmn_tpu_torch.crypto.randomsource import SeededSource
from vmn_tpu_torch.eio.bytetree import lazy_from_bytes
from vmn_tpu_torch.protocol import elgamal
from vmn_tpu_torch.protocol.com.board import LocalBoardHub
from vmn_tpu_torch.protocol.context import ProtocolParams
from vmn_tpu_torch.protocol.mixnet.party import MixNetParty
from vmn_tpu_torch.protocol.mixnet.verifier import FiatShamirVerifier

GOLDEN = Path(__file__).parent / "golden" / "nizkp_test256_k1"
N = 5


def _params():
    return ProtocolParams(sid="Golden", k=1, threshold=1,
                          pgroup=ModPGroup.named("test256", device="cpu"))


def _files(root: Path):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


@pytest.fixture(scope="module")
def port_mix(tmp_path_factory):
    """The golden mix run by the port; returns (nizkp dir, messages,
    plaintext ints)."""
    out = tmp_path_factory.mktemp("port_golden")
    params = _params()
    group = params.pgroup
    party = MixNetParty(params, LocalBoardHub(1).board(1),
                        SeededSource(b"golden-party"), str(out))
    pk = party.keygen()
    msgs = [group.encode_message(f"{i:08d}".encode()) for i in range(N)]
    r = group.ring.random((N,), SeededSource(b"golden-ciphs"), 0)
    ciphs = elgamal.encrypt(pk, group.from_ints(msgs), r)
    # the port encrypts to the bytes vmn_tpu wrote, and reads those bytes
    golden_ciphs = (GOLDEN / "Ciphertexts.bt").read_bytes()
    assert ciphs.to_bytetree().to_bytes() == golden_ciphs
    ciphs = elgamal.ciph_group(group, 1).elem_from_bytetree(
        lazy_from_bytes(golden_ciphs), N)
    party.board = LocalBoardHub(1).board(1)
    plain = party.session("golden", 1).mix(ciphs)
    return out / "nizkp.golden", msgs, plain.to_ints()


def test_port_rewrites_golden_transcript(port_mix):
    nizkp, _, _ = port_mix
    assert _files(nizkp) == _files(GOLDEN)
    for rel in _files(GOLDEN):
        assert (nizkp / rel).read_bytes() == (GOLDEN / rel).read_bytes(), rel


def test_port_mix_preserves_plaintext_multiset(port_mix):
    _, msgs, plain = port_mix
    assert sorted(plain) == sorted(msgs)


def test_port_verifier_writes_golden_test_vectors(port_mix):
    """The verifier's test vectors on the port's own transcript are the
    ones vmn_tpu froze (tests/golden/test_vectors.json)."""
    nizkp, _, _ = port_mix
    v = FiatShamirVerifier(_params(), nizkp, test_vectors=TV_NAMES)
    res = v.verify(expected_type="mixing")
    assert res.ok and res.test_vectors is v.tv
    want = json.loads((GOLDEN.parent / "test_vectors.json").read_text())
    assert v.tv == want


def test_port_verifier_switches_skip_parts(tmp_path):
    """check_dec=False skips the decryption proof, check_pos=False the
    proofs of shuffle: a flipped PoS reply byte is seen only with the
    shuffle part on.  Without it a mixing transcript is decrypted from
    ShuffledCiphertexts.bt, where vmn_tpu looks for a list no party
    writes and fails (ROADMAP queue 3, F9)."""
    from vmn_tpu.arith.pgroup import ModPGroup as JG
    from vmn_tpu.protocol.context import ProtocolParams as JParams
    from vmn_tpu.protocol.mixnet.verifier import FiatShamirVerifier as JV
    from vmn_tpu.protocol.mixnet.verifier import VerificationError as JErr

    nizkp = tmp_path / "nizkp"
    shutil.copytree(GOLDEN, nizkp)
    reply = nizkp / "proofs" / "PoSReply01.bt"
    raw = bytearray(reply.read_bytes())
    raw[-1] ^= 0x01
    reply.write_bytes(bytes(raw))
    v = FiatShamirVerifier(_params(), nizkp)
    no_dec = v.verify(expected_type="mixing", check_dec=False, sloppy=True)
    assert not no_dec.shuffle_ok and no_dec.decrypt_ok
    no_pos = v.verify(expected_type="mixing", check_pos=False)
    assert no_pos.ok and no_pos.shuffle_ok and no_pos.decrypt_ok
    jparams = JParams(sid="Golden", k=1, threshold=1,
                      pgroup=JG.named("test256"))
    with pytest.raises(JErr, match="Ciphertexts01.bt"):
        JV(jparams, nizkp).verify(expected_type="mixing", check_pos=False)
    # a wrong published plaintext still fails the decryption part
    plain = nizkp / "Plaintexts.bt"
    raw = bytearray(plain.read_bytes())
    raw[-1] ^= 0x01
    plain.write_bytes(bytes(raw))
    assert not v.verify(expected_type="mixing", check_pos=False).ok


def test_port_verifier_accepts_vmn_tpu_transcript():
    res = FiatShamirVerifier(_params(), GOLDEN).verify(expected_type="mixing")
    assert res.ok


def test_port_verifier_rejects_flipped_reply_byte(tmp_path):
    nizkp = tmp_path / "nizkp"
    shutil.copytree(GOLDEN, nizkp)
    reply = nizkp / "proofs" / "PoSReply01.bt"
    raw = bytearray(reply.read_bytes())
    raw[-1] ^= 0x01
    reply.write_bytes(bytes(raw))
    res = FiatShamirVerifier(_params(), nizkp).verify(expected_type="mixing")
    assert not res.ok


def test_port_loads_vmn_tpu_key_directory(tmp_path):
    """A key directory written by vmn_tpu's keygen loads into the port."""
    from vmn_tpu.arith.pgroup import ModPGroup as JG
    from vmn_tpu.crypto.randomsource import SeededSource as JSeeded
    from vmn_tpu.protocol.com.board import LocalBoardHub as JHub
    from vmn_tpu.protocol.context import ProtocolParams as JParams
    from vmn_tpu.protocol.mixnet.party import MixNetParty as JParty

    jparams = JParams(sid="Golden", k=1, threshold=1,
                      pgroup=JG.named("test256"))
    JParty(jparams, JHub(1).board(1), JSeeded(b"golden-party"),
           str(tmp_path)).keygen()
    party = MixNetParty(_params(), LocalBoardHub(1).board(1),
                        SeededSource(b"unused"), str(tmp_path))
    assert party.load_keys()
    fpk = party.full_public_key().to_bytetree().to_bytes()
    assert fpk == (tmp_path / "state" / "FullPublicKey.bt").read_bytes()
    assert fpk == (GOLDEN / "FullPublicKey.bt").read_bytes()

"""The port's precomputation path end to end on the CPU: precomputation
(PoSC) -> keep-list shrink -> CCPoS shuffle -> decryption -> verify,
against the golden that `vmn_tpu` wrote
(tests/golden/nizkp_test256_k1_precomp, the inputs of
tools/make_golden.py: test256, k=1, n=5, maxciph 8,
`SeededSource(b"golden-party")`, `SeededSource(b"golden-ciphs")`) and
against `vmn_tpu`'s verifier on a k=3, t=2 transcript of the port.

Tolerance: exact equality of every transcript byte and test vector.
"""

import json
import shutil
from pathlib import Path

import pytest

import torch_port_util  # noqa: F401 (torch thread count)
from torch_port_util import TV_NAMES, golden_files, run_parties
from vmn_tpu_torch.arith.pgroup import ModPGroup
from vmn_tpu_torch.crypto.randomsource import SeededSource
from vmn_tpu_torch.eio.bytetree import lazy_from_bytes
from vmn_tpu_torch.protocol import elgamal
from vmn_tpu_torch.protocol.com.board import LocalBoardHub
from vmn_tpu_torch.protocol.context import ProtocolParams
from vmn_tpu_torch.protocol.mixnet.party import MixNetParty
from vmn_tpu_torch.protocol.mixnet.verifier import FiatShamirVerifier

GOLDEN = Path(__file__).parent / "golden" / "nizkp_test256_k1_precomp"
N, MAXCIPH = 5, 8


def _params(k=1, threshold=1, sid="Golden"):
    return ProtocolParams(sid=sid, k=k, threshold=threshold,
                          pgroup=ModPGroup.named("test256", device="cpu"))


def _golden_ciphs():
    return elgamal.ciph_group(_params().pgroup, 1).elem_from_bytetree(
        lazy_from_bytes((GOLDEN / "Ciphertexts.bt").read_bytes()), N)


def _msgs(group, n):
    return [group.encode_message(f"{i:08d}".encode()) for i in range(n)]


@pytest.fixture(scope="module")
def port_precomp_mix(tmp_path_factory):
    """The golden precomputation mix run by the port in one object;
    returns (nizkp dir, messages, plaintext ints)."""
    out = tmp_path_factory.mktemp("port_precomp_golden")
    params = _params()
    group = params.pgroup
    party = MixNetParty(params, LocalBoardHub(1).board(1),
                        SeededSource(b"golden-party"), str(out))
    pk = party.keygen()
    msgs = _msgs(group, N)
    r = group.ring.random((N,), SeededSource(b"golden-ciphs"), 0)
    ciphs = elgamal.encrypt(pk, group.from_ints(msgs), r)
    assert (ciphs.to_bytetree().to_bytes()
            == (GOLDEN / "Ciphertexts.bt").read_bytes())
    party.board = LocalBoardHub(1).board(1)
    session = party.session("golden", 1)
    session.precomp(MAXCIPH)
    plain = session.mix(_golden_ciphs())
    return out / "nizkp.golden", msgs, plain.to_ints()


def _same_files(nizkp, golden=GOLDEN):
    assert golden_files(nizkp) == golden_files(golden)
    for rel in golden_files(golden):
        assert (nizkp / rel).read_bytes() == (golden / rel).read_bytes(), rel


def test_port_rewrites_precomp_golden(port_precomp_mix):
    nizkp, msgs, plain = port_precomp_mix
    _same_files(nizkp)
    assert sorted(plain) == sorted(msgs)


def test_port_verifier_writes_precomp_test_vectors(port_precomp_mix):
    nizkp, _, _ = port_precomp_mix
    v = FiatShamirVerifier(_params(), nizkp, test_vectors=TV_NAMES)
    assert v.verify(expected_type="mixing").ok
    want = json.loads(
        (GOLDEN.parent / "test_vectors_precomp.json").read_text())
    assert v.tv == want


def _flipped(tmp_path, name):
    nizkp = tmp_path / "nizkp"
    shutil.copytree(GOLDEN, nizkp)
    f = nizkp / "proofs" / name
    raw = bytearray(f.read_bytes())
    raw[-1] ^= 0x01
    f.write_bytes(bytes(raw))
    return nizkp


def test_port_verifier_accepts_vmn_tpu_precomp_golden():
    assert FiatShamirVerifier(_params(), GOLDEN).verify(
        expected_type="mixing").ok


@pytest.mark.parametrize("name", ["CCPoSReply01.bt", "PoSCReply01.bt",
                                  "KeepList01.bt"])
def test_port_verifier_rejects_flipped_precomp_byte(tmp_path, name):
    """A flipped reply byte fails the shuffle; a keep list whose count
    is no longer n fails the verification outright, as in vmn_tpu."""
    from vmn_tpu_torch.protocol.mixnet.verifier import VerificationError

    v = FiatShamirVerifier(_params(), _flipped(tmp_path, name))
    if name == "KeepList01.bt":
        with pytest.raises(VerificationError, match="keep list"):
            v.verify(expected_type="mixing")
        return
    res = v.verify(expected_type="mixing")
    assert not res.ok and not res.shuffle_ok


@pytest.mark.parametrize("name, switch", [
    ("PoSCReply01.bt", "check_posc"), ("CCPoSReply01.bt", "check_ccpos")])
def test_port_verifier_precomp_switches_skip_parts(tmp_path, name, switch):
    """check_posc=False skips the PoSC proofs, check_ccpos=False the
    CCPoS proofs: a flipped byte in the skipped proof goes unseen, one in
    the other is still seen."""
    nizkp = _flipped(tmp_path, name)
    v = FiatShamirVerifier(_params(), nizkp)
    assert v.verify(expected_type="mixing", **{switch: False}).ok
    other = "check_ccpos" if switch == "check_posc" else "check_posc"
    assert not v.verify(expected_type="mixing", **{other: False}).ok


def _precomp_then_fresh_mix(directory, party_cls, hub_cls, source_cls,
                            ciphs):
    """precomp in one party object, then the mix from a fresh one on the
    same directory (as `vmn -precomp`, then `vmn -mix`); the nizkp dir."""
    params = _params()
    if party_cls is not MixNetParty:
        from vmn_tpu.arith.pgroup import ModPGroup as JG
        from vmn_tpu.protocol.context import ProtocolParams as JParams

        params = JParams(sid="Golden", k=1, threshold=1,
                         pgroup=JG.named("test256"))
    first = party_cls(params, hub_cls(1).board(1),
                      source_cls(b"golden-party"), str(directory))
    first.keygen()
    first.session("golden", 1).precomp(MAXCIPH)
    assert (directory / "state" / "session.golden" / ".precomp").exists()
    fresh = party_cls(params, hub_cls(1).board(1), source_cls(b"unused"),
                      str(directory))
    fresh.keygen()  # reloads the cached key state
    fresh.session("golden", 1).mix(ciphs)
    return directory / "nizkp.golden"


def test_precomp_persists_into_a_fresh_party(tmp_path, port_precomp_mix):
    """precomp in one MixNetParty, mix from a fresh one on the same
    directory: the second reloads the `.precomp` state, takes the CCPoS
    chain and writes the bytes of the one-object run.  vmn_tpu restarts
    the session's source there, so its CCPoS blinders repeat bytes that
    the precomputation drew for its secrets and its transcript differs
    (ROADMAP queue 3, F10)."""
    from vmn_tpu.arith.pgroup import ModPGroup as JG
    from vmn_tpu.crypto.randomsource import SeededSource as JSeeded
    from vmn_tpu.eio.bytetree import lazy_from_bytes as j_lazy
    from vmn_tpu.protocol import elgamal as jelg
    from vmn_tpu.protocol.com.board import LocalBoardHub as JHub
    from vmn_tpu.protocol.mixnet.party import MixNetParty as JParty

    nizkp = _precomp_then_fresh_mix(tmp_path / "port", MixNetParty,
                                    LocalBoardHub, SeededSource,
                                    _golden_ciphs())
    assert (nizkp / "proofs" / "CCPoSCommitment01.bt").exists()
    assert not (nizkp / "proofs" / "PoSCommitment01.bt").exists()
    _same_files(nizkp, port_precomp_mix[0])
    assert FiatShamirVerifier(_params(), nizkp).verify(
        expected_type="mixing").ok

    j_ciphs = jelg.ciph_group(JG.named("test256"), 1).elem_from_bytetree(
        j_lazy((GOLDEN / "Ciphertexts.bt").read_bytes()), N)
    j_nizkp = _precomp_then_fresh_mix(tmp_path / "vmn_tpu", JParty, JHub,
                                      JSeeded, j_ciphs)
    rel = Path("proofs") / "CCPoSCommitment01.bt"
    assert (j_nizkp / rel).read_bytes() != (GOLDEN / rel).read_bytes()


def test_k3_precomp_mix_accepted_by_vmn_tpu(tmp_path):
    """tests/test_precomp_e2e.py's configuration in the port: k=3, t=2,
    N=6, maxciph 10; the parties agree, the multiset holds, and both
    verifiers accept party 1's transcript."""
    from vmn_tpu.arith.pgroup import ModPGroup as JG
    from vmn_tpu.protocol.context import ProtocolParams as JParams
    from vmn_tpu.protocol.mixnet.verifier import FiatShamirVerifier as JV

    k, t, n = 3, 2, 6
    params = _params(k, t, sid="TestSID")
    group = params.pgroup
    hub = LocalBoardHub(k)
    msgs = _msgs(group, n)

    def run(j):
        party = MixNetParty(params, hub.board(j),
                            SeededSource(f"party{j}".encode()),
                            str(tmp_path / f"Party{j:02d}"))
        return party, party.keygen()

    parties = run_parties(k, run)
    pk = parties[1][1]
    ciphs = elgamal.encrypt(pk, group.from_ints(msgs), group.ring.random(
        (n,), SeededSource(b"encr"), 0))
    hub2 = LocalBoardHub(k)

    def mix(j):
        party = parties[j][0]
        party.board = hub2.board(j)
        session = party.session("aux", 1)
        session.precomp(10)
        return session.mix(ciphs)

    outs = run_parties(k, mix)
    assert sorted(outs[1].to_ints()) == sorted(msgs)
    assert all(outs[j].equals(outs[1]) for j in (2, 3))
    nizkp = tmp_path / "Party01" / "nizkp.aux"
    assert (nizkp / "proofs" / "CCPoSCommitment02.bt").exists()
    assert FiatShamirVerifier(params, nizkp).verify(
        expected_type="mixing").ok
    jparams = JParams(sid="TestSID", k=k, threshold=t,
                      pgroup=JG.named("test256"))
    assert JV(jparams, nizkp).verify(expected_type="mixing").ok

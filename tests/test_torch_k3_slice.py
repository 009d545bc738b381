"""The port's multi-party mix path (k=3 mix-servers, threshold 2) end to
end on the CPU, the parties in threads over one `LocalBoardHub`.

The golden run uses the inputs of tools/make_golden.py for
tests/golden/nizkp_test256_k3_w2 (test256, k=3, t=2, width 2, n=5,
`SeededSource(f"golden-party{j}")`, `SeededSource(b"golden-ciphs")`):
the port must rewrite party 1's transcript and the verifier's test
vectors (test_vectors_k3w2.json) that `vmn_tpu` wrote, and `vmn_tpu`
must read the port's key directories.  Then a tampered proof of shuffle
aborts the mix and the cheater's deactivation lets it complete (the
port's copy of tests/test_adversarial.py's
test_live_tampered_pos_abort_then_deactivate), and one interactive mix
(challenges from jointly flipped coins) preserves the plaintexts.

Tolerance: exact equality of every byte, integer and test vector.
"""

import json
from pathlib import Path

import pytest

import torch_port_util  # noqa: F401 (torch thread count)
from torch_port_util import TV_NAMES, TamperBoard, golden_files, run_parties
from vmn_tpu_torch.arith.pgroup import ModPGroup, PPArray
from vmn_tpu_torch.crypto.randomsource import SeededSource
from vmn_tpu_torch.protocol import elgamal
from vmn_tpu_torch.protocol.com.board import LocalBoardHub
from vmn_tpu_torch.protocol.context import ProtocolParams
from vmn_tpu_torch.protocol.mixnet.party import MixNetParty, ProtocolError
from vmn_tpu_torch.protocol.mixnet.verifier import FiatShamirVerifier

GOLDEN = Path(__file__).parent / "golden"
K, T, WIDTH, N = 3, 2, 2, 5


def _group():
    return ModPGroup.named("test256", device="cpu")


def _messages(group):
    return [group.encode_message(f"{i:08d}".encode()) for i in range(N)]


def _keygen(params, hub, seed, root=None):
    """keygen of the k parties in threads; 1-based MixNetParty list."""
    def one(j):
        party = MixNetParty(params, hub.board(j), SeededSource(seed(j)),
                            str(root / f"P{j:02d}") if root else None)
        party.keygen()
        return party

    return run_parties(params.k, one)


@pytest.fixture(scope="module")
def k3_mix(tmp_path_factory):
    """The golden k=3, t=2, width-2 mix run by the port; returns (root of
    the party directories, messages, outputs of the 3 parties, test
    vectors of the port's verifier on party 1's transcript)."""
    root = tmp_path_factory.mktemp("port_k3")
    group = _group()
    params = ProtocolParams(sid="Golden", k=K, threshold=T, pgroup=group)
    parties = _keygen(params, LocalBoardHub(K),
                      lambda j: f"golden-party{j}".encode(), root)
    pk = parties[1].full_public_key()
    msgs = _messages(group)
    plain = elgamal.plain_group(group, WIDTH)
    m = PPArray(plain, (group.from_ints(msgs),) * WIDTH)
    r = plain.ring.random((N,), SeededSource(b"golden-ciphs"), 0)
    ciphs = elgamal.encrypt(pk.widen(WIDTH), m, r)
    hub = LocalBoardHub(K)

    def mix(j):
        parties[j].board = hub.board(j)
        return parties[j].session("golden", WIDTH).mix(ciphs)

    outs = run_parties(K, mix)
    nizkp = root / "P01" / "nizkp.golden"
    verifier = FiatShamirVerifier(params, nizkp, test_vectors=TV_NAMES)
    assert verifier.verify(expected_type="mixing").ok
    return root, msgs, outs, verifier.tv


def test_port_rewrites_k3_golden_transcript(k3_mix):
    root, _, _, _ = k3_mix
    nizkp = root / "P01" / "nizkp.golden"
    golden = GOLDEN / "nizkp_test256_k3_w2"
    assert golden_files(nizkp) == golden_files(golden)
    for rel in golden_files(golden):
        assert (nizkp / rel).read_bytes() == (golden / rel).read_bytes(), rel


def test_port_verifier_writes_k3_golden_test_vectors(k3_mix):
    _, _, _, tv = k3_mix
    want = json.loads((GOLDEN / "test_vectors_k3w2.json").read_text())
    assert tv == want


def test_k3_parties_agree_and_preserve_the_multiset(k3_mix):
    _, msgs, outs, _ = k3_mix
    assert outs[2].equals(outs[1]) and outs[3].equals(outs[1])
    for w in range(WIDTH):
        assert sorted(outs[1].project(w).to_ints()) == sorted(msgs)


def test_vmn_tpu_loads_port_k3_key_directories(k3_mix):
    """`vmn_tpu`'s MixNetParty.load_keys reads each party's
    state/KeyAndPoly.bt as the port wrote it, and both packages give the
    same joint key and the same share of each party."""
    from vmn_tpu.arith.pgroup import ModPGroup as JG
    from vmn_tpu.crypto.randomsource import SeededSource as JSeeded
    from vmn_tpu.protocol.com.board import LocalBoardHub as JHub
    from vmn_tpu.protocol.context import ProtocolParams as JParams
    from vmn_tpu.protocol.mixnet.party import MixNetParty as JParty

    root, _, _, _ = k3_mix
    jparams = JParams(sid="Golden", k=K, threshold=T,
                      pgroup=JG.named("test256"))
    params = ProtocolParams(sid="Golden", k=K, threshold=T, pgroup=_group())
    fpk = (GOLDEN / "nizkp_test256_k3_w2" / "FullPublicKey.bt").read_bytes()
    for j in range(1, K + 1):
        d = str(root / f"P{j:02d}")
        jp = JParty(jparams, JHub(K).board(j), JSeeded(b"unused"), d)
        p = MixNetParty(params, LocalBoardHub(K).board(j),
                        SeededSource(b"unused"), d)
        assert jp.load_keys() and p.load_keys()
        assert jp.full_public_key().to_bytetree().to_bytes() == fpk
        assert p.full_public_key().to_bytetree().to_bytes() == fpk
        assert jp.dkg.secret_share.to_int() == p.dkg.secret_share.to_int()
        assert jp.dkg.public_key_of(j).to_ints() == \
            p.dkg.public_key_of(j).to_ints()


def test_live_tampered_pos_abort_then_deactivate(tmp_path):
    """Party 2 (a shuffler) corrupts its PoS reply ON THE BOARD.  The
    chain runs exactly `threshold` shufflers, so honest parties see
    fewer than threshold valid proofs and abort (reference:
    ShufflerElGamalSession.java:344-349).  The operator then deactivates
    party 2 and re-runs: the chain extends past the cheater and the mix
    completes (party 3 computes its output beside its verification of
    party 1's proof, `_OptimisticOutput`) and verifies."""
    group = _group()
    params = ProtocolParams(sid="AdvPoS", k=K, threshold=T, pgroup=group)
    hub = LocalBoardHub(K)

    def flip(data):
        return data[:-1] + bytes([data[-1] ^ 1])

    boards = [None] + [hub.board(j) for j in range(1, K + 1)]
    boards[2] = TamperBoard(boards[2], lambda lab: lab == "PoSReply2", flip)
    parties = _keygen(params, hub, lambda j: f"party{j}".encode(),
                      tmp_path)
    msgs = _messages(group)
    pk = parties[1].full_public_key()
    ciphs = elgamal.encrypt(pk, group.from_ints(msgs),
                            group.ring.random((N,), SeededSource(b"encr"), 0))

    def shuffle(j):
        parties[j].board = boards[j]
        try:
            parties[j].session("adv", 1).shuffle(ciphs)
        except ProtocolError as e:
            return str(e)

    aborted = run_parties(K, shuffle)
    # Honest parties abort with too few valid proofs; the cheater,
    # trusting its own proof, does not.
    assert "too few valid proofs" in aborted[1]
    assert "too few valid proofs" in aborted[3]
    assert aborted[2] is None

    active = [False, True, False, True]

    def mix(j):
        parties[j].set_active(active)
        return parties[j].session("adv2", 1).mix(ciphs)

    outs = run_parties(K, mix, parties=[1, 3])
    assert sorted(outs[1].to_ints()) == sorted(msgs)
    assert outs[3].equals(outs[1])
    nizkp = tmp_path / "P01" / "nizkp.adv2"
    assert (nizkp / "proofs" / "activethreshold").read_text() == "3"
    assert not (nizkp / "proofs" / "PoSCommitment02.bt").exists()
    assert FiatShamirVerifier(params, nizkp).verify(
        expected_type="mixing").ok


def test_interactive_k3_mix_preserves_the_multiset():
    """noninteractive=False: every challenge of the mix (two proofs of
    shuffle, the decryption proof) is a jointly flipped coin; the three
    parties agree on the plaintexts, which are the messages."""
    group = _group()
    params = ProtocolParams(sid="Inter", k=K, threshold=T, pgroup=group,
                            noninteractive=False)
    parties = _keygen(params, LocalBoardHub(K),
                      lambda j: f"party{j}".encode())
    msgs = _messages(group)
    ciphs = elgamal.encrypt(parties[1].full_public_key(),
                            group.from_ints(msgs),
                            group.ring.random((N,), SeededSource(b"c"), 0))
    outs = run_parties(
        K, lambda j: parties[j].session("inter", 1).mix(ciphs))
    assert sorted(outs[1].to_ints()) == sorted(msgs)
    assert outs[2].equals(outs[1]) and outs[3].equals(outs[1])
    from vmn_tpu_torch.protocol.coinflip import ChallengerI

    assert isinstance(parties[1].session("x", 1).ctx.challenger, ChallengerI)

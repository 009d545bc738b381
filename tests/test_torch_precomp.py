"""The port's precomputation proofs against `vmn_tpu` on the CPU:
`Permutation.shrink`, the proof of a shuffle of commitments (PoSC), the
commitment-consistent proof of a shuffle (CCPoS, plain and raised
verification) and `PoSCMulti`, at test256 (mirroring
tests/test_hvzk.py).

Each input is made from a seed (`SeededSource`, a PRG seed or numpy)
and handed to both packages, and the commitment and reply bytes of the
two provers must be equal.  Everything compared is integer arithmetic or
bytes, so every tolerance in these tests is exact equality.
"""

import numpy as np
import pytest

import torch_port_util  # noqa: F401 (torch thread count)
from torch_port_util import run_parties
from vmn_tpu_torch.arith.pgroup import ModPGroup, Permutation
from vmn_tpu_torch.crypto.hash import SHA256
from vmn_tpu_torch.crypto.prg import PRGHeuristic
from vmn_tpu_torch.crypto.randomsource import SeededSource
from vmn_tpu_torch.eio.bytetree import ByteTree
from vmn_tpu_torch.protocol import elgamal
from vmn_tpu_torch.protocol.hvzk.ccpos_w import CCPoSProver, CCPoSVerifier
from vmn_tpu_torch.protocol.hvzk.pos_tw import PoSParams
from vmn_tpu_torch.protocol.hvzk.posc_tw import PoSCProver, PoSCVerifier

N = 16
SEED = b"\x01" * 32
V_INT = int.from_bytes(b"\x5a" * 16, "big")


@pytest.mark.parametrize("size", [1, 7, 64, 5000])
def test_permutation_shrink_matches_vmn_tpu(size):
    """The images < n in their relative order, at every n, on random
    tables (the one above 4096 is as long as a lexsort permutation)."""
    from vmn_tpu.arith.pgroup import Permutation as JPerm

    rng = np.random.default_rng(size)
    tbl = rng.permutation(size)
    for n in sorted({0, 1, size // 3, size - 1, size}):
        got = Permutation(tbl).shrink(n).tbl
        want = JPerm(tbl).shrink(n).tbl
        np.testing.assert_array_equal(got, want)
        assert sorted(got) == list(range(n))


# ------------------------------------------------------------- instances


def _port():
    """Port side: (group, seeded source, PoS parameters, h)."""
    grp = ModPGroup.named("test256", device="cpu")
    prg = PRGHeuristic(SHA256)
    prg.set_seed(b"\x02" * 32)
    h = grp.random_array(N, prg, 128)
    return (grp, SeededSource(b"hvzk-test"),
            PoSParams(128, 128, 128, PRGHeuristic(SHA256)), h)


def _jax():
    """The same instance in `vmn_tpu`."""
    from vmn_tpu.arith.pgroup import ModPGroup as JG
    from vmn_tpu.crypto.hash import Hashfunction
    from vmn_tpu.crypto.prg import PRGHeuristic as JPRG
    from vmn_tpu.crypto.randomsource import SeededSource as JSeeded
    from vmn_tpu.protocol.hvzk.pos_tw import PoSParams as JParams

    grp = JG.named("test256")
    prg = JPRG(Hashfunction("SHA-256"))
    prg.set_seed(b"\x02" * 32)
    h = grp.random_array(N, prg, 128)
    return (grp, JSeeded(b"hvzk-test"),
            JParams(128, 128, 128, JPRG(Hashfunction("SHA-256"))), h)


def _commitment(grp, rs, h, perm_cls):
    r = grp.ring.random((N,), rs, 128)
    pi = perm_cls.random(N, rs)
    return r, pi, h.mul(grp.g.exp(r)).permute(pi)


def _shuffle(grp, rs, pi, msg_seed, prg_cls, hash_arg, elg):
    """pk, its ciphertext-group form, w and the re-encrypted, permuted
    wp, with the re-encryption exponents s."""
    x = grp.ring.random((), rs, 0)
    pk = elg.ElGamalPublicKey(grp.g, grp.g.exp(x))
    prg = prg_cls(hash_arg)
    prg.set_seed(msg_seed)
    m = grp.random_array(N, prg, 128)
    w = elg.encrypt(pk, m, grp.ring.random((N,), rs, 0))
    s = grp.ring.random((N,), rs, 0)
    wp = w.mul(elg.reencryption_factors(pk.widen(1), s)).permute(pi.inv())
    return pk.widen(1).as_ciph_elem(), w, wp, s


def _posc_pair(bad_exponents=False):
    """The PoSC commitment and reply bytes of both packages, and the
    port's verifier set to the commitment."""
    from vmn_tpu.arith.pgroup import Permutation as JPerm
    from vmn_tpu.protocol.hvzk.posc_tw import PoSCProver as JProver

    out = []
    for (grp, rs, par, h), perm, prover in (
            (_port(), Permutation, PoSCProver), (_jax(), JPerm, JProver)):
        r, pi, u = _commitment(grp, rs, h, perm)
        if bad_exponents:  # the prover claims other exponents
            r = grp.ring.random((N,), rs, 128)
        P = prover(par, rs)
        P.set_instance(grp.g, h, u, r, pi)
        com = P.commit(SEED)
        out.append((com.to_bytes(), P.reply(V_INT).to_bytes()))
        if prover is PoSCProver:
            V = PoSCVerifier(par)
            V.set_instance(grp.g, h, u)
            V.set_batch_vector(SEED)
            V.set_commitment(com)
    return out[0], out[1], V


def test_posc_matches_vmn_tpu_and_round_trips():
    (com, reply), want, V = _posc_pair()
    assert (com, reply) == want
    assert V.verify(ByteTree.from_bytes(reply), V_INT)


def test_posc_rejects_tampered_reply():
    (_, reply), _, V = _posc_pair()
    assert not V.verify(ByteTree.from_bytes(reply), V_INT + 1)
    raw = bytearray(reply)
    raw[-3] ^= 0x01  # a byte of k_E
    assert not V.verify(ByteTree.from_bytes(bytes(raw)), V_INT)


def test_posc_rejects_wrong_commitment_exponents():
    (com, reply), want, V = _posc_pair(bad_exponents=True)
    assert (com, reply) == want
    assert not V.verify(ByteTree.from_bytes(reply), V_INT)


def _ccpos_pair(raised_exp_int=None):
    """CCPoS commitment and reply bytes of both packages, and the port's
    verifier with A and B (or the raised AB) computed and the
    commitment set."""
    from vmn_tpu.arith.pgroup import Permutation as JPerm
    from vmn_tpu.crypto.hash import Hashfunction
    from vmn_tpu.crypto.prg import PRGHeuristic as JPRG
    from vmn_tpu.protocol import elgamal as jelg
    from vmn_tpu.protocol.hvzk.ccpos_w import CCPoSProver as JProver

    out = []
    for (grp, rs, par, h), perm, prover, prg_cls, harg, elg in (
            (_port(), Permutation, CCPoSProver, PRGHeuristic, SHA256,
             elgamal),
            (_jax(), JPerm, JProver, JPRG, Hashfunction("SHA-256"), jelg)):
        r, pi, u = _commitment(grp, rs, h, perm)
        pk, w, wp, s = _shuffle(grp, rs, pi, b"\x04" * 32, prg_cls, harg,
                                elg)
        P = prover(par, rs)
        P.set_instance(grp.g, h, u, pk, w, wp, r, pi, s)
        com = P.commit(SEED)
        out.append((com.to_bytes(), P.reply(V_INT).to_bytes()))
        if prover is CCPoSProver:
            V = CCPoSVerifier(par)
            V.set_instance(grp.g, h, u, pk, w, wp)
            V.set_batch_vector(SEED)
            raised = {}
            if raised_exp_int is not None:
                rho = grp.ring.from_int(raised_exp_int)
                raised = {"raisedh": h.exp_bits(rho, 64),
                          "raised_exponent": rho}
                V.compute_AB(raisedu=u.exp_bits(rho, 64))
            else:
                V.compute_AB()
            V.set_commitment(com)
    return out[0], out[1], V, raised


def test_ccpos_matches_vmn_tpu_and_round_trips():
    (com, reply), want, V, _ = _ccpos_pair()
    assert (com, reply) == want
    bt = ByteTree.from_bytes(reply)
    assert V.verify(bt, V_INT)
    assert not V.verify(bt, V_INT - 1)


def test_ccpos_raised_round_trips_and_rejects_tampering():
    """Raised (precomputation) mode: the one folded equation accepts the
    valid reply, and rejects a wrong challenge and a flipped k_E byte."""
    (com, reply), want, V, raised = _ccpos_pair(raised_exp_int=12345)
    assert (com, reply) == want
    assert V.verify(ByteTree.from_bytes(reply), V_INT, **raised)
    assert not V.verify(ByteTree.from_bytes(reply), V_INT - 1, **raised)
    raw = bytearray(reply)
    raw[-3] ^= 0x01
    assert not V.verify(ByteTree.from_bytes(bytes(raw)), V_INT, **raised)


def _posc_multi_round(pkg: str, cheater):
    """One PoSCMulti round of k=3 parties (threads over one
    LocalBoardHub) in package `pkg`, each publishing its commitment
    first, as the precomputation does; party `cheater` proves with
    exponents other than its commitment's.  Returns (verdicts by party,
    every message on the board)."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    ModP = mod("arith.pgroup").ModPGroup
    Perm = mod("arith.pgroup").Permutation
    BT = mod("eio.bytetree").ByteTree
    context = mod("protocol.context")
    port = pkg == "vmn_tpu_torch"
    k, n = 3, 6
    grp = (ModP.named("test256", device="cpu") if port
           else ModP.named("test256"))
    params = context.ProtocolParams(sid="Multi", k=k, threshold=k,
                                    pgroup=grp)
    hub = mod("protocol.com.board").LocalBoardHub(k)

    def run(j):
        ctx = context.ProtocolContext(params)
        rs = mod("crypto.randomsource").SeededSource(f"mp{j}".encode())
        board = hub.board(j).scope("poscmulti")
        gens = ctx.independent_generators("gens", n)
        g = ctx.pgroup.g
        r = ctx.pgroup.ring.random((n,), rs, ctx.rbitlen)
        pi = Perm.random(n, rs)
        u = gens.mul(g.exp(r)).permute(pi)
        board.publish(f"U{j}", u.to_bytetree().to_bytes())
        us = {l: ctx.pgroup.elem_from_bytetree(BT.from_bytes(
            board.wait_for(l, f"U{l}")), n) if l != j else u
            for l in range(1, k + 1)}
        if j == cheater:
            r = ctx.pgroup.ring.random((n,), rs, ctx.rbitlen)
        par = mod("protocol.hvzk.pos_tw").PoSParams(
            ctx.vbitlen, ctx.ebitlen, ctx.rbitlen, ctx.prg)
        multi = mod("protocol.hvzk.posc_multi").PoSCMulti(ctx, board, rs,
                                                          par)
        return multi.execute(g, gens, us, r, pi)

    return run_parties(k, run), dict(hub._messages)


@pytest.mark.parametrize("cheater", [None, 2])
def test_posc_multi_round(cheater):
    """PoSCMulti: one round proving each party's commitment and
    verifying all the others' (reference: hvzk/PoSCMulti.java:40); a
    party that proves with exponents other than its commitment's is
    rejected by the others.  The port's verdicts and every message it
    puts on the board (commitments, MultiPoSCCommitment{l},
    MultiPoSCReply{l}) equal vmn_tpu's from the same seeds."""
    verdicts, board = _posc_multi_round("vmn_tpu_torch", cheater)
    want_verdicts, want_board = _posc_multi_round("vmn_tpu", cheater)
    k = 3
    for j in range(1, k + 1):
        assert verdicts[j] == {l: l == j or l != cheater
                               for l in range(1, k + 1)}, (j, verdicts[j])
    assert verdicts == want_verdicts
    assert sorted(board) == sorted(want_board)
    assert sum("MultiPoSCReply" in label for _, label in board) == k
    for key in want_board:
        assert board[key] == want_board[key], key

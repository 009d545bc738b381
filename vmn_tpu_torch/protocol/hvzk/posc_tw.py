"""Port of `vmn_tpu.protocol.hvzk.posc_tw`: the proof of a shuffle of
commitments (offline phase).

Rebuild of the reference PoSCBasicTW (reference: PoSCBasicTW.java:65):
the Terelius–Wikström machinery of `pos_tw` without the ciphertext part.
It proves that a permutation commitment u opens to a permutation of the
independent generators h, during precomputation
(reference: PermutationCommitment.java:251-366).

Transcript: commitment node(B, Ap, Bp, Cp, Dp); reply
node(k_A, k_B, k_C, k_D, k_E).  Seed data: node(g, h, u)
(reference: PoSCTW.java challengeData).
"""

from __future__ import annotations

from typing import Optional

from vmn_tpu_torch.arith.pgroup import GArray, Permutation
from vmn_tpu_torch.eio.bytetree import ByteTree, ByteTreeError, leaf, node
from vmn_tpu_torch.protocol.hvzk.pos_tw import (
    _BATCH_CHECK_BITS,
    PoSParams,
    _all_checks,
    _batch_vector,
    _batched_one_check,
    _local_rs,
    _random_bits_field,
)


class PoSCProver:
    """Prover: set_instance(g, h, u, r, pi) -> commit(seed) -> reply(v)."""

    def __init__(self, params: PoSParams, randomsource):
        self.par = params
        self.rs = randomsource

    def set_instance(self, g: GArray, h: GArray, u: GArray,
                     r, pi: Permutation):
        self.g = g
        self.h = h
        self.u = u
        self.r = r
        self.pi = pi
        self.size = h.size

    def commit(self, prg_seed: bytes) -> ByteTree:
        par = self.par
        ring = self.g.grp.ring
        n = self.size

        self.e = _batch_vector(ring, n, par.ebitlen, par.prg, prg_seed)
        self.ipe = self.e.permute(self.pi.inv())
        h0 = self.h.get(0)

        self.b = ring.random((n,), self.rs, par.rbitlen)
        x, self.d = self.b.rec_lin(self.ipe)
        y = self.ipe.prods()
        self.B = self.g.exp(x).mul(h0.exp(y))

        self.alpha = ring.random((), self.rs, par.rbitlen)
        ebl = par.ebitlen + par.vbitlen + par.rbitlen
        eps_bits = min(ebl, ring.nbits)
        self.epsilon = _random_bits_field(ring, n, ebl, self.rs)
        self.Ap = self.g.exp(self.alpha).mul(
            self.h.exp_prod(self.epsilon, eps_bits)
        )

        self.beta = ring.random((n,), self.rs, par.rbitlen)
        xp = x.shift_push(ring.zeros(()))
        yp = y.shift_push(ring.ones(()))
        del x, y  # only the shifted copies are live from here
        self.Bp = self.g.exp(self.beta.add(xp.mul(self.epsilon))).mul(
            h0.exp(yp.mul(self.epsilon))
        )
        del xp, yp

        self.gamma = ring.random((), self.rs, par.rbitlen)
        self.Cp = self.g.exp(self.gamma)
        self.delta = ring.random((), self.rs, par.rbitlen)
        self.Dp = self.g.exp(self.delta)

        return node(
            self.B.to_bytetree(),
            self.Ap.to_bytetree(),
            self.Bp.to_bytetree(),
            self.Cp.to_bytetree(),
            self.Dp.to_bytetree(),
        )

    def reply(self, v_int: int) -> ByteTree:
        ring = self.g.grp.ring
        v = ring.from_int(v_int)
        a = self.r.inner_product(self.ipe)
        c = self.r.sum()
        k_A = a.mul_add(v, self.alpha)
        k_B = self.b.mul_add(v, self.beta)
        k_C = c.mul_add(v, self.gamma)
        k_D = self.d.mul_add(v, self.delta)
        k_E = self.ipe.mul_add(v, self.epsilon)
        return node(
            k_A.to_bytetree(),
            k_B.to_bytetree(),
            k_C.to_bytetree(),
            k_D.to_bytetree(),
            k_E.to_bytetree(),
        )


class PoSCVerifier:
    """Verifier (reference: PoSCBasicTW verifier methods)."""

    def __init__(self, params: PoSParams):
        self.par = params

    def set_instance(self, g: GArray, h: GArray, u: GArray):
        self.g = g
        self.h = h
        self.u = u
        self.size = h.size

    def set_batch_vector(self, prg_seed: bytes):
        ring = self.g.grp.ring
        self.e = _batch_vector(
            ring, self.size, self.par.ebitlen, self.par.prg, prg_seed
        )

    def set_commitment(self, bt: Optional[ByteTree]) -> ByteTree:
        """Parse (B, Ap, Bp, Cp, Dp); malformed -> all ones."""
        grp = self.g.grp
        n = self.size
        try:
            if bt is None or bt.is_leaf or len(bt.children) != 5:
                raise ByteTreeError("malformed commitment")
            self.B = grp.elem_from_bytetree(bt[0], n)
            self.Ap = grp.elem_from_bytetree(bt[1])
            self.Bp = grp.elem_from_bytetree(bt[2], n)
            self.Cp = grp.elem_from_bytetree(bt[3])
            self.Dp = grp.elem_from_bytetree(bt[4])
        except (ByteTreeError, ValueError):
            self.B = grp.one((n,))
            self.Ap = grp.one()
            self.Bp = grp.one((n,))
            self.Cp = grp.one()
            self.Dp = grp.one()
        return node(
            self.B.to_bytetree(),
            self.Ap.to_bytetree(),
            self.Bp.to_bytetree(),
            self.Cp.to_bytetree(),
            self.Dp.to_bytetree(),
        )

    def verify(self, reply_bt: ByteTree, v_int: int) -> bool:
        """The four equations (A, the B rows, C, D) as one stacked
        multi-exponentiation against the identity, each row under a
        verifier-local 100-bit weight, the B rows folded with weights
        alpha_i (as `vmn_tpu`; docs/DEVIATIONS.md)."""
        grp = self.g.grp
        ring = grp.ring
        n = self.size
        try:
            if reply_bt.is_leaf or len(reply_bt.children) != 5:
                raise ByteTreeError("malformed reply")
            k_A = ring.from_bytetree(reply_bt[0])
            k_B = ring.from_bytetree(reply_bt[1], n)
            k_C = ring.from_bytetree(reply_bt[2])
            k_D = ring.from_bytetree(reply_bt[3])
            k_E = ring.from_bytetree(reply_bt[4], n)
        except (ByteTreeError, ValueError):
            return False

        v = ring.from_int(v_int)
        h0 = self.h.get(0)
        alpha = ring.random_bits(n, _BATCH_CHECK_BITS, _local_rs())
        bshift = self.B.shift_push(h0)
        A = self.u.exp_prod(self.e, self.par.ebitlen)
        E1 = self.h.exp_prod(k_E)
        P1 = self.B.exp_prod(alpha, _BATCH_CHECK_BITS)
        P2 = self.Bp.exp_prod(alpha, _BATCH_CHECK_BITS)
        E2 = bshift.exp_prod(k_E.mul(alpha))
        u_prod = self.u.prod()
        h_prod = self.h.prod()
        Bn1 = self.B.get(n - 1)
        e_prod = self.e.prod()
        one = ring.from_int(1)
        none = one.neg()
        return _all_checks([_batched_one_check(ring, [
            [(A, v), (self.Ap, one), (self.g, k_A.neg()), (E1, none)],
            [(P1, v), (P2, one),
             (self.g, k_B.inner_product(alpha).neg()), (E2, none)],
            [(u_prod, v), (h_prod, v.neg()), (self.Cp, one),
             (self.g, k_C.neg())],
            [(Bn1, v), (h0, e_prod.mul(v).neg()), (self.Dp, one),
             (self.g, k_D.neg())],
        ])])


def posc_seed_data(g, h, u) -> ByteTree:
    """Seed challenge data (reference: PoSCTW.java challengeData —
    node(g, h, u))."""
    return node(g.to_bytetree(), h.to_bytetree(), u.to_bytetree())


def posc_challenge_data(prg_seed: bytes, commitment_bt: ByteTree) -> ByteTree:
    return node(leaf(prg_seed), commitment_bt)

"""Port of `vmn_tpu.protocol.hvzk.ccpos_w`: the commitment-consistent
proof of a shuffle (online phase after precomputation).

Rebuild of the reference CCPoSBasicW (reference: CCPoSBasicW.java:65):
given a permutation commitment u, proved well formed by PoSC during the
offline phase, it proves that the published output list wp is the
committed permutation of the re-encrypted w.

Statement: knows (r, pi, s) with u_i = g^{r_{pi(i)}} h_{pi(i)} and
wp_i = w_{pi^{-1}(i)} Enc_pk(1, s_{pi^{-1}(i)}).

Transcript: commitment node(Ap, Bp); reply node(k_A, k_B, k_E)
(files CCPoSCommitment%02d.bt / CCPoSReply%02d.bt).
Verification equations (reference: CCPoSBasicW.verify:520-585):

    A^v Ap == g^{k_A} prod h_i^{k_E,i}             (A = prod u^e)
    B^v Bp == pk^{-k_B} prod wp_i^{k_E,i}          (B = prod w^e)

The reference's 50-bit raised-value verifier speed-up
(reference: CCPoS.java:75-96) is verifier-local (the secret exponent
never enters the transcript); `verify(..., raised_exponent=...)` folds
the A-equation into the ciphertext-side multi-exponentiation.
"""

from __future__ import annotations

from typing import Optional

from vmn_tpu_torch.arith.pgroup import Permutation, PPArray
from vmn_tpu_torch.eio.bytetree import ByteTree, ByteTreeError, leaf, node
from vmn_tpu_torch.protocol.hvzk.pos_tw import (
    PoSParams,
    _all_checks,
    _batch_vector,
    _batched_one_check,
    _ciph_group_of,
    _flat_farrays,
    _flat_garrays,
    _plain_ring,
    _random_bits_field,
)


class CCPoSProver:
    def __init__(self, params: PoSParams, randomsource):
        self.par = params
        self.rs = randomsource

    def set_instance(self, g, h, u, pkey, w, wp, r, pi: Permutation, s):
        self.g = g
        self.h = h
        self.u = u
        self.pkey = pkey
        self.w = w
        self.wp = wp
        self.r = r
        self.pi = pi
        self.s = s
        self.size = h.size

    def commit(self, prg_seed: bytes) -> ByteTree:
        par = self.par
        ring = self.g.grp.ring
        n = self.size

        self.e = _batch_vector(ring, n, par.ebitlen, par.prg, prg_seed)
        self.ipe = self.e.permute(self.pi.inv())

        self.alpha = ring.random((), self.rs, par.rbitlen)
        ebl = par.ebitlen + par.vbitlen + par.rbitlen
        eps_bits = min(ebl, ring.nbits)
        self.epsilon = _random_bits_field(ring, n, ebl, self.rs)
        self.Ap = self.g.exp(self.alpha).mul(
            self.h.exp_prod(self.epsilon, eps_bits)
        )

        self.beta = _plain_ring(self.pkey).random((), self.rs, par.rbitlen)
        self.Bp = self.pkey.exp(self.beta.neg()).mul(
            self.wp.exp_prod(self.epsilon, eps_bits)
        )
        return node(self.Ap.to_bytetree(), self.Bp.to_bytetree())

    def reply(self, v_int: int) -> ByteTree:
        ring = self.g.grp.ring
        v = ring.from_int(v_int)
        a = self.r.inner_product(self.ipe)
        b = self.s.inner_product(self.e)
        k_A = a.mul_add(v, self.alpha)
        k_B = b.mul_add(v, self.beta)
        k_E = self.ipe.mul_add(v, self.epsilon)
        return node(
            k_A.to_bytetree(), k_B.to_bytetree(), k_E.to_bytetree()
        )


class CCPoSVerifier:
    def __init__(self, params: PoSParams):
        self.par = params

    def set_instance(self, g, h, u, pkey, w, wp):
        self.g = g
        self.h = h
        self.u = u
        self.pkey = pkey
        self.w = w
        self.wp = wp
        self.size = h.size

    def set_batch_vector(self, prg_seed: bytes):
        ring = self.g.grp.ring
        self.e = _batch_vector(
            ring, self.size, self.par.ebitlen, self.par.prg, prg_seed
        )

    def compute_AB(self, raisedu=None):
        """A = prod u^e, B = prod w^e.  With precomputation the verifier
        holds u^rho (rho a secret 50-bit exponent drawn offline) and
        folds the A side into the ciphertext-side multi-exponentiation:
        AB = prod (w_c·u^rho)_i^{e_i} per component (reference:
        CCPoSBasicW.computeAB:490-505, CCPoS.java:75-96)."""
        if raisedu is None:
            self.A = self.u.exp_prod(self.e, self.par.ebitlen)
            self.B = self.w.exp_prod(self.e, self.par.ebitlen)
            self.AB = None
        else:
            self.AB = _mul_each(self.w, raisedu).exp_prod(
                self.e, self.par.ebitlen
            )

    def set_commitment(self, bt: Optional[ByteTree]) -> ByteTree:
        """Parse (Ap, Bp); malformed -> all ones."""
        grp = self.g.grp
        ciph = _ciph_group_of(self.pkey)
        try:
            if bt is None or bt.is_leaf or len(bt.children) != 2:
                raise ByteTreeError("malformed commitment")
            self.Ap = grp.elem_from_bytetree(bt[0])
            self.Bp = ciph.elem_from_bytetree(bt[1])
        except (ByteTreeError, ValueError):
            self.Ap = grp.one()
            self.Bp = ciph.one()
        return node(self.Ap.to_bytetree(), self.Bp.to_bytetree())

    def verify(self, reply_bt: ByteTree, v_int: int,
               raisedh=None, raised_exponent=None) -> bool:
        """Plain mode checks the A- and B-equations; raised mode
        (precomputation) checks the one folded equation

            AB^v (Bp·Ap^rho) == pkey^{-k_B} prod(wp·h^rho)^{k_E} g^{rho·k_A}

        per ciphertext component: the raised A-equation times the
        B-equation, sound because rho is secret and uniform.  Either way
        every single-element power rides one stacked multi-exponentiation
        against the identity (`_batched_one_check`)."""
        grp = self.g.grp
        ring = grp.ring
        n = self.size
        try:
            if reply_bt.is_leaf or len(reply_bt.children) != 3:
                raise ByteTreeError("malformed reply")
            k_A = ring.from_bytetree(reply_bt[0])
            k_B = _plain_ring(self.pkey).from_bytetree(reply_bt[1])
            k_E = ring.from_bytetree(reply_bt[2], n)
        except (ByteTreeError, ValueError):
            return False

        v = ring.from_int(v_int)
        one = ring.from_int(1)
        none = one.neg()
        if raised_exponent is not None and self.AB is not None:
            W = _mul_each(self.wp, raisedh).exp_prod(k_E)
            pk_f = _flat_garrays(self.pkey)
            kb_f = _flat_farrays(k_B)
            kb_f = kb_f * (len(pk_f) // len(kb_f))
            g_e = k_A.mul(raised_exponent).neg()
            rows = [
                [(ABc, v), (Bpc, one), (self.Ap, raised_exponent),
                 (pkc, kbc), (Wc, none), (self.g, g_e)]
                for ABc, Bpc, pkc, kbc, Wc in zip(
                    _flat_garrays(self.AB), _flat_garrays(self.Bp), pk_f,
                    kb_f, _flat_garrays(W),
                )
            ]
            return _all_checks([_batched_one_check(ring, rows)])

        E1 = self.h.exp_prod(k_E)
        E2 = self.wp.exp_prod(k_E)
        return _all_checks([_batched_one_check(ring, [
            [(self.A, v), (self.Ap, one), (self.g, k_A.neg()),
             (E1, none)],
            [(self.B, v), (self.Bp, one), (self.pkey, k_B), (E2, none)],
        ])])


def _mul_each(pp, x):
    """Multiply a base-group element or array into every leaf of a
    product-group array (the PPGroupElementArray.mul semantics of the
    raised fold, reference: CCPoSBasicW.java:502,572)."""
    if isinstance(pp, PPArray):
        return PPArray(
            pp.parent, tuple(_mul_each(c, x) for c in pp.components)
        )
    return pp.mul(x)


def ccpos_seed_data(g, h, u, pkey, w, wp) -> ByteTree:
    """Seed challenge data (reference: CCPoSW.java:186-192)."""
    return node(
        g.to_bytetree(),
        h.to_bytetree(),
        u.to_bytetree(),
        pkey.to_bytetree(),
        w.to_bytetree(),
        wp.to_bytetree(),
    )


def ccpos_challenge_data(prg_seed: bytes, commitment_bt: ByteTree
                         ) -> ByteTree:
    return node(leaf(prg_seed), commitment_bt)

"""Shamir secret sharing over the exponent ring — pure math, no I/O
(port of `vmn_tpu.protocol.secretsharing.shamir`).

Rebuild of the reference ShamirBasic (reference: ShamirBasic.java:47 —
polynomial evaluation and Lagrange recovery of a shared secret).
Polynomials are dealt in `pedersen.py`; this module recovers.

Shares are ring elements (FArray over Z_q, or PPFArray for widened
keys); indices are the 1-based party indices.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from vmn_tpu_torch.arith.pgroup import PField, PPFArray, PPRing


def lagrange_at_zero(q: int, idxs: Sequence[int]) -> List[int]:
    """Lagrange coefficients lambda_i for interpolation at x=0 over Z_q:
    P(0) = sum_i lambda_i P(i)."""
    out = []
    for i in idxs:
        num, den = 1, 1
        for l in idxs:
            if l != i:
                num = num * l % q
                den = den * (l - i) % q
        out.append(num * pow(den, -1, q) % q)
    return out


def shamir_recover(field, shares: Dict[int, object], threshold: int):
    """Recover P(0) from >= threshold verified shares {i: s_i}.

    `field` carries `.q` (or is a product ring); share values are
    FArray/PPFArray scalars supporting `.mul/.add` (reference:
    ShamirBasic.recover).
    """
    idxs = sorted(shares.keys())[:threshold]
    if len(idxs) < threshold:
        raise ValueError("too few shares to recover")
    acc = None
    for i, lam in zip(idxs, _lagrange_ring(field, idxs)):
        term = shares[i].mul(lam)
        acc = term if acc is None else acc.add(term)
    return acc


def _lagrange_ring(ring, idxs: Sequence[int]):
    """Lagrange coefficients as ring elements (componentwise for
    product rings)."""
    if isinstance(ring, PPRing):
        cols = [_lagrange_ring(f, idxs) for f in ring.factors]
        return [PPFArray(ring, tuple(col[i] for col in cols))
                for i in range(len(idxs))]
    assert isinstance(ring, PField)
    return [ring.from_int(v) for v in lagrange_at_zero(ring.q, idxs)]

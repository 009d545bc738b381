"""Port of `vmn_tpu.protocol.distr.dkg`: distributed key generation for
threshold El Gamal.

Rebuild of the reference DKG (reference: DKG.java:141-215): the first
`threshold` parties each deal a random secret through verifiable secret
sharing with a public commitment polynomial "in the exponent"; the
instances are collapsed (summed) into one joint key:

    joint secret      x    = sum_{l<=t} x_l          (never materialized)
    share of party i  x_i  = sum_{l<=t} P_l(i) = P(i),  deg P = t-1
    public polynomial g^P  = elementwise product of dealt polynomials
    joint public key  y    = g^P(0)

Shares travel over the bulletin board encrypted to the receiver's
CCA2 public key (reference: Pedersen.java dealSecret:355 encrypts with
the pkeys from PlainKeys).  The cipher is pluggable: the in-process
demo harness uses the identity cipher, the distributed runtime plugs
Naor–Yung (`vmn_tpu.crypto.naor_yung`, not ported yet).

Publishes per-party `PolynomialInExponent` byte trees and checks each
received share against the dealt polynomial (Feldman verification
g^{s_{l->i}} == prod_m c_{l,m}^{i^m}); a bad share raises (complaint
resolution — reference Pedersen.java:820-1122 — is handled at the
session layer).
"""

from __future__ import annotations

from typing import Optional

from vmn_tpu_torch.arith.pgroup import FArray, GArray
from vmn_tpu_torch.eio.bytetree import ByteTree
from vmn_tpu_torch.protocol.com.board import BulletinBoard


class DKGError(Exception):
    pass


class IdentityCipher:
    """Share 'encryption' for the local simulation harness."""

    def encrypt(self, to_party: int, data: bytes) -> bytes:
        return data

    def decrypt(self, data: bytes) -> bytes:
        return data


class DKGResult:
    def __init__(self, group, secret_share: FArray, poly_in_exp: GArray,
                 k: int):
        self.group = group
        self.secret_share = secret_share  # x_j = P(j)
        self.poly_in_exp = poly_in_exp  # (t, L) coefficients g^{c_m}
        self.k = k

    @property
    def threshold(self) -> int:
        return self.poly_in_exp.size

    @property
    def joint_public_key(self) -> GArray:
        """y = g^{P(0)} = first coefficient."""
        return self.poly_in_exp.get(0)

    def public_key_of(self, i: int) -> GArray:
        """y_i = g^{P(i)} = prod_m c_m^{i^m}
        (reference: PolynomialInExponent.evaluate)."""
        return evaluate_poly_in_exp(self.poly_in_exp, i)

    def poly_bytetree(self) -> ByteTree:
        """node(c_0, ..., c_{t-1})
        (reference: PolynomialInExponent.toByteTree:189-191)."""
        return self.poly_in_exp.to_bytetree()


def evaluate_poly_in_exp(coeffs: GArray, i: int) -> GArray:
    """prod_m c_m^{i^m} for scalar index i."""
    grp = coeffs.grp
    t = coeffs.size
    ring = grp.ring
    powers = []
    acc = 1
    for _ in range(t):
        powers.append(acc)
        acc = acc * i
    e = ring.from_ints(powers)
    return coeffs.exp_prod(e)


def run_dkg(
    ctx,
    board: BulletinBoard,
    randomsource,
    cipher: Optional[object] = None,
) -> DKGResult:
    """Run DKG as party `board.j` among `board.k` parties with threshold
    ctx.par.threshold: the first `threshold` parties deal a random
    secret through Pedersen VSS (with the complaint/accusation path of
    Pedersen.java:820), the instances are collapsed into one joint key
    (reference: DKG.generate:141-215)."""
    from vmn_tpu_torch.protocol.secretsharing.pedersen import (
        run_pedersen_sequential,
    )

    group = ctx.key_group()
    t = ctx.par.threshold
    seq = run_pedersen_sequential(
        ctx,
        board.scope("dkg"),
        randomsource,
        dealers=range(1, t + 1),
        cipher=cipher or IdentityCipher(),
        group=group,
        threshold=t,
    )
    return DKGResult(group, seq.share, seq.poly_in_exp, board.k)



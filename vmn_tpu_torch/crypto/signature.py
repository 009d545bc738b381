"""Port of `vmn_tpu.crypto.signature`: digital signatures for
bulletin-board authentication, on host integers.

The reference authenticates every bulletin-board message with the
signature keys from the info files (reference: SURVEY.md §2.4
protocol.com — SignatureKeyGen(Heuristic)/SignatureKeyPair; the scheme
is config-pluggable).  The scheme is Schnorr over a named safe-prime
group, with `vmn_tpu`'s domain string, key encodings and signature
bytes, so either package verifies the other's signatures:

    keygen:  x random in Z_q,  y = g^x
    sign:    k random, c = H(domain || y || g^k || m), s = k + c*x mod q
    verify:  c == H(domain || y || g^s * y^{-c} || m)

Every power is a Python `pow` (one to sign, two to verify): the group
is only (p, q, g), and no array of it is built on any device.
"""

from __future__ import annotations

from dataclasses import dataclass

from vmn_tpu_torch.crypto.hash import SHA256
from vmn_tpu_torch.eio.bytetree import ByteTree, leaf, node

_DOMAIN = b"vmn_tpu.schnorr.v1"


@dataclass(frozen=True)
class SchnorrGroup:
    """The order-q subgroup of Z_p^* for a safe prime p = 2q + 1."""

    p: int
    q: int
    g_int: int

    @staticmethod
    def named(name: str) -> "SchnorrGroup":
        from vmn_tpu_torch.arith.pgroup import _NAMED_GROUPS

        p, g = _NAMED_GROUPS[name]
        return SchnorrGroup(p, (p - 1) // 2, g)


class SignatureKeyPair:
    def __init__(self, group: SchnorrGroup, x: int, y: int):
        self.group = group
        self.x = x
        self.y = y

    @property
    def public(self) -> "SignaturePKey":
        return SignaturePKey(self.group, self.y)

    @staticmethod
    def generate(randomsource, group_name: str = "modp2048"
                 ) -> "SignatureKeyPair":
        group = SchnorrGroup.named(group_name)
        x = randomsource.random_int_mod(group.q)
        y = pow(group.g_int, x, group.p)
        return SignatureKeyPair(group, x, y)

    def sign(self, message: bytes, randomsource) -> bytes:
        group = self.group
        k = randomsource.random_int_mod(group.q)
        gk = pow(group.g_int, k, group.p)
        c = _challenge(group, self.y, gk, message)
        s = (k + c * self.x) % group.q
        qb = (group.q.bit_length() + 7) // 8
        return c.to_bytes(32, "big") + s.to_bytes(qb, "big")

    # ------------------------------------------------------- marshalling

    def to_bytetree(self) -> ByteTree:
        gl = group_len(self.group)
        return node(
            leaf(self.group.p.to_bytes(gl, "big")),
            leaf(self.x.to_bytes(gl, "big")),
            leaf(self.y.to_bytes(gl, "big")),
        )

    def to_hex(self) -> str:
        return self.to_bytetree().to_hex()

    @staticmethod
    def from_hex(hx: str) -> "SignatureKeyPair":
        bt = ByteTree.from_hex(hx)
        group = _group_of(bt[0].to_int_unsigned())
        return SignatureKeyPair(
            group, bt[1].to_int_unsigned(), bt[2].to_int_unsigned()
        )


class SignaturePKey:
    def __init__(self, group: SchnorrGroup, y: int):
        self.group = group
        self.y = y

    def verify(self, message: bytes, sig: bytes) -> bool:
        group = self.group
        qb = (group.q.bit_length() + 7) // 8
        if len(sig) != 32 + qb:
            return False
        c = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:], "big")
        if s >= group.q:
            return False
        # g^s * y^{-c} = g^k
        gk = (
            pow(group.g_int, s, group.p)
            * pow(self.y, -c % group.q, group.p)
        ) % group.p
        return c == _challenge(group, self.y, gk, message)

    def to_hex(self) -> str:
        gl = group_len(self.group)
        return node(
            leaf(self.group.p.to_bytes(gl, "big")),
            leaf(self.y.to_bytes(gl, "big")),
        ).to_hex()

    @staticmethod
    def from_hex(hx: str) -> "SignaturePKey":
        bt = ByteTree.from_hex(hx)
        return SignaturePKey(_group_of(bt[0].to_int_unsigned()),
                             bt[1].to_int_unsigned())


def _group_of(p: int) -> SchnorrGroup:
    """The group a key names by its prime; generator 4, as `vmn_tpu`."""
    return SchnorrGroup(p, (p - 1) // 2, 4)


def group_len(group: SchnorrGroup) -> int:
    return (group.p.bit_length() + 7) // 8


def _challenge(group, y: int, gk: int, message: bytes) -> int:
    gl = group_len(group)
    h = SHA256.hash(
        _DOMAIN
        + y.to_bytes(gl, "big")
        + gk.to_bytes(gl, "big")
        + message
    )
    return int.from_bytes(h, "big")

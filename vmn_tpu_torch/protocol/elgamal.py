"""Port of `vmn_tpu.protocol.elgamal`: El Gamal over product groups,
batched on the group's device.

Rebuilds the reference's group structure for keys/plaintexts/ciphertexts
(reference: ProtocolElGamal.java:738-776 — key group PPGroup(pGroup,
keyWidth), plaintext group PPGroup(pGroup, width), ciphertext group
PPGroup(plaintextGroup, 2)) and the encryption/decryption/re-encryption
equations used by the mix-net sessions.

Everything here is an array operation over the N axis: keygen is O(1)
but encryption/decryption/re-encryption of N ciphertexts are single
batched device computations.
"""

from __future__ import annotations


from vmn_tpu_torch.arith.pgroup import (
    FArray,
    ModPGroup,
    PPArray,
    PPGroup,
)
from vmn_tpu_torch.eio.bytetree import ByteTree, node


def plain_group(pgroup, width: int):
    """Plaintext group for a given width: PPGroup(pgroup, width), or the
    group itself for width 1 (reference: ProtocolElGamal.getPlainPGroup)."""
    if width == 1:
        return pgroup
    return PPGroup(pgroup, width)


def ciph_group(pgroup, width: int) -> PPGroup:
    """Ciphertext group PPGroup(plain, 2) (reference:
    ProtocolElGamal.getCiphPGroup)."""
    return PPGroup(plain_group(pgroup, width), 2)


def widen(elem, width: int):
    """Widen a key element of the base group to width w: x -> (x,..,x)
    (reference: ProtocolElGamal.getWidePublicKey key widening
    ProtocolElGamal.java:785-800)."""
    if width == 1:
        return elem
    if isinstance(elem, PPArray):
        # widen each component (keywidth groups)
        return PPArray(
            PPGroup(elem.parent, width), tuple([elem] * width)
        )
    pp = PPGroup(elem.grp, width)
    return PPArray(pp, tuple([elem] * width))


class ElGamalKeyPair:
    """Full key pair: public (g, y), secret x with y = g^x."""

    def __init__(self, pk: "ElGamalPublicKey", sk: FArray):
        self.pk = pk
        self.sk = sk


class ElGamalPublicKey:
    """Full public key (g, y) ∈ PPGroup(keygroup, 2)
    (reference: full public key byte tree = node(g, y),
    MixNetElGamalVerifyFiatShamirSession.readFullPKey:194-235)."""

    def __init__(self, g, y):
        self.g = g
        self.y = y

    @property
    def group(self):
        return self.g.grp

    def widen(self, width: int) -> "ElGamalPublicKey":
        return ElGamalPublicKey(widen(self.g, width), widen(self.y, width))

    def to_bytetree(self) -> ByteTree:
        return node(self.g.to_bytetree(), self.y.to_bytetree())

    @staticmethod
    def from_bytetree(group, bt: ByteTree) -> "ElGamalPublicKey":
        if bt.is_leaf or len(bt.children) != 2:
            raise ValueError("malformed public key")
        return ElGamalPublicKey(
            group.elem_from_bytetree(bt[0]),
            group.elem_from_bytetree(bt[1]),
        )

    def as_ciph_elem(self):
        """The key pair (g, y) viewed as an element of the ciphertext
        group PPGroup(keygroup, 2) — used as `pkey` by the proofs
        (reference: PoSBasicTW pkey is a PPGroupElement)."""
        grp = self.group
        pp = PPGroup(grp, 2)
        return PPArray(pp, (self.g, self.y))


def keygen(group: ModPGroup, randomsource, rbitlen: int = 0) -> ElGamalKeyPair:
    """Single-party key generation (trivial DKG for k=1): x random,
    y = g^x."""
    x = group.ring.random((), randomsource, rbitlen or 0)
    y = group.g.exp(x)
    return ElGamalKeyPair(ElGamalPublicKey(group.g, y), x)


def encrypt(
    pk: ElGamalPublicKey,
    m,
    r,
) -> PPArray:
    """Enc_pk(m, r) = (g^r, y^r m).

    m: plaintext array in plain group (GArray (N,L) or PPArray of width w)
    r: exponents — FArray (N,) for width 1 or PPFArray componentwise.
    Returns ciphertext PPArray ((u...),(v...)).
    """
    u = pk.g.exp(r)
    v = pk.y.exp(r).mul(m)
    return PPArray(PPGroup(m.grp, 2), (u, v))


def reencryption_factors(wide_pk: ElGamalPublicKey, r) -> PPArray:
    """Enc_pk(1, r) = (g^r, y^r) — the re-encryption factors
    (reference: ShufflerElGamalSession.java:407 widePublicKey.exp(r))."""
    u = wide_pk.g.exp(r)
    v = wide_pk.y.exp(r)
    return PPArray(PPGroup(u.grp, 2), (u, v))


def reencrypt(ciphs: PPArray, factors: PPArray) -> PPArray:
    """w' = w * Enc(1, r)."""
    return ciphs.mul(factors)


def decrypt(sk: FArray, ciphs: PPArray):
    """m = v * u^{-x}."""
    u = ciphs.project(0)
    v = ciphs.project(1)
    f = u.exp(sk.neg())
    return v.mul(f)


def decryption_factors(sk: FArray, ciphs: PPArray):
    """f = u^{-x} — published by each party in distributed decryption
    (reference: DistrElGamalSession.java:361-390)."""
    return ciphs.project(0).exp(sk.neg())

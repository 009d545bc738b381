"""Naor–Yung CCA2 public-key encryption of byte strings (port of
`vmn_tpu.crypto.naor_yung`; byte-identical ciphertexts from the same
random source).

Rebuild of the reference's CryptoKeyGenNaorYung cryptosystem used by
PlainKeys to protect secret shares in transit (reference: SURVEY.md
§2.4 crypto — Naor–Yung keys configured by the `keygen` info field;
PlainKeys.java:54).

Construction (double-generator El Gamal + Fiat–Shamir equality proof,
the standard Naor–Yung instantiation):

    keygen: z random;  pk = (g1, g2, y = g1^z)   (g2 derived by RO)
    enc(m): s random; (u1, u2, e) = (g1^s, g2^s, y^s·m)
            + FS proof (c, r): knows s with u1 = g1^s and u2 = g2^s
    dec:    check proof; m = e · u1^{-z}

Messages are arbitrary byte strings, chunked through the group's
message encoding.  Host-side integers — this protects k·k small
control-plane messages, not the data path.  The randomness is drawn in
the reference's order (per chunk: s, then the proof's k), so a seeded
source gives the same bytes as `vmn_tpu`.
"""

from __future__ import annotations

from vmn_tpu_torch.arith.pgroup import ModPGroup
from vmn_tpu_torch.crypto.hash import SHA256, Hashfunction
from vmn_tpu_torch.crypto.prg import PRGHeuristic
from vmn_tpu_torch.eio.bytetree import (
    ByteTree, ByteTreeError, node, signed_int_leaf,
)

_DOMAIN = b"vmn_tpu.naor-yung.v1"


class NaorYungError(Exception):
    pass


def _second_generator(group: ModPGroup, hf: Hashfunction) -> int:
    """Derive g2 with unknown discrete log via a PRG seeded from the
    group description."""
    prg = PRGHeuristic(hf)
    prg.set_seed(hf.hash(_DOMAIN + group.to_bytetree().to_bytes()))
    nbytes = (group.nbits + 16) // 8
    t = int.from_bytes(prg.read_bytes(nbytes), "big") % group.p
    return pow(t, group.coorder, group.p)


class NaorYungPKey:
    MARSHAL_NAME = "com.verificatum.crypto.CryptoPKeyNaorYung"

    def __init__(self, group: ModPGroup, g2: int, y: int,
                 hf: Hashfunction = SHA256):
        self.group = group
        self.g1 = group.g_int
        self.g2 = g2
        self.y = y
        self.hf = hf

    # ----------------------------------------------------------- encrypt

    def encrypt(self, message: bytes, randomsource) -> bytes:
        grp = self.group
        p, q = grp.p, grp.q
        mlen = grp.nbits // 8 - 4
        cts = []
        for i in range(0, max(len(message), 1), mlen):
            m = grp.encode_message(message[i : i + mlen])
            s = randomsource.random_int_mod(q)
            u1 = pow(self.g1, s, p)
            u2 = pow(self.g2, s, p)
            e = pow(self.y, s, p) * m % p
            # FS equality proof
            k = randomsource.random_int_mod(q)
            c = self._challenge(u1, u2, e, pow(self.g1, k, p),
                                pow(self.g2, k, p))
            r = (k + c * s) % q
            cts.append(node(*map(signed_int_leaf, (u1, u2, e, c, r))))
        return node(*cts).to_bytes()

    def _challenge(self, u1, u2, e, t1, t2) -> int:
        data = node(*map(signed_int_leaf, (
            self.g1, self.g2, self.y, u1, u2, e, t1, t2))).to_bytes()
        return int.from_bytes(self.hf.hash(_DOMAIN + data), "big")

    # --------------------------------------------------------- marshal

    def to_bytetree(self) -> ByteTree:
        return node(self.group.to_bytetree(), signed_int_leaf(self.g2),
                    signed_int_leaf(self.y))

    @classmethod
    def from_bytetree(cls, bt: ByteTree, device="cuda") -> "NaorYungPKey":
        group = ModPGroup.from_bytetree(bt[0], device=device)
        return cls(group, bt[1].to_int_signed(), bt[2].to_int_signed())


class NaorYungKeyPair:
    def __init__(self, pkey: NaorYungPKey, z: int):
        self.pkey = pkey
        self.z = z

    @staticmethod
    def generate(randomsource, group: ModPGroup = None,
                 hf: Hashfunction = SHA256) -> "NaorYungKeyPair":
        group = group or ModPGroup.named("modp2048")
        g2 = _second_generator(group, hf)
        z = randomsource.random_int_mod(group.q)
        y = pow(group.g_int, z, group.p)
        return NaorYungKeyPair(NaorYungPKey(group, g2, y, hf), z)

    def decrypt(self, blob: bytes) -> bytes:
        pk = self.pkey
        grp = pk.group
        p, q = grp.p, grp.q
        try:
            bt = ByteTree.from_bytes(blob)
        except ByteTreeError as e:
            raise NaorYungError(f"malformed ciphertext: {e}")
        if bt.is_leaf:
            raise NaorYungError("malformed ciphertext")
        out = []
        for ct in bt.children:
            if ct.is_leaf or len(ct.children) != 5:
                raise NaorYungError("malformed ciphertext chunk")
            u1, u2, e, c, r = (ct[i].to_int_signed() for i in range(5))
            # verify equality proof: t_i = g_i^r / u_i^c
            t1 = pow(pk.g1, r, p) * pow(u1, -c % q, p) % p
            t2 = pow(pk.g2, r, p) * pow(u2, -c % q, p) % p
            if c != pk._challenge(u1, u2, e, t1, t2):
                raise NaorYungError("invalid ciphertext proof")
            out.append(grp.decode_message(e * pow(u1, -self.z % q, p) % p))
        return b"".join(out)

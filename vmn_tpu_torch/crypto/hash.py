"""Port of `vmn_tpu.crypto.hash` (a host-only copy; byte-identical behaviour).

Hash functions used for Fiat–Shamir random oracles and PRGs.

Mirrors the surface of VCR's Hashfunction/HashfunctionHeuristic
(reference: ProtocolElGamal.java:413-434 instantiates by name "SHA-256",
"SHA-384", "SHA-512").  Host-side only: hashing happens over byte-tree
serializations, never on device.
"""

from __future__ import annotations

import hashlib


class Hashfunction:
    """A named cryptographic hash function (reference:
    com.verificatum.crypto.HashfunctionHeuristic)."""

    MARSHAL_NAME = "com.verificatum.crypto.HashfunctionHeuristic"

    def __init__(self, name: str):
        if name not in ("SHA-256", "SHA-384", "SHA-512"):
            raise ValueError(f"unsupported hash function: {name}")
        self.name = name
        self._algo = name.replace("-", "").lower()
        self.output_bytes = {"SHA-256": 32, "SHA-384": 48, "SHA-512": 64}[name]
        self.output_bits = 8 * self.output_bytes

    def hash(self, data: bytes) -> bytes:
        return hashlib.new(self._algo, data).digest()

    def digest(self):
        """Incremental digest object (Hashdigest equivalent)."""
        return hashlib.new(self._algo)

    def to_bytetree(self):
        from vmn_tpu_torch.eio.bytetree import string_leaf

        return string_leaf(self.name)

    @classmethod
    def from_bytetree(cls, bt, device="cuda") -> "Hashfunction":
        """`device` is unused: a hash function holds no arrays."""
        return cls(bt.to_string())

    def __repr__(self):
        return f"Hashfunction({self.name})"

    def __eq__(self, other):
        return isinstance(other, Hashfunction) and self.name == other.name


from vmn_tpu_torch.eio.marshal import register as _register  # noqa: E402

_register(Hashfunction.MARSHAL_NAME)(Hashfunction)

SHA256 = Hashfunction("SHA-256")
SHA384 = Hashfunction("SHA-384")
SHA512 = Hashfunction("SHA-512")


def by_name(name: str) -> Hashfunction:
    return Hashfunction(name)

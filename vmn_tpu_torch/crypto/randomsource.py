"""Port of `vmn_tpu.crypto.randomsource`: sources of (true or seeded)
randomness for provers.

`DeviceSource` is not ported: its device PRF squeezes the 256-bit seed
into a 64-bit key (ROADMAP fault F1).  All prover randomness of the port
comes from the host SHA-256 PRG of these sources.

Mirrors VCR's RandomSource/RandomDevice.  Prover-side randomness (blinders,
permutation, re-encryption exponents) comes from here; *verifier-side*
randomness is always derived deterministically via the random oracle, so
only provers consume this module.
"""

from __future__ import annotations

import os

from vmn_tpu_torch.crypto.prg import PRGHeuristic
from vmn_tpu_torch.crypto.hash import SHA256


class RandomSource:
    def read_bytes(self, n: int) -> bytes:
        raise NotImplementedError

    def random_int(self, nbits: int) -> int:
        """Uniform integer in [0, 2^nbits)."""
        nbytes = (nbits + 7) // 8
        raw = bytearray(self.read_bytes(nbytes))
        extra = 8 * nbytes - nbits
        if extra:
            raw[0] &= 0xFF >> extra
        return int.from_bytes(raw, "big")

    def random_int_mod(self, modulus: int) -> int:
        """Uniform integer in [0, modulus) by rejection sampling."""
        nbits = modulus.bit_length()
        while True:
            x = self.random_int(nbits)
            if x < modulus:
                return x


class RandomDevice(RandomSource):
    """OS entropy (reference: com.verificatum.crypto.RandomDevice)."""

    MARSHAL_NAME = "com.verificatum.crypto.RandomDevice"

    def read_bytes(self, n: int) -> bytes:
        return os.urandom(n)

    def to_bytetree(self):
        from vmn_tpu_torch.eio.bytetree import string_leaf

        return string_leaf("/dev/urandom")

    @classmethod
    def from_bytetree(cls, bt) -> "RandomDevice":
        return cls()


class SeededSource(RandomSource):
    """Deterministic source for tests and reproducible demos."""

    def __init__(self, seed: bytes):
        self._prg = PRGHeuristic(SHA256)
        self._prg.set_seed(SHA256.hash(seed))

    def read_bytes(self, n: int) -> bytes:
        return self._prg.read_bytes(n)


from vmn_tpu_torch.eio.marshal import register as _register  # noqa: E402

_register(RandomDevice.MARSHAL_NAME)(RandomDevice)

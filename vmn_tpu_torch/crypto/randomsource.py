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

import hashlib
import os
from pathlib import Path

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
    def from_bytetree(cls, bt, device="cuda") -> "RandomDevice":
        """`device` is unused: the source holds no arrays."""
        return cls()


class SeededSource(RandomSource):
    """Deterministic source for tests, reproducible demos and a
    session's persisted randomness; `position` counts the bytes read."""

    def __init__(self, seed: bytes):
        self._prg = PRGHeuristic(SHA256)
        self._prg.set_seed(SHA256.hash(seed))
        self.position = 0

    def read_bytes(self, n: int) -> bytes:
        self.position += n
        return self._prg.read_bytes(n)


def take_seed_file(path) -> bytes:
    """The seed in a seed file, which is replaced by its successor before
    the caller draws anything (the reference's seed-file semantics, as
    `PRGRandomSource` follows them), so that no two runs on the file
    read the same stream.  The successor is SHA-256 over a tag of its own
    and the seed, not bytes of the stream the caller reads; it goes to a
    temporary file that is then renamed over the seed file."""
    path = Path(path)
    seed = path.read_bytes()
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_bytes(hashlib.sha256(b"vmn-seed-next" + seed).digest())
    os.replace(tmp, path)
    return seed


from vmn_tpu_torch.eio.marshal import register as _register  # noqa: E402

_register(RandomDevice.MARSHAL_NAME)(RandomDevice)

"""Port of `vmn_tpu.crypto.ro` (a host-only copy; byte-identical behaviour).

Random oracle construction for Fiat–Shamir challenges.

Matches VCR's com.verificatum.crypto.RandomOracle as documented in the
public Verificatum verifier specification:

    RO_{H, nbits}(d):
        s   = H( be32(nbits) || d )
        out = first ceil(nbits/8) bytes of PRG_H(s)
        zero the (8*ceil(nbits/8) - nbits) most significant bits of out[0]

Used by the non-interactive challenger (reference: ChallengerRO.java:96-116:
digest of globalPrefix || bytetree-data through a RandomOracle of the
challenge bit length) and for deriving independent generators
(reference: IndependentGeneratorsRO.java:110-130).
"""

from __future__ import annotations

import struct

from vmn_tpu_torch.crypto.hash import Hashfunction
from vmn_tpu_torch.crypto.prg import PRGHeuristic


class RandomOracle:
    """Fixed-output-length random oracle built from a hash function."""

    def __init__(self, hashfunction: Hashfunction, nbits: int):
        if nbits <= 0:
            raise ValueError("output bit length must be positive")
        self.hashfunction = hashfunction
        self.nbits = nbits

    def digest(self):
        """Incremental interface mirroring RandomOracle.getDigest()."""
        return _RODigest(self)

    def hash(self, data: bytes) -> bytes:
        d = self.digest()
        d.update(data)
        return d.finalize()


class _RODigest:
    def __init__(self, ro: RandomOracle):
        self._ro = ro
        self._inner = ro.hashfunction.digest()
        self._inner.update(struct.pack(">i", ro.nbits))

    def update(self, data: bytes) -> None:
        self._inner.update(data)

    def finalize(self) -> bytes:
        seed = self._inner.digest()
        prg = PRGHeuristic(self._ro.hashfunction)
        prg.set_seed(seed)
        nbytes = (self._ro.nbits + 7) // 8
        out = bytearray(prg.read_bytes(nbytes))
        extra = 8 * nbytes - self._ro.nbits
        if extra:
            out[0] &= 0xFF >> extra
        return bytes(out)

"""Port of `vmn_tpu.crypto.prg` (a host-only copy; byte-identical behaviour).

Pseudo-random generators.

PRGHeuristic matches the construction of VCR's
com.verificatum.crypto.PRGHeuristic as documented in the public Verificatum
verifier specification: with hash function H and a seed of exactly
len(H-output) bytes, the output stream is

    H(seed || be32(0)) || H(seed || be32(1)) || H(seed || be32(2)) || ...

It is used to expand Fiat–Shamir seeds into batching vectors and
independent generators (reference: PoSBasicTW.java:533-538 via
LargeIntegerArray.random; IndependentGeneratorsRO.java:117-129).

The *derivation of integers/group elements from the stream* lives with the
consumers (arith layer), this module only produces the byte stream.
"""

from __future__ import annotations

import struct

from vmn_tpu_torch.crypto.hash import Hashfunction


class PRG:
    """Abstract PRG surface: seed with bytes, then read bytes."""

    def set_seed(self, seed: bytes) -> None:
        raise NotImplementedError

    def read_bytes(self, n: int) -> bytes:
        raise NotImplementedError

    @property
    def min_seed_bytes(self) -> int:
        raise NotImplementedError


class PRGHeuristic(PRG):
    """Hash-function-based heuristic PRG (counter mode)."""

    MARSHAL_NAME = "com.verificatum.crypto.PRGHeuristic"

    def __init__(self, hashfunction: Hashfunction):
        self.hashfunction = hashfunction
        self._seed: bytes | None = None
        self._counter = 0
        self._buffer = b""

    @property
    def min_seed_bytes(self) -> int:
        return self.hashfunction.output_bytes

    def set_seed(self, seed: bytes) -> None:
        if len(seed) < self.min_seed_bytes:
            raise ValueError(
                f"seed too short: {len(seed)} < {self.min_seed_bytes}"
            )
        # The reference consumes exactly the minimum number of seed bytes.
        self._seed = bytes(seed[: self.min_seed_bytes])
        self._counter = 0
        self._buffer = b""

    def unread(self, data: bytes) -> None:
        """Push unconsumed bytes back onto the stream head.

        Used by batched consumers (EC point derivation) that read
        candidates speculatively: pushing the unused tail back keeps
        the stream position exactly where the sequential reference
        derivation would leave it, so later draws from the same PRG
        (e.g. the next factor of a product group) match."""
        self._buffer = bytes(data) + self._buffer

    def read_bytes(self, n: int) -> bytes:
        if self._seed is None:
            raise ValueError("PRG not seeded")
        need = n - len(self._buffer)
        blocksize = self.hashfunction.output_bytes
        if (
            need > 64 * blocksize
            and self.hashfunction.name == "SHA-256"
        ):
            # Native counter-mode expansion: large-N batching vectors
            # and prover randomness need 10^5-10^6 blocks per draw; the
            # per-block Python loop costs microseconds each.
            data = self._buffer + self._expand_native(
                (need + blocksize - 1) // blocksize
            )
            self._buffer = data[n:]
            return data[:n]
        chunks = [self._buffer]
        have = len(self._buffer)
        while have < n:
            block = self.hashfunction.hash(
                self._seed + struct.pack(">i", self._counter)
            )
            self._counter += 1
            chunks.append(block)
            have += len(block)
        data = b"".join(chunks)
        self._buffer = data[n:]
        return data[:n]

    def _expand_native(self, nblocks: int) -> bytes:
        import ctypes

        from vmn_tpu_torch.native.build import get_lib

        lib = get_lib()
        if lib is None:
            # toolchain-free fallback: plain Python loop
            out = []
            for _ in range(nblocks):
                out.append(self.hashfunction.hash(
                    self._seed + struct.pack(">i", self._counter)
                ))
                self._counter += 1
            return b"".join(out)
        buf = ctypes.create_string_buffer(32 * nblocks)
        lib.prg_expand_sha256(
            self._seed, len(self._seed), self._counter, nblocks, buf
        )
        self._counter += nblocks
        return buf.raw

    def to_bytetree(self):
        from vmn_tpu_torch.eio.marshal import marshal

        return marshal(self.hashfunction)

    @classmethod
    def from_bytetree(cls, bt) -> "PRGHeuristic":
        from vmn_tpu_torch.eio.marshal import unmarshal

        return cls(unmarshal(bt))

    def __repr__(self):
        return f"PRGHeuristic({self.hashfunction.name})"


from vmn_tpu_torch.eio.marshal import register as _register  # noqa: E402

_register(PRGHeuristic.MARSHAL_NAME)(PRGHeuristic)

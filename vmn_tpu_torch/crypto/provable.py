"""Port of `vmn_tpu.crypto.provable`: the provably secure primitives, on
host integers, with `vmn_tpu`'s byte formats and draws.

A group these primitives hold (or unmarshal) is built on the `device`
the caller names; only its (p, q, g) and its marshalled form are used.

Provably secure crypto primitives.

Function-equivalents of VCR's provable alternatives to the heuristic
SHA-2 stack, selectable through the same config surface as the
reference's check matrix (reference: demo/mixnet/.checkbaseconf
`provablehash`, `provableprg`, `provablerandsrc` configurations;
info-file fields documented in demo/mixnet/info_files:125-142):

* ``HashfunctionPedersen`` — fixed-input-length collision-resistant
  hash based on Pedersen commitments over a prime-order group:
  ``H(e_1..e_w) = prod h_i^{e_i}`` where the generators ``h_i`` are
  derived verifiably from a public seed.  Collisions yield discrete
  logarithms.
* ``HashfunctionMerkleDamgaard`` — arbitrary-input-length hash from a
  fixed-length one via the Merkle–Damgård construction with
  length-strengthening padding.
* ``PRGElGamal`` — pseudo-random generator whose security reduces to
  DDH: ``width`` parallel group states ``s_i`` updated as
  ``s_i <- s_i^x`` with the low ``qbits - statdist`` bits of each
  canonical residue emitted per round (Blum–Micali style with many
  output bits).
* ``PRGRandomSource`` — a RandomSource backed by any PRG and a seed
  file that is cryptographically replaced on every use, the
  reference's seed-file randomness source (reference: README.md:73-99,
  seed handling in privInfo `rand`/`seed` fields).

The upstream VCR sources are not mounted, so these are *functional*
(not bit-exact) equivalents; their own byte-tree marshal formats are
stable within this framework and registered under distinct interop
names.
"""

from __future__ import annotations

import hashlib
import struct
from pathlib import Path

from vmn_tpu_torch.arith.pgroup import ModPGroup
from vmn_tpu_torch.crypto.hash import Hashfunction
from vmn_tpu_torch.crypto.prg import PRG, PRGHeuristic
from vmn_tpu_torch.eio.bytetree import ByteTree, int_leaf, leaf, node
from vmn_tpu_torch.eio.marshal import register


class _AccumulatingDigest:
    """Incremental digest surface (update/finalize) for hashes that
    need the whole message at once."""

    def __init__(self, hf):
        self._hf = hf
        self._chunks = []

    def update(self, data: bytes) -> None:
        self._chunks.append(bytes(data))

    def digest(self) -> bytes:
        return self._hf.hash(b"".join(self._chunks))


def _derive_generators(group: ModPGroup, width: int, seed: bytes):
    """Verifiably derive `width` independent generators from a seed
    (same recipe as random-oracle generator derivation: PRG stream ->
    rbitlen-padded exponents; reference analogue:
    IndependentGeneratorsRO.java:110-131)."""
    prg = PRGHeuristic(Hashfunction("SHA-256"))
    prg.set_seed(hashlib.sha256(b"pedersen-generators" + seed).digest())
    ebytes = (group.q.bit_length() + 7) // 8 + 8
    gens = []
    for _ in range(width):
        e = int.from_bytes(prg.read_bytes(ebytes), "big") % group.q
        gens.append(pow(group.g_int, e, group.p))
    return gens


@register("com.verificatum.crypto.HashfunctionPedersen")
class HashfunctionPedersen:
    """Fixed-length provable hash ``prod h_i^{e_i}`` over a ModP group.

    Input length is fixed at ``width * floor((qbits - 1) / 8)`` bytes
    (each block parses to an exponent strictly below q); output is the
    fixed-size big-endian encoding of the resulting group element.
    """

    def __init__(self, group: ModPGroup, width: int = 2,
                 seed: bytes = b"vmn-tpu"):
        if width < 1:
            raise ValueError("width must be >= 1")
        self.group = group
        self.width = width
        self.seed = bytes(seed)
        self.generators = _derive_generators(group, width, self.seed)
        self.block_bytes = (group.q.bit_length() - 1) // 8
        self.input_bytes = width * self.block_bytes
        self.output_bytes = (group.p.bit_length() + 7) // 8
        self.output_bits = 8 * self.output_bytes
        self.name = f"Pedersen({group.p.bit_length()},{width})"

    def hash(self, data: bytes) -> bytes:
        if len(data) != self.input_bytes:
            raise ValueError(
                f"fixed-length hash: need {self.input_bytes} bytes, "
                f"got {len(data)}"
            )
        acc = 1
        for i in range(self.width):
            e = int.from_bytes(
                data[i * self.block_bytes:(i + 1) * self.block_bytes], "big"
            )
            acc = (acc * pow(self.generators[i], e, self.group.p)) \
                % self.group.p
        return acc.to_bytes(self.output_bytes, "big")

    def digest(self):
        return _AccumulatingDigest(self)

    # ------------------------------------------------------------ marshal

    def to_bytetree(self) -> ByteTree:
        return node(self.group.to_bytetree(), int_leaf(self.width),
                    leaf(self.seed))

    @classmethod
    def from_bytetree(cls, bt: ByteTree, device="cuda"
                      ) -> "HashfunctionPedersen":
        group = ModPGroup.from_bytetree(bt[0], device=device)
        return cls(group, bt[1].to_u32(), bt[2].data)

    def __eq__(self, other):
        return (isinstance(other, HashfunctionPedersen)
                and self.group == other.group and self.width == other.width
                and self.seed == other.seed)

    def __repr__(self):
        return f"HashfunctionPedersen({self.name})"


@register("com.verificatum.crypto.HashfunctionMerkleDamgaard")
class HashfunctionMerkleDamgaard:
    """Arbitrary-length hash from a fixed-length one (Merkle–Damgård
    with length strengthening)."""

    def __init__(self, inner):
        if inner.input_bytes <= inner.output_bytes:
            raise ValueError("inner hash must compress")
        self.inner = inner
        self.block_bytes = inner.input_bytes - inner.output_bytes
        self.output_bytes = inner.output_bytes
        self.output_bits = 8 * self.output_bytes
        self.name = f"MerkleDamgaard({inner.name})"

    def hash(self, data: bytes) -> bytes:
        bb = self.block_bytes
        # Length-strengthening pad: 0x80, zeros, 8-byte big-endian length.
        padlen = (-(len(data) + 9)) % bb
        padded = data + b"\x80" + b"\x00" * padlen + struct.pack(
            ">Q", len(data))
        state = b"\x00" * self.output_bytes
        for off in range(0, len(padded), bb):
            state = self.inner.hash(state + padded[off:off + bb])
        return state

    def digest(self):
        return _AccumulatingDigest(self)

    def to_bytetree(self) -> ByteTree:
        from vmn_tpu_torch.eio.marshal import marshal

        return marshal(self.inner)

    @classmethod
    def from_bytetree(cls, bt: ByteTree, device="cuda"
                      ) -> "HashfunctionMerkleDamgaard":
        from vmn_tpu_torch.eio.marshal import unmarshal

        return cls(unmarshal(bt, device))

    def __eq__(self, other):
        return (isinstance(other, HashfunctionMerkleDamgaard)
                and self.inner == other.inner)

    def __repr__(self):
        return f"HashfunctionMerkleDamgaard({self.inner!r})"


@register("com.verificatum.crypto.PRGElGamal")
class PRGElGamal(PRG):
    """DDH-based provable PRG with `width` parallel group states."""

    def __init__(self, group: ModPGroup, width: int = 4,
                 statdist: int = 100):
        if width < 1:
            raise ValueError("width must be >= 1")
        self.group = group
        self.width = width
        self.statdist = statdist
        self.out_bits = group.q.bit_length() - statdist
        if self.out_bits < 8:
            raise ValueError("group too small for statdist")
        self._ebytes = (group.q.bit_length() + 7) // 8
        self._pbytes = (group.p.bit_length() + 7) // 8
        self._x = None
        self._states = None
        self._buffer = b""
        self._bitbuf = 0
        self._bitcnt = 0

    @property
    def min_seed_bytes(self) -> int:
        return self._ebytes + self.width * self._pbytes

    def set_seed(self, seed: bytes) -> None:
        if len(seed) < self.min_seed_bytes:
            raise ValueError(
                f"seed too short: {len(seed)} < {self.min_seed_bytes}")
        p, q = self.group.p, self.group.q
        self._x = 2 + int.from_bytes(seed[: self._ebytes], "big") % (q - 2)
        self._states = []
        off = self._ebytes
        for i in range(self.width):
            raw = int.from_bytes(seed[off:off + self._pbytes], "big")
            off += self._pbytes
            # Map into the order-q subgroup (square into QR for safe
            # primes / raise by cofactor in general).
            s = pow(raw % p, (p - 1) // q, p)
            if s in (0, 1):
                s = pow(self.group.g_int, raw % q + 1, p)
            self._states.append(s)
        self._buffer = b""
        self._bitbuf = 0
        self._bitcnt = 0

    def unread(self, data: bytes) -> None:
        """Push unconsumed bytes back onto the stream head (same
        contract as PRGHeuristic.unread; used by batched EC point
        derivation)."""
        self._buffer = bytes(data) + self._buffer

    def read_bytes(self, n: int) -> bytes:
        if self._x is None:
            raise ValueError("PRG not seeded")
        out = bytearray(self._buffer)
        mask = (1 << self.out_bits) - 1
        while len(out) < n:
            for i in range(self.width):
                self._states[i] = pow(self._states[i], self._x, self.group.p)
                self._bitbuf = (self._bitbuf << self.out_bits) | (
                    self._states[i] & mask)
                self._bitcnt += self.out_bits
            nbytes = self._bitcnt // 8
            rem = self._bitcnt - 8 * nbytes
            out += (self._bitbuf >> rem).to_bytes(nbytes, "big")
            self._bitbuf &= (1 << rem) - 1
            self._bitcnt = rem
        self._buffer = bytes(out[n:])
        return bytes(out[:n])

    def to_bytetree(self) -> ByteTree:
        return node(self.group.to_bytetree(), int_leaf(self.width),
                    int_leaf(self.statdist))

    @classmethod
    def from_bytetree(cls, bt: ByteTree, device="cuda") -> "PRGElGamal":
        return cls(ModPGroup.from_bytetree(bt[0], device=device),
                   bt[1].to_u32(), bt[2].to_u32())

    def __repr__(self):
        return (f"PRGElGamal({self.group.p.bit_length()},{self.width},"
                f"{self.statdist})")


class PRGRandomSource:
    """RandomSource backed by a PRG and a persistent seed file.

    On construction the seed file is read and *immediately replaced*
    with fresh PRG output so that a crashed or copied process can never
    replay randomness (reference seed-file semantics: README.md:73-99).
    """

    def __init__(self, prg: PRG, seed_path):
        self.prg = prg
        self.seed_path = Path(seed_path)
        seed = self.seed_path.read_bytes()
        prg.set_seed(seed)
        # Replace the stored seed before emitting any randomness.
        self.seed_path.write_bytes(prg.read_bytes(len(seed)))

    @staticmethod
    def initialize(seed_path, randomsource, nbytes: int = 64) -> None:
        Path(seed_path).write_bytes(randomsource.read_bytes(nbytes))

    def read_bytes(self, n: int) -> bytes:
        return self.prg.read_bytes(n)

    def random_int(self, nbits: int) -> int:
        nbytes = (nbits + 7) // 8
        x = int.from_bytes(self.read_bytes(nbytes), "big")
        return x >> (8 * nbytes - nbits)

    def random_int_mod(self, modulus: int) -> int:
        nbits = modulus.bit_length() + 64
        return self.random_int(nbits) % modulus


# ---------------------------------------------------------------- resolvers


def resolve_hash(spec: str, device="cuda"):
    """Resolve a `rohash` info-field value to a hash object; a group it
    names is built on `device`.

    Accepted forms: "SHA-256"/"SHA-384"/"SHA-512"; "pedersen" or
    "pedersen:<group>[:width]" (wrapped in Merkle–Damgård for
    arbitrary-length input, the reference's provable RO hash:
    demo/mixnet/info_files:125-131); a marshalled hex string.
    """
    if spec.startswith("SHA-"):
        return Hashfunction(spec)
    if spec.startswith("pedersen"):
        parts = spec.split(":")
        gname = parts[1] if len(parts) > 1 else "modp2048"
        width = int(parts[2]) if len(parts) > 2 else 2
        return HashfunctionMerkleDamgaard(
            HashfunctionPedersen(ModPGroup.named(gname, device), width))
    from vmn_tpu_torch.eio.marshal import unmarshal_hex

    return unmarshal_hex(spec, device)


def resolve_prg(spec: str, device="cuda"):
    """Resolve a `prg` info-field value: "SHA-*" -> PRGHeuristic;
    "elgamal[:<group>[:width[:statdist]]]" -> PRGElGamal; hex ->
    unmarshal (a group on `device`)."""
    if spec.startswith("SHA-"):
        return PRGHeuristic(Hashfunction(spec))
    if spec.startswith("elgamal"):
        parts = spec.split(":")
        gname = parts[1] if len(parts) > 1 else "modp2048"
        width = int(parts[2]) if len(parts) > 2 else 4
        statdist = int(parts[3]) if len(parts) > 3 else 100
        return PRGElGamal(ModPGroup.named(gname, device), width, statdist)
    from vmn_tpu_torch.eio.marshal import unmarshal_hex

    return unmarshal_hex(spec, device)


def resolve_random_source(spec: str, seed: str = "", directory=None,
                          device="cuda"):
    """Resolve a privInfo `rand` field to a RandomSource.

    Forms: "RandomDevice[:path]"; "seed:<hex>" (deterministic, for
    tests/demos); "prg:<prg-spec>" with a seed file named by `seed`
    relative to `directory` (provable seed-file source).
    """
    from vmn_tpu_torch.crypto.randomsource import RandomDevice, SeededSource

    if spec.startswith("RandomDevice"):
        return RandomDevice()
    if spec.startswith("seed:"):
        return SeededSource(bytes.fromhex(spec[5:]))
    if spec.startswith("prg:"):
        prg = resolve_prg(spec[4:], device)
        seed_path = Path(directory or ".") / (seed or "seed")
        if not seed_path.exists():
            PRGRandomSource.initialize(
                seed_path, RandomDevice(),
                max(64, getattr(prg, "min_seed_bytes", 64)))
        return PRGRandomSource(prg, seed_path)
    raise ValueError(f"unknown randomness source: {spec}")

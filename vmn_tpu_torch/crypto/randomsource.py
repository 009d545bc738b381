"""Port of `vmn_tpu.crypto.randomsource`: sources of (true or seeded)
randomness for provers.

`DeviceSource` keeps `vmn_tpu`'s interface, host stream and limb layout,
but its device PRF is ChaCha20 (RFC 8439, `prf_kernels.PRF`) under a
256-bit key, expanded by the hand-written kernel of ops/prf_kernels.py,
where `vmn_tpu`'s is Threefry-2x32 under a key squeezed to 64 bits
(ROADMAP faults F1, F2).  Its device draws therefore differ from
`vmn_tpu`'s; its host bytes do not.  It has no marshal form (F3):
`vmn_tpu`'s, the hashed seed alone, replays draw 0 after a restore.

Mirrors VCR's RandomSource/RandomDevice.  Prover-side randomness (blinders,
permutation, re-encryption exponents) comes from here; *verifier-side*
randomness is always derived deterministically via the random oracle, so
only provers consume this module.
"""

from __future__ import annotations

import hashlib
import os
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from vmn_tpu_torch.crypto.prg import PRGHeuristic
from vmn_tpu_torch.crypto.hash import SHA256
from vmn_tpu_torch.ops import prf_kernels


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


# RFC 8439 §2.3.2's test block: key 00 01 .. 1f, nonce 00 00 00 09 00 00
# 00 4a 00 00 00 00 (nonce0, then the 64-bit "draw index"), counter 1.
RFC_KEY = bytes(range(32))
RFC_NONCE0, RFC_DRAW, RFC_COUNTER = 0x09000000, 0x4A000000, 1
RFC_BLOCK = bytes.fromhex(
    "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
    "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e")
_CHECKED: set = set()
_CHECK_LOCK = threading.Lock()


def limbs_bytes(limbs) -> bytes:
    """(..., 2k) 16-bit limbs -> the little-endian bytes of their 32-bit
    words (a keystream, as the PRF wrote it)."""
    v = limbs.cpu().numpy().astype(np.uint32).reshape(-1, 2)
    return (v[:, 0] | (v[:, 1] << 16)).astype("<u4").tobytes()


def check_prf(device) -> None:
    """F2: the PRF on `device` is the one named (`prf_kernels.PRF`):
    RFC 8439 §2.3.2's block through `prf_kernels.chacha20_limbs`, once a
    device and process; raises if it differs."""
    device = torch.device(device)
    key = str(device)
    with _CHECK_LOCK:
        if key in _CHECKED:
            return
        got = limbs_bytes(prf_kernels.chacha20_limbs(
            RFC_KEY, RFC_DRAW, 1, 512, device=device, counter=RFC_COUNTER,
            nonce0=RFC_NONCE0))
        if got != RFC_BLOCK:
            raise RuntimeError(
                f"the PRF on {device} is not {prf_kernels.PRF}: RFC 8439's "
                f"block begins {got[:8].hex()}, expected "
                f"{RFC_BLOCK[:8].hex()}")
        _CHECKED.add(key)


class DeviceSource(RandomSource):
    """Prover randomness expanded ON THE DEVICE by a keyed PRF (port of
    `vmn_tpu`'s, with ChaCha20 in place of its Threefry).

    Bulk random exponent arrays (re-encryption exponents, the
    permutation commitment's and the bridging commitments' blinders)
    are the largest host-to-device uploads of a mix: about 2.7 MB of host
    PRG a 2147-bit draw at N = 10000.  This source ships only a key and
    a draw index: `FField.random`/`random_bits_raw` hand each draw to
    `random_limbs`, which expands it on the modulus's device with
    `prf_kernels.chacha20_limbs` (a CPU device: its plain version).

    Host-side draws (scalars' rejection sampling, permutation keys,
    nonces, the session seed) come from `vmn_tpu`'s domain-separated
    SHA-256 PRG over the same seed, byte for byte, and `position`
    counts them as `SeededSource`'s does.  A device draw reads no host
    byte, so the host stream stays where `vmn_tpu`'s stands.

    The device key is SHA-256 over the hashed seed and a tag of its own,
    all 256 bits (F1).  Draw d is ChaCha20 under that key with nonce
    0^32 || d (64 bits, little-endian); `draws` counts them, and a
    session that persists its state persists it too, so that a restored
    state never reuses a draw index (and so a secret exponent).  There
    is no marshal form (F3).

    Security note: this replaces only PRIVATE prover randomness;
    verifier challenges and every transcript-derived value ride the
    SHA-256 PRG chain.
    """

    MARSHAL_NAME = "vmn_tpu.crypto.DeviceSource"  # not registered (F3)
    KEY_TAG = b"/device/ChaCha20/RFC8439"

    def __init__(self, seed: bytes):
        self._seed = SHA256.hash(seed)
        self._prg = PRGHeuristic(SHA256)
        self._prg.set_seed(SHA256.hash(self._seed + b"/host"))
        self.key = SHA256.hash(self._seed + self.KEY_TAG)
        self.position = 0
        self.draws = 0
        self._lock = threading.Lock()

    def read_bytes(self, n: int) -> bytes:
        self.position += n
        return self._prg.read_bytes(n)

    def to_bytetree(self):
        raise TypeError(
            "a DeviceSource has no marshal form: the seed alone would "
            "replay its draws from draw 0 (ROADMAP F3)")

    def random_limbs(self, n: int, bits: int, device,
                     rows: Optional[tuple] = None):
        """(n, Lt) int32 tensor of 16-bit limbs (LSB first) holding n
        uniform `bits`-bit integers on `device` (rows [a, b) of them with
        `rows`), drawn with the next draw index; reads no host byte."""
        check_prf(device)
        with self._lock:
            draw = self.draws
            self.draws += 1
        return prf_kernels.chacha20_limbs(self.key, draw, n, bits, rows,
                                          device)


def session_source(party_source, seed: bytes) -> RandomSource:
    """The source of a session whose randomness is seeded by a persisted
    secret: a DeviceSource where the party's is one, so that the
    session's draws stay on the device; else a SeededSource, as in
    `vmn_tpu` (whose session is always a SeededSource: README port
    deviations)."""
    if isinstance(party_source, DeviceSource):
        return DeviceSource(seed)
    return SeededSource(seed)


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

"""Prover randomness expanded on the card: the ChaCha20 kernel's wrapper,
its plain PyTorch version and its launch counter.

`chacha20_limbs` computes rows [a, b) of an n-row draw of `bits`-bit
integers as an ``(b - a, Lt)`` int32 tensor of 16-bit limbs, least
significant first (``Lt = num_limbs(bits)``, `arith/limbs.py`):

* the PRF is ChaCha20 with 20 rounds, RFC 8439 §2.3 (`PRF`), keyed with
  all 256 bits of `key`; the nonce is 32 bits (`nonce0`, 0 for a draw)
  followed by the 64-bit draw index, little-endian; the 32-bit block
  counter starts at `counter` (0 for a draw).  A draw of more than 2^32
  blocks raises;
* the layout is `vmn_tpu`'s `_prf_limbs`
  (vmn_tpu/crypto/randomsource.py:141-162) with ChaCha20's keystream in
  place of Threefry's words: row i is the ``nw = (Lt + 1) // 2``
  keystream words from word i·nw on, each a little-endian 32-bit word of
  the keystream split low half first; the last half-word is dropped when
  Lt is odd, and the top limb is masked to ``bits - 16·(Lt - 1)`` bits.

The wrapper takes the plain version for a CPU device only; for a CUDA
device it launches `csrc/prf_kernels.cu` (one thread a 64-byte block,
its keystream staged in shared memory so that a warp stores consecutive
limbs; rows [a, b) alone: a rank of a sharded mix expands its own
block) or raises — there is no fallback.  `LAUNCHES["chacha20_limbs"]`
counts its launches (an empty range launches nothing).

The kernel replaces no Pallas kernel, only `vmn_tpu`'s XLA program
`_prf_limbs`; its algorithm differs because `vmn_tpu`'s squeezes the seed
into a 64-bit Threefry key (ROADMAP F1) and is not named (F2).  What
bounds it on the card, and the rate taken, are in its source note.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import Optional, Tuple

import torch

from vmn_tpu_torch.arith.limbs import LIMB_BITS, LIMB_DTYPE, num_limbs
from vmn_tpu_torch.ops import mont_kernels as K

PRF = "ChaCha20/20, RFC 8439"
PRF_KERNELS = ("chacha20_limbs",)
LAUNCHES = dict.fromkeys(PRF_KERNELS, 0)

# "expand 32-byte k", the first four state words
SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
WORDS_PER_BLOCK = 16
MAX_BLOCKS = 1 << 32
_M32 = 0xFFFFFFFF


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launched(name: str) -> None:
    with K.COUNT_LOCK:
        LAUNCHES[name] += 1


def key_words(key: bytes) -> Tuple[int, ...]:
    """A 256-bit key as its eight little-endian state words."""
    if len(key) != 32:
        raise ValueError(f"a ChaCha20 key has 32 bytes, not {len(key)}")
    return struct.unpack("<8I", key)


def layout(n: int, bits: int, rows: Optional[tuple], counter: int = 0
           ) -> tuple:
    """(a, b, Lt, nw, top bits) of rows [a, b) of an n-row draw; raises
    on a range outside [0, n] or a draw past the block counter."""
    if bits < 1 or n < 0:
        raise ValueError(f"a draw of {n} rows of {bits} bits")
    a, b = (0, n) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= a <= b <= n:
        raise ValueError(f"rows [{a}, {b}) of a draw of {n}")
    lt = num_limbs(bits)
    nw = (lt + 1) // 2
    blocks = -(-n * nw // WORDS_PER_BLOCK)
    if counter + blocks > MAX_BLOCKS:
        raise ValueError(f"a draw of {blocks} blocks from counter {counter} "
                         f"passes ChaCha20's 2^32 blocks")
    return a, b, lt, nw, bits - LIMB_BITS * (lt - 1)


def _nonce(nonce0: int, draw: int) -> Tuple[int, int, int]:
    if not 0 <= draw < 1 << 64 or not 0 <= nonce0 < 1 << 32:
        raise ValueError("the nonce is 32 bits and a 64-bit draw index")
    return nonce0, draw & _M32, draw >> 32


# --------------------------------------------------------- plain version


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _quarter(a, b, c, d):
    a = (a + b) & _M32
    d = _rotl(d ^ a, 16)
    c = (c + d) & _M32
    b = _rotl(b ^ c, 12)
    a = (a + b) & _M32
    d = _rotl(d ^ a, 8)
    c = (c + d) & _M32
    b = _rotl(b ^ c, 7)
    return a, b, c, d


def chacha20_blocks_plain(key: bytes, nonce: Tuple[int, int, int],
                          counters: torch.Tensor) -> torch.Tensor:
    """ChaCha20 blocks at the int64 block counters `counters`, (nblk,) ->
    (nblk, 16) int64 keystream words below 2^32: 32-bit arithmetic on
    int64 tensors masked to 32 bits (torch has no uint32 add on the CPU),
    each quarter round on four columns at once, the diagonal rounds on
    rows rotated into columns."""
    dev = counters.device
    init = torch.empty((counters.shape[0], 16), dtype=torch.int64,
                       device=dev)
    init[:, :4] = torch.tensor(SIGMA, dtype=torch.int64, device=dev)
    init[:, 4:12] = torch.tensor(key_words(key), dtype=torch.int64,
                                 device=dev)
    init[:, 12] = counters & _M32
    init[:, 13:] = torch.tensor(nonce, dtype=torch.int64, device=dev)
    a, b, c, d = (init[:, i:i + 4] for i in range(0, 16, 4))
    for _ in range(10):
        a, b, c, d = _quarter(a, b, c, d)
        b, c, d = b.roll(-1, 1), c.roll(-2, 1), d.roll(-3, 1)
        a, b, c, d = _quarter(a, b, c, d)
        b, c, d = b.roll(1, 1), c.roll(2, 1), d.roll(3, 1)
    return (torch.cat([a, b, c, d], 1) + init) & _M32


def chacha20_limbs_plain(key: bytes, draw: int, n: int, bits: int,
                         rows: Optional[tuple] = None, device="cpu",
                         counter: int = 0, nonce0: int = 0) -> torch.Tensor:
    """The plain version of `chacha20_limbs`: the blocks that rows [a, b)
    touch, on `device`, vectorised over blocks, then `_prf_limbs`'s
    layout."""
    a, b, lt, nw, top = layout(n, bits, rows, counter)
    w0, w1 = a * nw, b * nw
    blk0 = w0 // WORDS_PER_BLOCK
    blk1 = -(-w1 // WORDS_PER_BLOCK)
    counters = counter + torch.arange(blk0, blk1, dtype=torch.int64,
                                      device=device)
    words = chacha20_blocks_plain(key, _nonce(nonce0, draw), counters)
    words = words.reshape(-1)[w0 - blk0 * WORDS_PER_BLOCK:
                              w1 - blk0 * WORDS_PER_BLOCK].reshape(b - a, nw)
    limbs = torch.stack([words & 0xFFFF, words >> LIMB_BITS], -1)
    limbs = limbs.reshape(b - a, 2 * nw)[:, :lt]
    if top < LIMB_BITS:
        limbs[:, lt - 1] &= (1 << top) - 1
    return limbs.to(LIMB_DTYPE)


# --------------------------------------------------------------- kernel


_lock = threading.Lock()
_bound = None


def _library() -> ctypes.CDLL:
    """The shared library of ops/mont_kernels.py (csrc/*.cu) with the PRF
    entry point's signature set."""
    global _bound
    with _lock:
        if _bound is None:
            lib = K._library()
            fn = lib.vmn_chacha20_limbs
            fn.argtypes = [ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32,
                           ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int64,
                           ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _bound = lib
    return _bound


def chacha20_limbs(key: bytes, draw: int, n: int, bits: int,
                   rows: Optional[tuple] = None, device="cuda",
                   counter: int = 0, nonce0: int = 0) -> torch.Tensor:
    """Rows [a, b) (`rows`; all n where None) of draw `draw` of n
    `bits`-bit integers under `key`, as (b - a, Lt) int32 limbs on
    `device`: the plain version on the CPU, the kernel on a CUDA device,
    anything else raises."""
    device = torch.device(device)
    if device.type == "cpu":
        return chacha20_limbs_plain(key, draw, n, bits, rows, device,
                                    counter, nonce0)
    if device.type != "cuda":
        raise ValueError(f"chacha20_limbs: no kernel for {device}")
    a, b, lt, nw, top = layout(n, bits, rows, counter)
    nonce = _nonce(nonce0, draw)
    words = (ctypes.c_uint32 * 8)(*key_words(key))
    out = torch.empty((b - a, lt), dtype=LIMB_DTYPE, device=device)
    if b > a:
        K._check("chacha20_limbs", _library().vmn_chacha20_limbs(
            words, nonce[0], draw, counter, a, b, nw, lt, top, K._ptr(out),
            K._stream(device)))
        _launched("chacha20_limbs")
    return out

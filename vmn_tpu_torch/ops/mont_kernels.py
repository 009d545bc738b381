"""Batched Montgomery kernels: Hopper CUDA wrappers and plain PyTorch
versions (port of `vmn_tpu.ops.mont_kernels`).

Every operation of a ModP group, and the field products and powers of an
EC group, reduce to these functions (point arithmetic is
ops/ec_kernels.py).  Each has three parts here:

* the wrapper (`mont_mul`, `mont_exp`, `mont_fb_exp`,
  `mont_expprod_positions`, `mont_expprod_combine`, and `mont_expprod`,
  the last two in sequence).  Operands on the CPU with a modulus there
  go to the plain version; CUDA operands go to the kernel in
  `csrc/mont_kernels.cu` or raise, and so does an operand on another
  device than the modulus (`on_host`) — there is no fallback;
* the plain PyTorch version (`*_plain`): exact integer arithmetic on
  int64 tensors with log-depth carry resolution (and float64 products
  whose sums stay below 2^53), any algorithm that gives the same
  canonical limbs; on a few rows of a CPU tensor the same steps on
  Python integers (`HostField`);
* a launch counter per wrapper (`LAUNCHES[name]`), bumped only where the
  wrapper launches its kernel; H1 and H2 also count their launches by
  batch size (`LAUNCH_SIZES`).

Arrays at this boundary are ``(N, L)`` int32 tensors of 16-bit limbs
(arith/limbs.py), Montgomery radix ``R = 2^(16·L)``.  The kernels pack
limb pairs into 32-bit words: at an odd L (P-521: 33; a 1000-bit group:
63), or where L/2 words have no kernel (P-224: 14 limbs, 7 words), they
compute at an inner width of W' words, R' = 2^(32·W') > R, on operands
padded with zero limbs, and convert at their boundary (`Modulus`);
nothing outside the kernels changes.  `kernel_words` maps L to the
kernels' words: a width of the main library (_WIDTHS) where L/2 is one,
else ⌈L/2⌉ rounded up to 8 words (16 above 64, 32 above 128), to at
most MAX_WORDS = 512 (16384 bits).  A width, or a kernel at a width,
that the main library lacks is built at its first use (`width_library`:
one nvcc of csrc/mont_kernels.cu with -DVMN_W=w, the TPIs of
`coop_rule`), so every ModP group up to 16384 bits runs on the card, as
`vog -bitlen n` makes them, RFC 3526's modp6144 (W = 192) and modp8192
(W = 256) and NIST SP 800-57's 15360-bit strength (W = 480) among
them.

Kernel notes (what each replaces, what bounds it on an H100, what the
design does about it):

* The kernel boundary at a padded modulus (P-521's field and ring, L =
  33, P-224's, L = 14, a 1000-bit group's, L = 63): the wrappers pad the
  operands to 2·W' limbs (W' = INNER_WORDS[L]: 20 and 8, P-224 on the
  P-256 instantiations; else kernel_words) and pack limb pairs into
  words as at every width; every kernel but H7 (`CONVERTS`) takes each
  Montgomery operand from R to R' by one product with c_in and each
  result back by one with c_out (`coop_rebase` in csrc/mont_coop.cuh;
  H6's one-thread form at W = 8 does the same on its own field; H3
  converts its packed table once a launch, H4 each base as its chunk
  loads it and each partial as it stores it, K7's combine each position
  beside its first squaring), a runtime switch that is off (NULL
  constants) at every other modulus, whose launches and results do not
  change.  Two products an element against about
  8000 in a 521-bit scalar multiple; H1 does one (a·b·R'^-1 times c_in),
  so at P-224 it runs two products an element where P-256 runs one.
  W' = 20 against 24 on the H100 (`kernel_timing.py --sweep`, PERF.md
  §6): faster at every kernel of the path but the combine, a chain of
  dependent products where 8 lanes of 3 words beat 4 of 5.
* H1 `mont_mul` replaces K2 `mont_mul_pallas`
  (vmn_tpu/ops/mont_kernels.py:182-216).  A W-word product (W = L/2) is
  4·W² + W 32-bit multiplies, so a large batch is bound by integer
  multiply issue; but most launches on the mix path are tiny batches (the
  product trees and scans near their root, H4's lane tree), where one
  thread's 2·W² dependent multiply-adds (~60 µs at W = 64 on an H100)
  would be the latency.  The kernel spreads one element over TPI lanes of a warp
  (csrc/mont_coop.cuh): TPI = 32 for small batches, so a batch-1 product
  is W/32 words of work a lane, and fewer lanes from the batch size where
  they measured faster (`COOP_TPI`).  ptxas: 48/28 registers at W = 64,
  TPI 8/32, 21 at W = 8, TPI 8; no spills.
* H2 `mont_exp` replaces K3 `mont_exp_pallas` (:222-286, :753-795): 4-bit
  fixed windows, 14 products for the table and 5 per digit (2574 at 2047
  bits), constant-time masked select.  Bound by those products.  One
  thread per element would hold the 4 KB table and the product's operands
  in local memory, fill 79 blocks of 132 SMs at N = 10000, and run a batch
  of one (the inversions) as 2574 products on one thread.  Instead TPI
  lanes share an element as in H1, the table lies in shared memory
  ([entry][word][thread], conflict-free), the accumulator and each lane's
  slice in registers.
  ptxas: 56/32 registers at W = 64, TPI 8/32, 56/26 at W = 8, TPI 1/8;
  no spills.  The table (4 KB an element at W = 64) caps an SM at 48
  resident elements in 64 KB blocks.
* H3 `mont_fb_exp` (window 4 or 8) replaces K5 `mont_fb_exp_pallas`
  (:292-353, :486-527) and K4 `mont_fb8_exp_pallas` (:361-483); routed by
  exponent bits as vmn_tpu/arith/mont.py:1055 does.  TPI lanes of a warp
  share an element as in H1 (TPI from `COOP_TPI`); per digit the block
  stages the digit's entries in shared memory, the copy of the next digit
  (`cp.async`, two buffers) under this digit's work, and each lane
  masked-selects its slice of the factor from every entry (`fb_pack`
  lays the table out so that the reads are broadcasts without bank
  conflicts).  A window-8 digit's entries are 64 KB at 2048 bits, so a
  block holds an SM's shared memory alone; `fb_launch` sizes the blocks
  so that N = 10000 fills the 132 SMs once.  At 4096 bits two digits
  (256 KB) pass the 227 KB a block may use: the digit is staged in two
  halves (so at 6144 bits, two 96 KB halves), at 8192 bits in quarters,
  at 15360 and 16384 bits in eighths (`fb_pieces`), the select running
  over every piece before the product.  Bound by the products (one
  a digit) and, at window 8, by the select, which costs about as much
  as the product it feeds.  The TPU's one-hot f32 MXU gather is not
  carried over.
* H4 `mont_expprod_positions` replaces both `pallas_call`s of K6 (:552-727)
  with one launch in which no table goes through device memory.  A block takes a block of digit positions and of elements and
  walks its elements in chunks: the groups (TPI lanes, the cooperative
  product) build each element's 16 entries in shared memory in four
  levels of independent products, then fold the chunk into one
  accumulator a (position, share of the elements), with a masked select
  over all 16 entries; an H1 lane tree multiplies the blocks' partials.
  Bound by its products: one a (element, position) and 14 an element for
  each block of positions.  `ep_launch` gives the shape: positions in
  blocks of `jb` (a multiple of EP_JB dividing ndig_pad, smaller while few
  elements leave SMs idle), elements in about 132/pblocks blocks of at least
  EP_MIN_ELEMENTS, chunks sized to the 227 KB a block may use with the
  accumulators within EP_ACC_BYTES, which keeps W = 96 and 128 in reach.
  EP_SUPER, EP_PER_LANE and EP_MAX_LANES (the device-memory table's cap
  and the lane count) are gone with the table; TPI from `COOP_TPI`.
* K7 `mont_expprod_pallas` (:730-750) is `mont_expprod` here: H4, then
  `mont_expprod_combine`, prod_j P_j^(2^(4j)) in one launch: one warp runs
  the 5·ndig_pad products back to back with H1's cooperative product,
  where a loop over H1 would launch 5·ndig_pad single-element batches.  A
  chain of dependent products: bound by the latency of one product, not
  by the card's throughput.  ptxas: 26 registers at W = 64, 22 at W = 8.

Every kernel here takes row-major ``(N, L)`` operands as they are.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
WINDOW = 4  # variable-base and multi-exponentiation window
# Digit positions are padded to a multiple of this (as K6); H4's blocks of
# positions are multiples of it too.
EP_JB = 16

KERNELS = ("mont_mul", "mont_exp", "mont_fb_exp", "mont_expprod_positions",
           "mont_expprod_combine")
LAUNCHES = dict.fromkeys(KERNELS, 0)
# H1, H2 and H3 launches by batch size: 1, 2-127, >= 128 elements.
SIZE_BUCKETS = ("1", "2-127", ">=128")
LAUNCH_SIZES = {k: dict.fromkeys(SIZE_BUCKETS, 0)
                for k in ("mont_mul", "mont_exp", "mont_fb_exp")}
# Launches by (wrapper, the kernels' words W, whether the modulus is
# converted at their boundary: Modulus.conv).
LAUNCH_WIDTHS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for sizes in LAUNCH_SIZES.values():
        for b in sizes:
            sizes[b] = 0
    LAUNCH_WIDTHS.clear()


def size_bucket(n: int) -> str:
    """The SIZE_BUCKETS entry of a launch over n >= 1 elements."""
    return SIZE_BUCKETS[0 if n == 1 else 1 if n < 128 else 2]


# Parties in threads of one process launch concurrently; the counts are
# totals over them.
COUNT_LOCK = threading.Lock()


def _launched(name: str, n: int, mod: Optional["Modulus"] = None) -> None:
    with COUNT_LOCK:
        LAUNCHES[name] += 1
        if name in LAUNCH_SIZES:
            LAUNCH_SIZES[name][size_bucket(n)] += 1
        if mod is not None:
            key = (name, mod.W, mod.conv)
            LAUNCH_WIDTHS[key] = LAUNCH_WIDTHS.get(key, 0) + 1


# ------------------------------------------------------------ constants


# The kernels' words at a limb count whose own L/2 words have no kernel:
# an odd L (R = 2^(16·L) is then 2^(32·W) for no W) or an even one whose
# L/2 is not instantiated.  The kernels compute at W' words, R' =
# 2^(32·W') > R, and convert at their boundary (Modulus).  L = 14: the
# P-224 field and its scalar ring on the P-256 instantiations (W' = 8);
# L = 33: the P-521 field and ring (PERF.md §6: W' = 20 against 24).
INNER_WORDS = {14: 8, 33: 20}
# The words the main library is built at (mont_kernels.cu's fixed
# switches): test256 and the P-256 field (and P-224's field and ring at
# W' = 8), the P-384 field and ring, the P-521 field and ring (W' = 20),
# modp2048, modp3072, modp4096.  Every other width a modulus asks for is
# built on demand (`build_widths`).
_WIDTHS = (8, 12, 20, 64, 96, 128)
# The widest modulus the kernels take: 512 words, 16384 bits (RFC 3526's
# modp6144 at W = 192 and modp8192 at W = 256, a 15360-bit group at
# W = 480, built on demand).  Wider raises: TPI 32, one warp, would leave
# a lane more than 16 words (a group of more than one warp is not built).
MAX_WORDS = 512


def kernel_words(L: int) -> int:
    """The words the kernels compute a modulus of L limbs at (Modulus.W):
    INNER_WORDS[L]; else L/2 where the main library is built at it; else
    ⌈L/2⌉ rounded up to a multiple of 8 words (of 16 above 64, of 32
    above 128), built on demand, with the boundary conversion where that
    is not L/2.  The rounding keeps a lane's slice within 8 words up to
    256 words, 16 above: the cooperative product needs TPI | W
    (`CoopMontSum`), and H3's and H4's blocks of up to 1024 threads
    (`block_cap`) cap a thread at 64 registers, which W/TPI = 8 words
    fill (W = 64, TPI 8: 56 and 64 registers, no spill), their blocks of
    up to 512 above 256 words at 128; W a multiple of 8 (16, 32) has TPI
    8 (16, 32) among its divisors (`coop_rule`): 6144 bits (L = 384) at
    W = 192, 8192 bits (L = 512) at W = 256, 15360 bits (L = 960) at
    W = 480, each at TPI 32.  Raises a ValueError above MAX_WORDS."""
    if L in INNER_WORDS:
        return INNER_WORDS[L]
    if L % 2 == 0 and L // 2 in _WIDTHS:
        return L // 2
    w = -(-L // 2)
    step = 8 if w <= 64 else 16 if w <= 128 else 32
    w = -(-w // step) * step
    if w > MAX_WORDS:
        raise ValueError(f"no kernel for L={L} limbs: {w} words pass the "
                         f"cap of {MAX_WORDS} words ({32 * MAX_WORDS} bits)")
    return w


@dataclass(frozen=True)
class Modulus:
    """Device constants of one odd modulus, as every wrapper takes them.

    `W` is the kernels' word count.  Where 2·W = L (every even width) the
    kernels compute at the limbs' own radix R = 2^(16·L).  Otherwise
    (`conv`) they compute at R' = 2^(32·W) > R on operands padded with
    zero limbs to 2·W: a Montgomery operand x·R is taken to x·R' on load
    by one product with c_in = R'^2/R mod m, a result goes back to x·R on
    store by one product with c_out = R mod m, and `kernel_one` (R' mod
    m) is the one inside.  m' mod 2^32 does not depend on the radix.
    Every limb array outside the kernels stays at L limbs and R."""

    m: int
    L: int
    limbs: torch.Tensor  # (L,) int32 limbs of m
    mprime32: int  # -m^-1 mod 2^32: the kernels' word-level m'
    mprime_limbs: torch.Tensor  # (L,) -m^-1 mod R: the plain REDC's m'
    one_mont: torch.Tensor  # (L,) R mod m
    W: int  # words the kernels compute at
    kernel_limbs: torch.Tensor  # (2W,) m
    kernel_one: torch.Tensor  # (2W,) R' mod m
    c_in: Optional[torch.Tensor]  # (2W,) R'^2/R mod m where conv, else None
    c_out: Optional[torch.Tensor]  # (2W,) R mod m where conv, else None

    @property
    def conv(self) -> bool:
        return 2 * self.W != self.L

    @classmethod
    def of(cls, m: int, L: int, device) -> "Modulus":
        """The constants of m at L limbs on `device`; off the CPU W is
        `kernel_words(L)`, which raises above MAX_WORDS.  On the CPU,
        where only the plain versions run (at any L), a modulus past the
        cap keeps ⌈L/2⌉ words."""
        R = 1 << (LIMB_BITS * L)
        if torch.device(device).type == "cpu" and -(-L // 2) > MAX_WORDS:
            W = -(-L // 2)
        else:
            W = kernel_words(L)
        R_in = 1 << (2 * LIMB_BITS * W)

        def limbs(x, n=L):
            return torch.tensor(
                [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n)],
                dtype=torch.int32, device=device,
            )

        conv = 2 * W != L
        return cls(
            m=m,
            L=L,
            limbs=limbs(m),
            mprime32=(-pow(m, -1, 1 << 32)) & 0xFFFFFFFF,
            mprime_limbs=limbs((-pow(m, -1, R)) % R),
            one_mont=limbs(R % m),
            W=W,
            kernel_limbs=limbs(m, 2 * W),
            kernel_one=limbs(R_in % m, 2 * W),
            c_in=limbs(R_in * R_in * pow(R, -1, m) % m, 2 * W) if conv
            else None,
            c_out=limbs(R % m, 2 * W) if conv else None,
        )


# ------------------------------------------------------ plain helpers
# int64 limb arithmetic.  "Lazy" limbs are non-negative and below 2^63;
# `_resolve` turns them into canonical 16-bit limbs: split passes (carry
# the high part one limb up) until every limb is at most 2^16 + 2, then
# the remaining 0/1 carries in one scan: the carry into limb k is the
# generate bit of the nearest limb below k that does not propagate
# (limb != 0xFFFF), found with a running maximum of indices.  Where a
# result is reduced mod m, the value and the value minus m (offset by a
# power of the radix) are resolved in one stacked call and the carry out
# picks between them; these plain versions run on small batches, where
# each torch call costs about the same whatever its size.


def _shift_up(x: torch.Tensor, d: int) -> torch.Tensor:
    """Shift along the last axis toward higher indices, zero fill."""
    return torch.constant_pad_nd(x[..., :-d], (d, 0))


def _resolve(t: torch.Tensor, width: int, passes: int = 2) -> torch.Tensor:
    """Lazy limbs -> canonical limbs of the value mod 2^(16·width).
    The carry scan takes limbs of at most 2^17 - 2, which one split pass
    leaves of limbs below 2^32, two of limbs below 2^47 and three of any
    below 2^63 (a pass takes a bound B to 2^16 - 1 + B/2^16)."""
    if t.shape[-1] < width:
        t = torch.constant_pad_nd(t, (0, width - t.shape[-1]))
    elif t.shape[-1] > width:
        t = t[..., :width]
    for _ in range(passes):
        t = (t & LIMB_MASK) + _shift_up(t >> LIMB_BITS, 1)
    pos = _positions(width, t.device)
    stop = torch.where(t == LIMB_MASK, -1, pos)
    below = _shift_up(torch.cummax(stop, dim=-1).values + 1, 1) - 1
    cin = (t >> LIMB_BITS).gather(-1, below.clamp(min=0)) * (below >= 0)
    return (t + cin) & LIMB_MASK


def _mul_lazy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product (n, La) x (n | 1, Lb) -> (n, La+Lb) lazy limbs.

    Outer product, then the anti-diagonal sums by the skew trick: padded
    rows of width La+Lb re-read at width La+Lb-1 put x[i, j] in column
    i+j of row i."""
    La, Lb = a.shape[-1], b.shape[-1]
    outer = a.unsqueeze(-1) * b.unsqueeze(-2)  # (n, La, Lb)
    n = outer.shape[0]
    z = torch.constant_pad_nd(outer, (0, La)).reshape(n, La * (La + Lb))
    skew = z[:, : La * (La + Lb - 1)].reshape(n, La, La + Lb - 1)
    return torch.constant_pad_nd(skew.sum(-2), (0, 1))


def _neg_m(m64: torch.Tensor, width: int) -> torch.Tensor:
    """Limbs of 2^(16·width) - m (width > L), lazy (limb 0 may be 2^16)."""
    comp = torch.constant_pad_nd(LIMB_MASK - m64, (0, width - m64.shape[-1]),
                                 LIMB_MASK)
    comp[0] += 1
    return comp


# The plain versions' constants, made once: a plain product of a few
# elements is about a hundred small torch calls, and building these at
# every product took a tenth of its time on the CPU.  Keyed by the limb tensor
# of the modulus (its id; the entry goes when the tensor does) and the
# name and device asked for.
_PLAIN_CONSTS: dict = {}
_POSITIONS: dict = {}


def _positions(width: int, device) -> torch.Tensor:
    key = (width, str(device))
    pos = _POSITIONS.get(key)
    if pos is None:
        pos = _POSITIONS[key] = torch.arange(width, device=device)
    return pos


def _plain_const(m: torch.Tensor, name: str, device, make):
    """make(m as int64 on `device`), cached under (name, device) for the
    modulus limbs m."""
    per = _PLAIN_CONSTS.get(id(m))
    if per is None:
        per = _PLAIN_CONSTS[id(m)] = {}
        weakref.finalize(m, _PLAIN_CONSTS.pop, id(m), None)
    key = (name, str(device))
    c = per.get(key)
    if c is None:
        c = per[key] = make(m.to(device, torch.int64))
    return c


# Rows per plain-product chunk: bounds the (rows, L, 2L) int64 outer
# product at 2^26 entries (512 MB) on the host and 2^28 (2 GB) on a
# card, where each chunk's few dozen launches, not its bytes, set the
# time (the plain H4 at W = 128 over 10^4 elements and full-width
# exponents is 2·10^4 chunks at 2^26).
_PLAIN_ELEMS = {"cpu": 1 << 26, "cuda": 1 << 28}


def _toeplitz(v: torch.Tensor, cols: int) -> torch.Tensor:
    """(L,) limbs -> the (L, cols) float64 matrix M[i, k] = v[k - i]
    (0 <= k - i < L): x @ M is the limb convolution x·v cut to cols
    limbs."""
    L = v.shape[-1]
    d = (torch.arange(cols, device=v.device)[None, :]
         - torch.arange(L, device=v.device)[:, None])
    inside = (d >= 0) & (d < L)
    return torch.where(inside, v[d.clamp(0, L - 1)], 0).to(torch.float64)


# ------------------------------------------ plain versions on few rows
# On up to HOST_ROWS rows of a CPU tensor the plain versions run the same
# steps on Python integers (numpy object vectors): the same REDC (one
# conditional subtraction), the same modular sums and differences, so
# the same limbs as the torch ops, at a few microseconds a step in place
# of a torch call's hundreds.  CUDA tensors always take the torch ops.
# (A plain product on 256 rows on the CPU, two torch threads: test256
# 1.9 ms by the torch ops against 0.7 ms here, modp2048 47.7 against
# 6.7, modp3072 115.3 against 8.3; a fixed-base table of modp2048, 256
# rows a product, is the largest batch of the CPU tests' small mixes.)
HOST_ROWS = 256


def host_route(t: torch.Tensor, rows: int) -> bool:
    """Whether a plain version runs on Python integers here."""
    return t.device.type == "cpu" and rows <= HOST_ROWS


class HostField:
    """Limb rows of one modulus as Python integers, and the plain
    versions' field steps on them (vectors: numpy object arrays)."""

    def __init__(self, mod: Modulus):
        self.m, self.L = mod.m, mod.L
        self.bits = LIMB_BITS * mod.L
        self.mask = (1 << self.bits) - 1
        self.mprime = (-pow(mod.m, -1, 1 << self.bits)) & self.mask
        self.one = (1 << self.bits) % mod.m

    def ints(self, t: torch.Tensor) -> np.ndarray:
        """(..., L) canonical limbs -> flat object vector of integers."""
        raw = t.reshape(-1, self.L).to(torch.int32).numpy().astype("<u2")
        out = np.empty(raw.shape[0], dtype=object)
        out[:] = [int.from_bytes(r.tobytes(), "little") for r in raw]
        return out

    def tensor(self, v: np.ndarray) -> torch.Tensor:
        """Object vector of integers below 2^(16·L) -> (n, L) int32."""
        nb = 2 * self.L
        raw = b"".join(int(x).to_bytes(nb, "little") for x in v)
        return torch.from_numpy(np.frombuffer(raw, "<u2").reshape(
            len(v), self.L).astype(np.int32))

    def redc(self, a, b):
        """a·b·R^-1 as mont_mul_plain computes it: REDC with one
        conditional subtraction."""
        t = a * b
        u = (t + ((t & self.mask) * self.mprime & self.mask) * self.m) \
            >> self.bits
        return np.where(u >= self.m, u - self.m, u)

    def add_mod(self, a, b):
        s = a + b
        return np.where(s >= self.m, s - self.m, s) & self.mask

    def sub_mod(self, a, b):
        d = a - b
        return np.where(a >= b, d, (d + self.m) & self.mask)

    # the point formulas' interface (ops/ec_kernels.py `_PlainField`)
    def mul(self, *pairs):
        return self._stacked(self.redc, pairs)

    def add(self, *pairs):
        return self._stacked(self.add_mod, pairs)

    def sub(self, *pairs):
        return self._stacked(self.sub_mod, pairs)

    @staticmethod
    def _stacked(op, pairs):
        out = op(np.concatenate([p[0] for p in pairs]),
                 np.concatenate([p[1] for p in pairs]))
        return np.split(out, len(pairs))

    @staticmethod
    def is_zero(x):
        return x == 0

    @staticmethod
    def where(mask, a, b):
        return np.where(mask, a, b)

    @staticmethod
    def zeros_like(x):
        return np.zeros(x.shape, dtype=object)


def host_field(mod: Modulus) -> HostField:
    """mod's HostField, made once a modulus (its m' is a full-width
    modular inverse, most of a one-row product's time where made at each
    call)."""
    return _plain_const(mod.limbs, "host_field", "cpu",
                        lambda _: HostField(mod))


def _mont_mul_host(a: torch.Tensor, b: torch.Tensor, mod: Modulus
                   ) -> torch.Tensor:
    F = host_field(mod)
    return F.tensor(F.redc(F.ints(a), F.ints(b)))


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor, mod: Modulus
                   ) -> torch.Tensor:
    """a·b·R^-1 mod m by REDC with the full-width m' (exact integers).

    T = a·b stays lazy (limb i at most (i+1)·(2^16-1)^2); its low half is
    resolved to 16-bit limbs, q = T·m' mod R and q·m are float64 products
    with m' and m as Toeplitz matrices, exact because their sums of at
    most L products below 2^32 stay below 2^53 (L <= 2^21); U = T + q·m
    is resolved, and its high half U/R < 2m together with
    U/R + 2^(16(L+1)) - m, whose carry out says whether U/R >= m.  The
    limbs of T, T_lo·m' and U stay below 2L·2^32 <= 2^47 (L <= 2^14), so
    two split passes resolve each."""
    L = mod.L
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    if host_route(a, a.numel() // L):
        return _mont_mul_host(a, b, mod).reshape(shape)
    a = a.reshape(-1, L).to(torch.int64)
    b = b.reshape(-1, L).to(torch.int64)
    dev = a.device
    mq = _plain_const(mod.mprime_limbs, "toeplitz", dev,
                      lambda v: _toeplitz(v, L))
    mm = _plain_const(mod.limbs, "toeplitz2", dev,
                      lambda v: _toeplitz(v, 2 * L))
    neg_m = _plain_const(mod.limbs, "neg_m_pad", dev, lambda v:
                         torch.constant_pad_nd(_neg_m(v, L + 1), (0, 1)))
    rows = max(1, _PLAIN_ELEMS[dev.type] // (2 * L * L))
    outs = []
    for s in range(0, a.shape[0], rows):
        T = _mul_lazy(a[s : s + rows], b[s : s + rows])
        T_lo = _resolve(T[:, :L], L).to(torch.float64)
        q = _resolve((T_lo @ mq).to(torch.int64), L)
        U = T + (q.to(torch.float64) @ mm).to(torch.int64)
        hi = _resolve(U, 2 * L + 2)[:, L:]  # (L + 2) limbs, U/R < 2m
        D = _resolve(hi + neg_m, L + 2, passes=1)
        ge = D[:, L + 1 :] == 1
        outs.append(torch.where(ge, D[:, :L], hi[:, :L]))
    out = (outs[0] if len(outs) == 1 else torch.cat(outs)) if outs else a[:0]
    return out.to(torch.int32).reshape(shape)


def add_mod(a: torch.Tensor, b: torch.Tensor, m: torch.Tensor
            ) -> torch.Tensor:
    """(a + b) mod m for canonical a, b < m (int32 limbs): a + b and
    a + b + 2^(16(L+1)) - m resolved together; the carry out of the
    second says a + b >= m."""
    a, b = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
    L = a.shape[-1]
    s = torch.constant_pad_nd(a + b, (0, 1))
    neg_m = _plain_const(m, "neg_m", a.device, lambda v: _neg_m(v, L + 1))
    v = _resolve(torch.stack([s, s + neg_m]), L + 2, passes=1)
    return torch.where(v[1, ..., L + 1 :] == 1, v[1, ..., :L],
                       v[0, ..., :L]).to(torch.int32)


def sub_mod(a: torch.Tensor, b: torch.Tensor, m: torch.Tensor
            ) -> torch.Tensor:
    """(a - b) mod m for canonical a, b < m (int32 limbs): a - b + R and
    a - b + R + m resolved together; the top limb of the first says
    a >= b."""
    a, b = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
    L = a.shape[-1]
    d = a + (LIMB_MASK - b)
    d[..., 0] += 1
    m64 = _plain_const(m, "int64", a.device, lambda v: v)
    v = _resolve(torch.stack([d, d + m64]), L + 1, passes=1)
    return torch.where(v[0, ..., L:] == 1, v[0, ..., :L],
                       v[1, ..., :L]).to(torch.int32)


def _digits(e: torch.Tensor, ndig: int, window: int) -> torch.Tensor:
    """(N, Le) exponent limbs -> (ndig, N) int64 digits of `window` bits,
    digit j = bits [window·j, window·(j+1)); past the last limb: zero."""
    per = LIMB_BITS // window
    need = -(-ndig // per)
    e = e.to(torch.int64)
    if e.shape[-1] < need:
        e = torch.nn.functional.pad(e, (0, need - e.shape[-1]))
    shifts = torch.arange(per, device=e.device, dtype=torch.int64) * window
    d = (e[:, :need, None] >> shifts) & ((1 << window) - 1)  # (N, need, per)
    return d.reshape(e.shape[0], need * per)[:, :ndig].T


def mont_exp_plain(base: torch.Tensor, e: torch.Tensor, mod: Modulus,
                   nbits: int) -> torch.Tensor:
    """Plain version of H2: base^e, 4-bit fixed windows.  base (N, L)
    Montgomery form, e (N, Le) standard limbs < 2^nbits."""
    N = base.shape[0]
    ndig = max(1, -(-nbits // WINDOW))
    if host_route(base, N):
        return _mont_exp_host(base, e, mod, ndig)
    one = mod.one_mont.expand(N, mod.L)
    table = [one, base]
    for _ in range(2, 1 << WINDOW):
        table.append(mont_mul_plain(table[-1], base, mod))
    table = torch.stack(table)  # (16, N, L)
    digits = _digits(e, ndig, WINDOW)
    rows = torch.arange(N, device=base.device)
    acc = one
    for j in range(ndig - 1, -1, -1):
        for _ in range(WINDOW):
            acc = mont_mul_plain(acc, acc, mod)
        acc = mont_mul_plain(acc, table[digits[j], rows], mod)
    return acc.contiguous()


def _mont_exp_host(base: torch.Tensor, e: torch.Tensor, mod: Modulus,
                   ndig: int) -> torch.Tensor:
    """mont_exp_plain's steps on Python integers."""
    F = host_field(mod)
    b = F.ints(base)
    table = [np.full(len(b), F.one, dtype=object), b]
    for _ in range(2, 1 << WINDOW):
        table.append(F.redc(table[-1], b))
    table = np.stack(table)
    digits = _digits(e, ndig, WINDOW).numpy()
    rows = np.arange(len(b))
    acc = table[0]
    for j in range(ndig - 1, -1, -1):
        for _ in range(WINDOW):
            acc = F.redc(acc, acc)
        acc = F.redc(acc, table[digits[j], rows])
    return F.tensor(acc)


def mont_fb_exp_plain(table: torch.Tensor, e: torch.Tensor, mod: Modulus
                      ) -> torch.Tensor:
    """Plain version of H3: prod_j table[j][digit_j(e)], table
    (ndig, 2^w, L) Montgomery form, window w = log2(table.shape[1])."""
    ndig, entries, _ = table.shape
    window = entries.bit_length() - 1
    digits = _digits(e, ndig, window)
    acc = mod.one_mont.expand(e.shape[0], mod.L)
    for j in range(ndig):
        acc = mont_mul_plain(acc, table[j][digits[j]], mod)
    return acc.contiguous()


def _ndig_pad(nbits: int) -> int:
    ndig = max(1, -(-nbits // WINDOW))
    return -(-ndig // EP_JB) * EP_JB


def mont_expprod_positions_plain(bases: torch.Tensor, e: torch.Tensor,
                                 mod: Modulus, nbits: int) -> torch.Tensor:
    """Plain version of H4: P_j = prod_i bases_i^(d_ij) for every 4-bit
    digit position j < ndig_pad.  Returns (ndig_pad, L) Montgomery form;
    positions past the exponents hold the identity."""
    N, L = bases.shape
    ndig_pad = _ndig_pad(nbits)
    one = mod.one_mont.expand(N, L)
    table = [one, bases]
    for _ in range(2, 1 << WINDOW):
        table.append(mont_mul_plain(table[-1], bases, mod))
    table = torch.stack(table)  # (16, N, L)
    digits = _digits(e, ndig_pad, WINDOW)  # (ndig_pad, N)
    P = table[digits, torch.arange(N, device=bases.device)]  # (ndig_pad, N, L)
    return _lane_tree(P, mod, mont_mul_plain)


def _lane_tree(P: torch.Tensor, mod: Modulus, mul) -> torch.Tensor:
    """(J, lanes, L) -> (J, L): product over the lane axis."""
    if P.shape[1] == 0:
        return mod.one_mont.expand(P.shape[0], mod.L).contiguous()
    while P.shape[1] > 1:
        J, n, L = P.shape
        h = n // 2
        lo = mul(P[:, :h].reshape(-1, L), P[:, h : 2 * h].reshape(-1, L), mod)
        lo = lo.reshape(J, h, L)
        P = torch.cat([lo, P[:, 2 * h :]], dim=1) if n % 2 else lo
    return P[:, 0].contiguous()


def mont_expprod_combine_plain(P: torch.Tensor, mod: Modulus) -> torch.Tensor:
    """Plain version of the K7 combine: prod_j P_j^(2^(4j)) of (J, L)
    Montgomery-form positions -> (L,), Horner from the top position."""
    acc = mod.one_mont.reshape(1, -1)
    for j in range(P.shape[0] - 1, -1, -1):
        for _ in range(WINDOW):
            acc = mont_mul_plain(acc, acc, mod)
        acc = mont_mul_plain(acc, P[j : j + 1], mod)
    return acc[0]


# ---------------------------------------------------------- the kernels

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
_UNSUPPORTED_WIDTH = -1
_BAD_SHAPE = -2

# Threads per element (TPI) of the cooperative kernels for n elements of W
# words: TPI lanes of one warp share an element (H1-H4) or a point (H5, H8,
# the EC combine).  Per (kernel, W), (from n elements, TPI) pairs, largest
# n first.  Each n is the smallest N that `kernel_timing.py --sweep` timed
# (N = 1, 4, 16, ..., 2048, 4096, 6144, 8192, 10000, 16384 at W = 64; 1,
# 16, ..., 8192, 16384, ..., 262144 at W = 8; H3 1, 16, 256, 1024, 2048,
# 4096, 8192, 10000, 16384 at W = 64 (both windows) and 1, 4, ..., 4096 at
# W = 8; H4 1, 6, 16, 64, 256, 1024, 2048, 4096, 10000 at W = 64 (2047-
# and 256-bit exponents) and 1, 16, 256, 1024, 4096, 10000 at W = 8; H5
# 256, 1024, 4096, 8192, 16384, ..., 262144 points; H8 1, 128, 1024, 4096,
# 16384, 131072 pairs) from which the fewer lanes were faster at every N
# it timed; the crossover lies between it and the N timed before it
# (PERF.md §6).  H1 at W = 8 was fastest at TPI 8 at every N, H3 at W = 8
# at TPI 4, H5 at TPI 8 at none, H4 at TPI 32 and H8 at TPI 1 at none.
# H4's crossover at W = 64 moves with the exponent width: at 256 elements
# TPI 8 won at 2047 bits and TPI 16 at 256 bits, so the rule, keyed on N
# alone, may pick the slower TPI for wide exponents at 256 <= N < 1024;
# no call of the modp2048 path falls there (N = 1, 6, 16, 10000).
# The EC combine is one point (n = 1) on one warp, TPI 8 the fastest at
# 16 and 64 positions.  At W = 96 and 128 (modp3072, modp4096) every
# kernel was timed at N = 1, 4 (H1, H2) or 6 (H4), 16, 64 (not H3), 256,
# 1024, 2048 (not H4), 4096, 8192 (not H4), 10000, with full-width and
# 256-bit exponents for H4, at TPI 8, 16, 32 (H1, H2), 16, 32 (H3, H4):
# H1 at W = 96 crosses to TPI 16 between 1024 and 2048, at W = 128 TPI 32
# was fastest at every N but 8192 (by 1 %); H2 crosses to TPI 16 between
# 256 and 1024 (W = 96) and between 1024 and 2048 (W = 128); TPI 8 won
# neither at every N past a crossover (H2 at W = 96: at 4096 and 8192,
# not at 10000), so it is not built there.  H3 at TPI 32 was the faster at
# 10000 at both widths, TPI 16 from 2048 to 8192: at 10000 TPI 16 takes
# two waves of 1024-thread blocks (one block an SM, its staged digits
# holding the shared memory), 2·24.2 ms at W = 96 against 24.2 at 8192;
# H4 at TPI 16 at every N and both exponent widths.  At W = 12 (the
# P-384 field and ring; H1 and H2 over 1, 16, 256, ..., 262144 elements at
# TPI 1, 2, 4 and 384-bit exponents, H5 over 256 to 262144 points and H8
# over 1 to 131072 pairs at TPI 2 and 4): H1 at TPI 4 was fastest at every
# N but 262144 (by 2 %); H2 crosses to TPI 2 between 4096 and 8192 and to
# TPI 1 between 16384 and 32768; H5 and H8 at TPI 4 at every N (H5 at TPI
# 2 keeps a 144 KB table a block, one block an SM; at 2^17 151.5 against
# 103.1 ms), so TPI 1 and 2 of H1, H5 and H8 are not built there.  At
# W' = 20 (P-521's inner width; H1 and H2 over 1, 16, 256, ..., 262144
# elements at TPI 1, 2, 4 and 521-bit exponents, H5 over 256 to 262144
# points at TPI 4, H8 over 1 to 131072 pairs at TPI 2 and 4): H1 and H8
# at TPI 4 at every N; H2 crosses to TPI 2 between 8192 and 16384 (TPI 4
# won again at 262144, by 0.6 %), TPI 1 at no N; H5 at TPI 2 would need a
# 246 KB table a block.  So H1, H5 and H8 are built at TPI 4 alone there,
# H2 at 2 and 4.  At W = 32 (a 1024- or 1000-bit group, built on demand;
# `kernel_timing.py --sweep --widths 32` on Oakley's 1024-bit group at
# W = 64's N grids and at TPI 8, 16 and 32, H3 at both windows, H4 at
# 1023- and 256-bit exponents; NVIDIA H100 80GB HBM3, 700 W): H1 and H2
# at TPI 16 up to 1024 elements, TPI 8 from 2048 (TPI 32 at no N); H4 at
# TPI 8 at every N and both exponent widths; H3⟨8⟩ at TPI 16 up to 2048
# but for 256 (TPI 32 by 11 %), TPI 8 from 4096 (at 10000 2.215 against
# 4.498 ms: TPI 16's 1024-thread blocks take two waves); H3⟨4⟩ at TPI 8
# from 2048 already (by 9 % there), so one rule for both windows costs
# it that at 2048-4095.  At W = 96 and 128 H3⟨4⟩ (256-bit exponents, the
# same sweep, `--widths 96 128 --only mont_fb_exp`) keeps the window-8
# rule, TPI 32: it was the faster at N <= 256 and at the 10000 a path
# gives (4.823 / 7.000 ms against 4.907 / 8.384 at TPI 16), TPI 16 from
# 1024 to 8192 (by up to 24 %), an N no path sends at those widths.
# At W = 192 and 256 (RFC 3526's modp6144 and modp8192, built on demand;
# `kernel_timing.py --sweep --widths 192 256`, each N of 1 to 10000 and
# full-width and 256-bit exponents, 3 runs a time; NVIDIA H100 80GB HBM3,
# 700 W): H3 and H4 are built at TPI 32 alone (6 and 8 words a lane;
# TPI 16's 12 and 16 would pass the 64 registers of their 1024-thread
# blocks); H1 and H2 were swept at TPI 16 too (ptxas: 67 / 72 registers
# at W = 192, 84 / 93 at 256, no spill).  H1 at W = 192 crosses to TPI 16
# between 2048 and 4096 (0.1822 against 0.1888 ms at 10000), at W = 256
# TPI 32 was faster at every N (0.3267 against 0.3312 at 10000); H2 at
# TPI 32 at every N at both widths (1334.9 / 3082.2 ms against 1442.7 /
# 3821.9 at 10000, 89.1 / 198.1 against 159.5 / 366.7 on one).
# Every other width of `kernel_words` takes the nearest rule at or above
# it (`coop_rule`).
COOP_TPI = {
    ("mont_mul", 8): ((1, 8),),
    ("mont_mul", 64): ((4096, 8), (1, 32)),
    ("mont_exp", 8): ((16384, 1), (1, 8)),
    ("mont_exp", 64): ((2048, 8), (1, 32)),
    ("mont_fb_exp", 8): ((1, 4),),
    ("mont_fb_exp", 64): ((4096, 8), (1024, 16), (1, 32)),
    ("mont_expprod_positions", 8): ((4096, 1), (1, 4)),
    ("mont_expprod_positions", 64): ((1024, 8), (1, 16)),
    ("mont_mul", 96): ((2048, 16), (1, 32)),
    ("mont_mul", 128): ((1, 32),),
    ("mont_exp", 96): ((1024, 16), (1, 32)),
    ("mont_exp", 128): ((2048, 16), (1, 32)),
    ("mont_fb_exp", 96): ((1, 32),),
    ("mont_fb_exp", 128): ((1, 32),),
    ("mont_expprod_positions", 96): ((1, 16),),
    ("mont_expprod_positions", 128): ((1, 16),),
    ("mont_mul", 32): ((2048, 8), (1, 16)),
    ("mont_exp", 32): ((2048, 8), (1, 16)),
    ("mont_fb_exp", 32): ((4096, 8), (1, 16)),
    ("mont_expprod_positions", 32): ((1, 8),),
    ("mont_mul", 192): ((4096, 16), (1, 32)),
    ("mont_exp", 192): ((1, 32),),
    ("mont_fb_exp", 192): ((1, 32),),
    ("mont_expprod_positions", 192): ((1, 32),),
    ("mont_mul", 256): ((1, 32),),
    ("mont_exp", 256): ((1, 32),),
    ("mont_fb_exp", 256): ((1, 32),),
    ("mont_expprod_positions", 256): ((1, 32),),
    ("mont_mul", 480): ((1, 32),),
    ("mont_exp", 480): ((1, 32),),
    ("mont_fb_exp", 480): ((1, 32),),
    ("mont_expprod_positions", 480): ((1, 32),),
    ("mont_mul", 512): ((1, 32),),
    ("mont_exp", 512): ((1, 32),),
    ("mont_fb_exp", 512): ((1, 32),),
    ("mont_expprod_positions", 512): ((1, 32),),
    ("ec_scalar_mul", 8): ((16384, 2), (1, 4)),
    ("ec_multiexp_combine", 8): ((1, 8),),
    ("ec_point_add", 8): ((16384, 2), (4096, 4), (1, 8)),
    ("mont_mul", 12): ((1, 4),),
    ("mont_exp", 12): ((32768, 1), (8192, 2), (1, 4)),
    ("ec_scalar_mul", 12): ((1, 4),),
    ("ec_multiexp_combine", 12): ((1, 4),),
    ("ec_point_add", 12): ((1, 4),),
    ("mont_mul", 20): ((1, 4),),
    ("mont_exp", 20): ((16384, 2), (1, 4)),
    ("ec_scalar_mul", 20): ((1, 4),),
    ("ec_multiexp_combine", 20): ((1, 4),),
    ("ec_point_add", 20): ((1, 4),),
}
COOP_BLOCK = 128  # threads a block at most (kThreads in mont_kernels.cu)
# The Montgomery kernels whose TPI a width without a measured rule takes
# from another width's (`coop_rule`), and the bit mask of its TPIs that a
# width's library is built with (csrc/mont_kernels.cu, VMN_W).
COOP_MONT = {"mont_mul": "VMN_MUL_TPIS", "mont_exp": "VMN_EXP_TPIS",
             "mont_fb_exp": "VMN_FB_TPIS",
             "mont_expprod_positions": "VMN_EP_TPIS"}


def coop_rule(kernel: str, w: int) -> tuple:
    """The (from n elements, TPI) pairs of a cooperative kernel at W
    words: COOP_TPI's where it has one; for a Montgomery kernel at a
    width it lacks (one built on demand), the rule of the nearest width
    at or above W that has one, each TPI t taken down to the largest
    power of two dividing W where t does not (TPI must divide W; with
    kernel_words' rounding that keeps 8 or 16 lanes), equal neighbours
    merged.  A launch shape, the same kernel; raises where neither is
    there."""
    if (kernel, w) in COOP_TPI:
        return COOP_TPI[kernel, w]
    above = sorted(v for k, v in COOP_TPI if k == kernel and v >= w)
    if kernel not in COOP_MONT or not above:
        raise ValueError(f"{kernel}: no kernel instantiated for W={w}")
    top = min(w & -w, 32)
    rule = []
    for lo, t in COOP_TPI[kernel, above[0]]:
        t = min(t, top)
        if rule and rule[-1][1] == t:
            rule[-1] = (lo, t)
        else:
            rule.append((lo, t))
    return tuple(rule)


def threads_per_element(kernel: str, w: int, n: int) -> int:
    """A cooperative kernel's TPI for n >= 1 elements of W words
    (`coop_rule`); raises where no rule (and so no kernel) is built."""
    return next(t for lo, t in coop_rule(kernel, w) if n >= lo)


def coop_launch(kernel: str, w: int, n: int):
    """(TPI, threads a block, blocks) of a cooperative launch over n >= 1
    elements of W words: whole warps, at most COOP_BLOCK threads a block,
    every element's TPI lanes in one block."""
    tpi = threads_per_element(kernel, w, n)
    need = n * tpi
    threads = min(COOP_BLOCK, -(-need // 32) * 32)
    return tpi, threads, -(-need // threads)


FB_BLOCK = 1024  # H3's threads a block at most to 256 words (kFbBlock)
WIDE_BLOCK = 512  # H3's and H4's above 256 words (kWideBlock)
# The 227 KB of shared memory a block may opt in to (kFbShared): H3 stages
# a digit's entries twice within it, or a share of them where two digits
# do not fit (`fb_pieces`).
FB_SHARED = 232448


def fb_pieces(w: int, window: int) -> int:
    """The pieces H3 stages a digit of 2^window entries of W words in
    (fb_pieces in csrc/mont_kernels.cu): the smallest power of two P for
    which two buffers of 1/P of a digit fit FB_SHARED.  Window 8: 1 up to
    W = 96, 2 at W = 128 and 192, 4 at W = 256, 8 at W = 480 and 512."""
    p = 1
    while 2 * 4 * (1 << window) * w // p > FB_SHARED:
        p *= 2
    return p


def block_cap(w: int) -> int:
    """H3's and H4's threads a block at most at W words (block_cap in
    csrc/mont_coop.cuh, which bounds their __launch_bounds__ too):
    FB_BLOCK up to 256 words, WIDE_BLOCK above, so that a thread may hold
    128 registers where TPI 32 leaves a lane 15 or 16 words."""
    return FB_BLOCK if w <= 256 else WIDE_BLOCK


def fb_launch(w: int, n: int, sms: int):
    """(TPI, threads a block, blocks) of H3 over n >= 1 elements of W
    words on a card of `sms` SMs.  H3's block holds one digit's staged
    entries twice (128 KB at window 8, W = 64), so one block fills an SM:
    a block takes about n/sms elements (whole warps, at most
    `block_cap(w)` threads), so that the blocks fill every SM once, as far
    as that cap allows, and no last wave is thin."""
    tpi = threads_per_element("mont_fb_exp", w, n)
    per_block = -(-n // sms)
    threads = min(block_cap(w), -(-per_block * tpi // 32) * 32)
    return tpi, threads, -(-n * tpi // threads)


EP_SHARED = FB_SHARED  # the shared memory an H4 block may use
EP_ACC_BYTES = 64 * 1024  # of which the accumulators take at most this
# Elements an H4 block, or a share of one, takes at least where N allows.
# A compromise (`kernel_timing.py --sweep --only ep_shape`, PERF.md §6):
# fewer speed few elements with many positions, more speed N = 10000.
EP_MIN_ELEMENTS = 16


@dataclass(frozen=True)
class EpLaunch:
    """An H4 launch (csrc/mont_kernels.cu): `pblocks` blocks of `jb` digit
    positions times `eblocks` blocks of `per_block` elements (the last may
    hold fewer), each block `threads` threads (groups of `tpi` lanes),
    folding `subs` shares of its elements into each position, in chunks
    of at most `chunk` elements whose tables fit its shared memory."""

    tpi: int
    threads: int
    jb: int
    subs: int
    per_block: int
    chunk: int
    eblocks: int
    pblocks: int

    @property
    def parts(self) -> int:
        """Partial products a position: one a (element block, share)."""
        return self.eblocks * self.subs

    def shared_bytes(self, w: int) -> int:
        """The chunk's tables (16 entries and 4 words of padding an
        element) and the accumulators."""
        return 4 * (self.chunk * (16 * w + 4) + self.jb * self.subs * w)


def ep_launch(w: int, n: int, npos: int, sms: int) -> EpLaunch:
    """H4's launch over n >= 1 elements of W words and npos digit
    positions (a multiple of EP_JB) on a card of `sms` SMs; TPI from
    COOP_TPI.  Positions go to blocks of jb, the largest
    multiple of EP_JB dividing npos whose accumulators fit EP_ACC_BYTES;
    the elements to about sms / pblocks blocks of at least
    EP_MIN_ELEMENTS elements.  While that leaves SMs without a block (a
    few elements with many positions), jb takes the next such size down.
    Within a block, the groups hold jb·subs items (subs shares of at
    least EP_MIN_ELEMENTS elements), at most `block_cap(w)` / tpi a
    round."""
    tpi = threads_per_element("mont_expprod_positions", w, n)
    gmax = block_cap(w) // tpi
    cap = EP_ACC_BYTES // (4 * w)  # accumulators a block may hold
    for jb in range(min(npos, cap) // EP_JB * EP_JB, 0, -EP_JB):
        if npos % jb:
            continue
        pblocks = npos // jb
        eblocks = max(1, min(-(-sms // pblocks), n // EP_MIN_ELEMENTS))
        if pblocks * eblocks >= sms:
            break
    per_block = -(-n // eblocks)
    eblocks = -(-n // per_block)  # no block without elements
    subs = max(1, min(gmax // jb, per_block // EP_MIN_ELEMENTS, cap // jb))
    items = jb * subs
    rounds = -(-items // gmax)
    threads = -(-(-(-items // rounds) * tpi) // 32) * 32
    most = (EP_SHARED - 4 * w * items) // (4 * (16 * w + 4))  # a chunk
    chunk = -(-per_block // -(-per_block // most))
    return EpLaunch(tpi, threads, jb, subs, per_block, chunk, eblocks,
                    pblocks)


def slice_vec(s: int) -> int:
    """Words a lane of H3 or H4 moves at once from its S-word slice in
    shared memory: the widest of 4, 2, 1 dividing S (slice_vec in csrc/
    mont_kernels.cu)."""
    return 4 if s % 4 == 0 else 2 if s % 2 == 0 else 1


def fb_pack(table: torch.Tensor, tpi: int) -> torch.Tensor:
    """H3's copy of a fixed-base table (ndig, 2^w, 2W) int32 limbs: per
    entry W packed 32-bit words, word k of lane r's slice (S = W/TPI
    words) at [k // V][r][k % V], V = slice_vec(S), so that a group's
    lanes read their slices as vectors of consecutive words (csrc/
    mont_kernels.cu, H3)."""
    ndig, entries, L = table.shape
    w = L // 2  # the kernel's words (a padded table at a padded modulus)
    s = w // tpi
    v = slice_vec(s)
    t = table.to(torch.int64)
    words = t[..., 0::2] | (t[..., 1::2] << LIMB_BITS)  # below 2^32
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    words = words.to(torch.int32).reshape(ndig, entries, tpi, s // v, v)
    return words.transpose(2, 3).contiguous()

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: dict = {}
# The width libraries loaded (W: library) and, per entry point and
# (W, TPI, window), the library that holds it.
_width_libs: dict = {}
_route: dict = {}


def _nvcc() -> str:
    cuda = Path("/usr/local/cuda/bin/nvcc")
    return str(cuda) if cuda.exists() else (shutil.which("nvcc") or "nvcc")


def _sources() -> list:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _source_hash(*extra: str):
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *extra)).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def width_tpis(w: int) -> dict:
    """{kernel: TPIs} a width's library holds: those of each Montgomery
    kernel's rule at W (`coop_rule`)."""
    return {k: tuple(sorted({t for _, t in coop_rule(k, w)}))
            for k in COOP_MONT}


def _width_flags(w: int, tpis: dict) -> tuple:
    """nvcc's defines for the library of width w holding `tpis`: VMN_W
    and, per kernel, the bit mask of its TPIs (bit t for TPI t; 0: the
    kernel is not built)."""
    masks = {COOP_MONT[k]: sum(set(tpis.get(k, ()))) for k in COOP_MONT}
    return (f"-DVMN_W={w}",
            *(f"-D{name}={mask}" for name, mask in sorted(masks.items())))


@dataclass
class _Job:
    """One `nvcc -c` of a library's source, its object and log."""

    so: Path
    tmp: Path
    obj: Path
    log: Path
    proc: subprocess.Popen
    done_s: Optional[float] = None


def _compile(libs: list) -> None:
    """Build each (library path, [(source, extra nvcc flags)]) that does
    not exist yet: one `nvcc -c` per source, all of every library started
    together, then one link each.  A temporary name per process and
    os.replace, so that concurrent builders do not collide.  Records each
    library's seconds (its last object's and its link) and ptxas's
    register/spill report beside it (`*.ptxas.txt`); raises with nvcc's
    log where a build fails."""
    t0 = time.perf_counter()
    jobs = []
    for so, units in libs:
        if so.exists():
            continue
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        for src, flags in units:
            obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
            log = obj.with_suffix(".log")
            with open(log, "w") as out:
                proc = subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, *flags, "-c", "-o", str(obj),
                     str(src)], stdout=out, stderr=subprocess.STDOUT)
            jobs.append(_Job(so, tmp, obj, log, proc))
    while any(j.done_s is None for j in jobs):
        for j in jobs:
            if j.done_s is None and j.proc.poll() is not None:
                j.done_s = time.perf_counter() - t0
        time.sleep(0.05)
    for so, _ in libs:
        mine = [j for j in jobs if j.so == so]
        if not mine:
            continue
        log = "".join(j.log.read_text() for j in mine)
        if any(j.proc.returncode != 0 for j in mine):
            raise RuntimeError(f"nvcc failed for {so.name}:\n{log}")
        res = subprocess.run([_nvcc(), *_ARCH, "-shared", "-o",
                              str(mine[0].tmp), *(str(j.obj) for j in mine)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({res.returncode}):\n{res.stdout}{res.stderr}"
            )
        for j in mine:
            j.obj.unlink()
            j.log.unlink()
        so.with_suffix(".ptxas.txt").write_text(log)
        os.replace(mine[0].tmp, so)
        BUILD_INFO.setdefault("compiled", {})[so.name] = (
            max(j.done_s for j in mine), time.perf_counter() - t0)


def _info(so: Path, seconds: float) -> dict:
    report = so.with_suffix(".ptxas.txt")
    return {"path": str(so), "seconds": seconds,
            "ptxas": report.read_text() if report.exists() else ""}


def _main_unit() -> tuple:
    so = _BUILD / f"libvmn_mont_{_source_hash()}.so"
    return so, [(s, ()) for s in _sources() if s.suffix == ".cu"]


def _width_unit(w: int, tpis: dict) -> tuple:
    flags = _width_flags(w, tpis)
    so = _BUILD / f"libvmn_mont_w{w}_{_source_hash(*flags)}.so"
    return so, [(_CSRC / "mont_kernels.cu", flags)]


def build_kernels(widths=()) -> Path:
    """Compile csrc/ with nvcc into one shared library in _build/ (cached
    by a hash of the sources and flags) and return its path: one `nvcc -c`
    per `.cu` file, then one link; with `widths`, the libraries of those
    widths too (`build_widths`), every nvcc of both started together.
    Records the build seconds and ptxas's register/spill report in
    BUILD_INFO (the widths' under BUILD_INFO["widths"][w])."""
    t0 = time.perf_counter()
    main = _main_unit()
    specs = {w: _width_unit(w, width_tpis(w)) for w in widths}
    _compile([main, *specs.values()])
    seconds = time.perf_counter() - t0
    BUILD_INFO.update(_info(main[0], seconds))
    for w, (so, _) in specs.items():
        BUILD_INFO.setdefault("widths", {})[w] = _info(so, seconds)
    return main[0]


def build_widths(widths, tpis: Optional[dict] = None) -> dict:
    """{W: path} of the library of each width in `widths`: every
    Montgomery entry point at W alone (mont_kernels.cu with -DVMN_W=w),
    each kernel at the TPIs of its rule (`width_tpis`, or {kernel: TPIs}
    `tpis`), the chain at its one TPI; one nvcc per width, all started
    together, cached by a hash of the sources, the flags and the width."""
    t0 = time.perf_counter()
    specs = {w: _width_unit(w, width_tpis(w) if tpis is None else tpis)
             for w in widths}
    _compile(list(specs.values()))
    seconds = time.perf_counter() - t0
    for w, (so, _) in specs.items():
        BUILD_INFO.setdefault("widths", {})[w] = _info(so, seconds)
    return {w: so for w, (so, _) in specs.items()}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I64, I32, U32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_uint32)
    sig = {
        "vmn_mont_mul": [I32, I32, P, P, P, P, U32, P, I64, I32, I64, P],
        "vmn_mont_exp": [I32, I32, P, P, P, P, P, U32, P, P, I64, I32, I32,
                         I32, I64, P],
        "vmn_mont_chain": [I32, P, P, P, U32, P, P, I32, P],
        "vmn_mont_fb_exp": [I32, I32, I32, P, P, P, P, P, P, U32, P, P,
                            I64, I32, I32, I32, I64, P],
        "vmn_mont_expprod": [I32, I32, P, P, P, P, P, P, U32, P, P, I64,
                             I32, I32, I32, I64, I32, I32, I32, I32, P],
    }
    for name, args in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build_kernels())))
    return _lib


def width_library(w: int, tpis: Optional[dict] = None) -> ctypes.CDLL:
    """The library of width w, built at its first use (`build_widths`);
    with `tpis`, that build in place of the rule's (a sweep of other
    TPIs), which the wrappers then use at w."""
    with _lib_lock:
        if tpis is not None or w not in _width_libs:
            so = build_widths([w], tpis)[w]
            _width_libs[w] = _bind(ctypes.CDLL(str(so)))
            for key in [k for k in _route if k[1] == w]:
                del _route[key]
        return _width_libs[w]


def _launch(entry: str, key: tuple, *args) -> int:
    """entry(*args) of the library that holds (W, TPI, window) `key`: the
    main one where its switch has the case, else the width's own, built
    at its first use.  An entry point with no case returns
    kUnsupportedWidth before it launches anything."""
    lib = _route.get((entry, *key))
    if lib is not None:
        return getattr(lib, entry)(*args)
    for get in (_library, lambda: width_library(key[0])):
        lib = get()
        rc = getattr(lib, entry)(*args)
        if rc != _UNSUPPORTED_WIDTH:
            if rc == 0:
                _route[(entry, *key)] = lib
            return rc
    return rc


def _check(fn: str, rc: int, w: Optional[int] = None) -> None:
    if rc == _UNSUPPORTED_WIDTH:
        raise ValueError(f"{fn}: no kernel instantiated for this width"
                         + ("" if w is None else f" (W={w})"))
    if rc == _BAD_SHAPE:
        raise ValueError(f"{fn}: launch shape refused by the kernel")
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} at launch")


# The wrappers whose kernels convert at the boundary of a padded modulus
# (Modulus.conv): every Montgomery wrapper, and every EC one but H7
# (ec_fb_exp, off every path), which raises there.
CONVERTS = frozenset({*KERNELS, "ec_scalar_mul", "ec_multiexp_positions",
                      "ec_multiexp_combine", "ec_point_add"})


def _words(mod: Modulus, kernel: str, widths=None) -> int:
    """The words `kernel` computes mod at (Modulus.W, `kernel_words`):
    any width of a Montgomery kernel (one outside _WIDTHS is built at
    its first use), one of `widths` (the EC kernels' instantiated ones)
    where given; raises ValueError, naming the width, where none is
    built."""
    if widths is not None and mod.W not in widths:
        raise ValueError(f"{kernel}: no kernel instantiated for L={mod.L} "
                         f"(W={mod.W})")
    if mod.conv and kernel not in CONVERTS:
        raise ValueError(f"{kernel}: no kernel for L={mod.L} at its inner "
                         f"width W={mod.W}")
    return mod.W


def _padded(x: torch.Tensor, mod: Modulus) -> torch.Tensor:
    """(..., L) operand -> (..., 2W): zero limbs above the value (conv)."""
    if not mod.conv:
        return x
    return torch.constant_pad_nd(x, (0, 2 * mod.W - mod.L))


def _unpadded(out: torch.Tensor, mod: Modulus) -> torch.Tensor:
    """(..., 2W) result -> (..., L): the limbs below R (the rest are 0)."""
    return out[..., : mod.L].contiguous() if mod.conv else out


def _conv_ptrs(mod: Modulus):
    """(c_in, c_out) pointers of a padded modulus; NULL (None) where the
    kernels compute at the limbs' own radix."""
    if not mod.conv:
        return None, None
    return _ptr(mod.c_in), _ptr(mod.c_out)


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _rows(x: torch.Tensor, name: str, device, n: int, cols: int = 0
          ) -> torch.Tensor:
    """x as the row-major (n, cols) int32 operand of a cooperative kernel
    (any cols >= 1 where cols is 0), 8-byte aligned for its paired-limb
    loads."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if (x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != n
            or x.shape[1] < 1 or (cols and x.shape[1] != cols)):
        raise ValueError(
            f"{name}: expected int32 (N={n}, {cols or 'limbs'}), got "
            f"{x.dtype} {tuple(x.shape)}"
        )
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 8 else x


def on_host(name: str, mod: Modulus, *operands) -> bool:
    """Whether a wrapper takes its plain version: the modulus and every
    operand on the CPU.  An operand on another device than the modulus
    raises, so that a host tensor handed to a wrapper on the card is
    never computed by the plain version on the host."""
    dev = mod.limbs.device
    for t in operands:
        if t.device != dev:
            raise ValueError(
                f"{name}: an operand is on {t.device}, the modulus on {dev}")
    return dev.type == "cpu"


def mont_mul(a: torch.Tensor, b: torch.Tensor, mod: Modulus) -> torch.Tensor:
    """H1: batched Montgomery product, (N, L) x (N, L) -> (N, L).  At a
    padded modulus the kernel computes a·b·R'^-1, then one more product
    with c_in = R'^2/R gives a·b·R^-1."""
    if on_host("mont_mul", mod, a, b):
        return mont_mul_plain(a, b, mod)
    N, L = a.shape[0], mod.L
    w = _words(mod, "mont_mul")
    dev = mod.limbs.device
    a = _padded(_rows(a, "a", dev, N, L), mod)
    b = _padded(_rows(b, "b", dev, N, L), mod)
    out = torch.empty((N, 2 * w), dtype=torch.int32, device=dev)
    if N:
        t, threads, blocks = coop_launch("mont_mul", w, N)
        _check("mont_mul", _launch(
            "vmn_mont_mul", (w, t, None), w, t, _ptr(a), _ptr(b),
            _ptr(out), _ptr(mod.kernel_limbs), mod.mprime32,
            _conv_ptrs(mod)[0], N, threads, blocks, _stream(dev)), w)
        _launched("mont_mul", N, mod)
    return _unpadded(out, mod)


def mont_exp(base: torch.Tensor, e: torch.Tensor, mod: Modulus, nbits: int
             ) -> torch.Tensor:
    """H2: base^e per element; base (N, L) Montgomery form, e (N, Le)
    standard limbs below 2^nbits."""
    if on_host("mont_exp", mod, base, e):
        return mont_exp_plain(base, e, mod, nbits)
    N, L = base.shape[0], mod.L
    w = _words(mod, "mont_exp")
    dev = mod.limbs.device
    base = _padded(_rows(base, "base", dev, N, L), mod)
    e = _rows(e, "e", dev, N)
    ndig = max(1, -(-nbits // WINDOW))
    out = torch.empty((N, 2 * w), dtype=torch.int32, device=dev)
    if N:
        t, threads, blocks = coop_launch("mont_exp", w, N)
        _check("mont_exp", _launch(
            "vmn_mont_exp", (w, t, None), w, t, _ptr(base), _ptr(e),
            _ptr(out), _ptr(mod.kernel_limbs), _ptr(mod.kernel_one),
            mod.mprime32, *_conv_ptrs(mod), N, e.shape[1], ndig, threads,
            blocks, _stream(dev)), w)
        _launched("mont_exp", N, mod)
    return _unpadded(out, mod)


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def mont_fb_exp(table: torch.Tensor, e: torch.Tensor, mod: Modulus
                ) -> torch.Tensor:
    """H3: prod_j table[j][digit_j(e)]; table (ndig, 2^w, L) Montgomery
    form with w in {4, 8}, e (N, Le) standard limbs.  At a padded
    modulus the kernel's entry point first takes the packed table's
    entries to R' in a launch of their own (one product an entry, into
    `conv`), and the result back to R on store."""
    if on_host("mont_fb_exp", mod, table, e):
        return mont_fb_exp_plain(table, e, mod)
    ndig, entries, L = table.shape
    window = entries.bit_length() - 1
    if entries != 1 << window or window not in (4, 8) or L != mod.L:
        raise ValueError(f"bad fixed-base table shape {tuple(table.shape)}")
    if table.dtype != torch.int32:
        raise ValueError("table must be int32")
    dev = mod.limbs.device
    if table.device != dev:
        raise ValueError(f"table is on {table.device}")
    w = _words(mod, "mont_fb_exp")
    N = e.shape[0]
    e = _rows(e, "e", dev, N)
    out = torch.empty((N, 2 * w), dtype=torch.int32, device=dev)
    if N:
        t, threads, blocks = fb_launch(w, N, _sms(dev))
        packed = fb_pack(_padded(table, mod), t)
        conv = torch.empty_like(packed) if mod.conv else None
        _check("mont_fb_exp", _launch(
            "vmn_mont_fb_exp", (w, t, window), w, window, t, _ptr(packed),
            None if conv is None else _ptr(conv), _ptr(e), _ptr(out),
            _ptr(mod.kernel_limbs), _ptr(mod.kernel_one), mod.mprime32,
            *_conv_ptrs(mod), N, e.shape[1], ndig, threads, blocks,
            _stream(dev)), w)
        _launched("mont_fb_exp", N, mod)
    return _unpadded(out, mod)


def mont_expprod_positions(bases: torch.Tensor, e: torch.Tensor,
                           mod: Modulus, nbits: int) -> torch.Tensor:
    """H4: per-digit-position products P_j = prod_i bases_i^(d_ij),
    (ndig_pad, L) Montgomery form (see mont_expprod_positions_plain): one
    launch gives `ep_launch(..).parts` partials a position, an H1 lane
    tree multiplies them.  At a padded modulus the entry point takes the
    bases to R' before the launch (into `conv`) and the partials back
    after it."""
    if on_host("mont_expprod_positions", mod, bases, e):
        return mont_expprod_positions_plain(bases, e, mod, nbits)
    N, L = bases.shape[0], mod.L
    w = _words(mod, "mont_expprod_positions")
    dev = mod.limbs.device
    bases = _padded(_rows(bases, "bases", dev, N, L), mod)
    e = _rows(e, "e", dev, N)  # digits past its limbs read as zero
    ndig_pad = _ndig_pad(nbits)
    if not N:
        return mod.one_mont.expand(ndig_pad, L).contiguous()
    sh = ep_launch(w, N, ndig_pad, _sms(dev))
    out = torch.empty((ndig_pad, sh.parts, 2 * w), dtype=torch.int32,
                      device=dev)
    conv = torch.empty_like(bases) if mod.conv else None
    _check("mont_expprod_positions", _launch(
        "vmn_mont_expprod", (w, sh.tpi, None), w, sh.tpi, _ptr(bases),
        None if conv is None else _ptr(conv), _ptr(e), _ptr(out),
        _ptr(mod.kernel_limbs), _ptr(mod.kernel_one),
        mod.mprime32, *_conv_ptrs(mod), N, e.shape[1], sh.jb, sh.subs,
        sh.per_block, sh.chunk, sh.threads, sh.eblocks, sh.pblocks,
        _stream(dev)), w)
    _launched("mont_expprod_positions", N, mod)
    return _lane_tree(_unpadded(out, mod), mod, mont_mul)


def mont_expprod_combine(P: torch.Tensor, mod: Modulus) -> torch.Tensor:
    """K7's combine prod_j P_j^(2^(4j)) of (J, L) Montgomery-form
    positions -> (L,), as one chain on one warp.  At a padded modulus the
    chain takes each P_j to R' (the product beside the first squaring of
    its step) and the result back to R."""
    if on_host("mont_expprod_combine", mod, P):
        return mont_expprod_combine_plain(P, mod)
    J, L = P.shape[0], mod.L
    w = _words(mod, "mont_expprod_combine")
    dev = mod.limbs.device
    if J == 0:
        return mod.one_mont.clone()
    P = _padded(_rows(P, "P", dev, J, L), mod)
    out = torch.empty((1, 2 * w), dtype=torch.int32, device=dev)
    _check("mont_expprod_combine", _launch(
        "vmn_mont_chain", (w, None, None), w, _ptr(P), _ptr(out),
        _ptr(mod.kernel_limbs), mod.mprime32, *_conv_ptrs(mod), J,
        _stream(dev)), w)
    _launched("mont_expprod_combine", J, mod)
    return _unpadded(out, mod)[0]


def mont_expprod(bases: torch.Tensor, e: torch.Tensor, mod: Modulus,
                 nbits: int) -> torch.Tensor:
    """prod_i bases_i^(e_i) -> (L,) Montgomery form (K7): H4's positions,
    then their combine."""
    return mont_expprod_combine(
        mont_expprod_positions(bases, e, mod, nbits), mod)

"""Batched Montgomery kernels: Hopper CUDA wrappers and plain PyTorch
versions (port of `vmn_tpu.ops.mont_kernels`).

Every operation of a ModP group, and the field products and powers of an
EC group, reduce to these five functions (point arithmetic is
ops/ec_kernels.py).  Each has three parts here:

* the wrapper (`mont_mul`, `mont_exp`, `mont_fb_exp`,
  `mont_expprod_positions`, plus `mont_expprod` on top of them).  A CPU
  tensor goes to the plain version; a CUDA tensor goes to the kernel in
  `csrc/mont_kernels.cu` or raises — there is no fallback;
* the plain PyTorch version (`*_plain`): exact integer arithmetic on
  int64 tensors with log-depth carry resolution, any algorithm that
  gives the same canonical limbs;
* a launch counter per wrapper (`LAUNCHES[name]`), bumped only where the
  wrapper launches its kernel.

Arrays at this boundary are ``(N, L)`` int32 tensors of 16-bit limbs
(arith/limbs.py), Montgomery radix ``R = 2^(16·L)``.  The wrappers
transpose to the limb-major ``(L, N)`` layout the kernels read.

Kernel notes (what each replaces, what bounds it on an H100, what the
design does about it):

* H1 `mont_mul` replaces K2 `mont_mul_pallas`
  (vmn_tpu/ops/mont_kernels.py:182-216).  One thread per element, CIOS
  over 32-bit words with 64-bit accumulators.  Bound by integer
  multiply-add issue (2·W² 32-bit multiply-adds per product, W = L/2) and,
  at the slice's batch sizes, by launch count: the torch-level trees and
  scans and the K7 combine call it many times on small batches.
* H2 `mont_exp` replaces K3 `mont_exp_pallas` (:222-286, :753-795).
  16-entry table per thread in local memory, 4-bit fixed windows,
  constant-time masked select.  Bound by the ~5·nbits/4 products per
  element; the table's local-memory traffic is second.
* H3 `mont_fb_exp` (window 4 or 8) replaces K5 `mont_fb_exp_pallas`
  (:292-353, :486-527) and K4 `mont_fb8_exp_pallas` (:361-483); routed by
  exponent bits as vmn_tpu/arith/mont.py:1055 does.  A block stages one
  digit's table rows in shared memory (64 KB at window 8, 2048 bits, above
  the 48 KB default: the launcher raises the limit) and every thread
  masked-selects its factor.  The TPU's one-hot f32 MXU gather is not
  carried over.  At window 8 the masked select (2^8 · W words per digit)
  costs about as much as the product it feeds.
* H4 `mont_expprod_positions` replaces both `pallas_call`s of K6 (:552-727):
  launch 1 writes a 16-entry table per element to device memory, launch 2
  gives each thread one (lane, digit position) and loops over the lane's
  elements inside the kernel (the TPU's sequential grid axis), then an H1
  product tree multiplies the lanes.  Bound by products (one per element
  and position) plus 16·W table words read per product.
* K7 `mont_expprod_pallas` (:730-750) is `mont_expprod` here: H4, then the
  combine prod_j P_j^(2^(4j)) as 5·ndig_pad single-element H1 launches in
  sequence — a known launch-bound spot (PERF.md).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
WINDOW = 4  # variable-base and multi-exponentiation window
EP_JB = 16  # digit positions are padded to a multiple of this (as K6)
# Elements per H4 table build: the (16, W, n) word table is 4 KB per
# element at 2048 bits, so 2^20 elements cap it at 4 GiB of the 80 GB card
# (the TPU capped it at 512 MB of 16 GB HBM, _EP_SUPER).
EP_SUPER = 1 << 20
# Elements folded per H4 thread before the H1 lane tree takes over.
EP_PER_LANE = 8
EP_MAX_LANES = 2048

KERNELS = ("mont_mul", "mont_exp", "mont_fb_exp", "mont_expprod_positions")
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ constants


@dataclass(frozen=True)
class Modulus:
    """Device constants of one odd modulus, as every wrapper takes them."""

    m: int
    L: int
    limbs: torch.Tensor  # (L,) int32 limbs of m
    mprime32: int  # -m^-1 mod 2^32: the kernels' word-level m'
    mprime_limbs: torch.Tensor  # (L,) -m^-1 mod R: the plain REDC's m'
    one_mont: torch.Tensor  # (L,) R mod m

    @classmethod
    def of(cls, m: int, L: int, device) -> "Modulus":
        R = 1 << (LIMB_BITS * L)

        def limbs(x):
            return torch.tensor(
                [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(L)],
                dtype=torch.int32, device=device,
            )

        return cls(
            m=m,
            L=L,
            limbs=limbs(m),
            mprime32=(-pow(m, -1, 1 << 32)) & 0xFFFFFFFF,
            mprime_limbs=limbs((-pow(m, -1, R)) % R),
            one_mont=limbs(R % m),
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


def _resolve(t: torch.Tensor, width: int, passes: int = 3) -> torch.Tensor:
    """Lazy limbs -> canonical limbs of the value mod 2^(16·width).
    One split pass covers limbs < 2^17 + 2^16, three limbs < 2^40 and
    four limbs < 2^63."""
    if t.shape[-1] < width:
        t = torch.constant_pad_nd(t, (0, width - t.shape[-1]))
    elif t.shape[-1] > width:
        t = t[..., :width]
    for _ in range(passes):
        t = (t & LIMB_MASK) + _shift_up(t >> LIMB_BITS, 1)
    pos = torch.arange(width, device=t.device)
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


# Rows per plain-product chunk: bounds the (rows, L, 2L) int64 outer
# product at 2^26 entries (512 MB).
_PLAIN_ELEMS = 1 << 26


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor, mod: Modulus
                   ) -> torch.Tensor:
    """a·b·R^-1 mod m by REDC with the full-width m' (exact integers).

    T = a·b stays lazy (limb i at most (i+1)·(2^16-1)^2); q = T·m' mod R
    is resolved from it while q's lazy limbs, at most L(L+1)/2·(2^16-1)^3,
    stay below 2^63 (L <= 255), and from T's low half resolved first at
    wider L (modp4096: L = 256); U = T + q·m is resolved together with
    U + (2^(16(L+1)) - m)·R, whose carry out says whether U/R >= m."""
    L = mod.L
    lazy_q = L * (L + 1) // 2 * LIMB_MASK**3 < 1 << 63
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    a = a.reshape(-1, L).to(torch.int64)
    b = b.reshape(-1, L).to(torch.int64)
    m64 = mod.limbs.to(a.device, torch.int64)
    mp64 = mod.mprime_limbs.to(a.device, torch.int64)
    sub_m = torch.constant_pad_nd(_neg_m(m64, L + 1), (L, 0))  # ·R
    rows = max(1, _PLAIN_ELEMS // (2 * L * L))
    outs = []
    for s in range(0, a.shape[0], rows):
        T = _mul_lazy(a[s : s + rows], b[s : s + rows])
        T_lo = T[:, :L] if lazy_q else _resolve(T[:, :L], L)
        q = _resolve(_mul_lazy(T_lo, mp64)[:, :L], L, passes=4)
        U = torch.constant_pad_nd(T + _mul_lazy(q, m64)[:, : 2 * L], (0, 1))
        V = _resolve(torch.stack([U, U + sub_m]), 2 * L + 2)
        ge = V[1, :, 2 * L + 1 :] == 1
        outs.append(torch.where(ge, V[1, :, L : 2 * L], V[0, :, L : 2 * L]))
    out = torch.cat(outs) if outs else a[:0]
    return out.to(torch.int32).reshape(shape)


def add_mod(a: torch.Tensor, b: torch.Tensor, m: torch.Tensor
            ) -> torch.Tensor:
    """(a + b) mod m for canonical a, b < m (int32 limbs): a + b and
    a + b + 2^(16(L+1)) - m resolved together; the carry out of the
    second says a + b >= m."""
    a, b = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
    L = a.shape[-1]
    s = torch.constant_pad_nd(a + b, (0, 1))
    v = _resolve(torch.stack([s, s + _neg_m(m.to(a.device, torch.int64),
                                            L + 1)]), L + 2, passes=1)
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
    v = _resolve(torch.stack([d, d + m.to(a.device, torch.int64)]), L + 1,
                 passes=1)
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


# ---------------------------------------------------------- the kernels

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
_UNSUPPORTED_WIDTH = -1
_WIDTHS = (8, 64)  # W = L/2 instantiated in mont_kernels.cu

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: dict = {}


def _nvcc() -> str:
    cuda = Path("/usr/local/cuda/bin/nvcc")
    return str(cuda) if cuda.exists() else (shutil.which("nvcc") or "nvcc")


def build_kernels() -> Path:
    """Compile csrc/ with nvcc into one shared library in _build/ (cached
    by a hash of the sources and flags) and return its path: one `nvcc -c`
    per `.cu` file, all started together, then one link.  Records the
    build seconds and ptxas's register/spill report in BUILD_INFO."""
    sources = sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    so = _BUILD / f"libvmn_mont_{h.hexdigest()[:16]}.so"
    report = so.with_suffix(".ptxas.txt")
    t0 = time.perf_counter()
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        units = [s for s in sources if s.suffix == ".cu"]
        objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in units]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o),
                                   str(s)], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for s, o in zip(units, objs)]
        outs = [p.communicate() for p in procs]
        log = "".join(out + err for out, err in outs)
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        res = subprocess.run([_nvcc(), *_ARCH, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({res.returncode}):\n{res.stdout}{res.stderr}"
            )
        for o in objs:
            o.unlink()
        report.write_text(log)
        os.replace(tmp, so)
    BUILD_INFO.update(path=str(so), seconds=time.perf_counter() - t0,
                      ptxas=report.read_text() if report.exists() else "")
    return so


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_kernels()))
            P, I64, I32, U32 = (ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_int, ctypes.c_uint32)
            sig = {
                "vmn_mont_mul": [I32, P, P, P, P, U32, I64, P],
                "vmn_mont_exp": [I32, P, P, P, P, P, U32, I64, I32, I32, P],
                "vmn_mont_fb_exp": [I32, I32, P, P, P, P, P, U32, I64, I32,
                                    I32, P],
                "vmn_ep_table": [I32, P, P, P, P, U32, I64, P],
                "vmn_ep_acc": [I32, P, P, P, P, P, U32, I64, I32, I32, I32,
                               P],
            }
            for name, args in sig.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(fn: str, rc: int) -> None:
    if rc == _UNSUPPORTED_WIDTH:
        raise ValueError(f"{fn}: no kernel instantiated for this width")
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} at launch")


def _words(mod: Modulus) -> int:
    if mod.L % 2:
        raise ValueError(
            f"L={mod.L} is odd: the kernels pack limb pairs into 32-bit "
            "words and keep R = 2^(16·L) only for even L"
        )
    if mod.L // 2 not in _WIDTHS:
        raise ValueError(f"no kernel instantiated for L={mod.L}")
    return mod.L // 2


def _limb_major(x: torch.Tensor, name: str, device, cols: int
                ) -> torch.Tensor:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != cols:
        raise ValueError(
            f"{name}: expected int32 (N={cols}, limbs), got "
            f"{x.dtype} {tuple(x.shape)}"
        )
    return x.t().contiguous()


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def mont_mul(a: torch.Tensor, b: torch.Tensor, mod: Modulus) -> torch.Tensor:
    """H1: batched Montgomery product, (N, L) x (N, L) -> (N, L)."""
    if a.device.type == "cpu":
        return mont_mul_plain(a, b, mod)
    N, L = a.shape
    w = _words(mod)
    aT = _limb_major(a, "a", mod.limbs.device, N)
    bT = _limb_major(b, "b", mod.limbs.device, N)
    if b.shape != a.shape:
        raise ValueError(f"shape mismatch {tuple(a.shape)} {tuple(b.shape)}")
    out = torch.empty((L, N), dtype=torch.int32, device=a.device)
    if N:
        _check("mont_mul", _library().vmn_mont_mul(
            w, _ptr(aT), _ptr(bT), _ptr(out), _ptr(mod.limbs),
            mod.mprime32, N, _stream(a.device)))
        LAUNCHES["mont_mul"] += 1
    return out.t().contiguous()


def mont_exp(base: torch.Tensor, e: torch.Tensor, mod: Modulus, nbits: int
             ) -> torch.Tensor:
    """H2: base^e per element; base (N, L) Montgomery form, e (N, Le)
    standard limbs below 2^nbits."""
    if base.device.type == "cpu":
        return mont_exp_plain(base, e, mod, nbits)
    N, L = base.shape
    w = _words(mod)
    bT = _limb_major(base, "base", mod.limbs.device, N)
    eT = _limb_major(e, "e", mod.limbs.device, N)
    ndig = max(1, -(-nbits // WINDOW))
    out = torch.empty((L, N), dtype=torch.int32, device=base.device)
    if N:
        _check("mont_exp", _library().vmn_mont_exp(
            w, _ptr(bT), _ptr(eT), _ptr(out), _ptr(mod.limbs),
            _ptr(mod.one_mont), mod.mprime32, N, eT.shape[0], ndig,
            _stream(base.device)))
        LAUNCHES["mont_exp"] += 1
    return out.t().contiguous()


def mont_fb_exp(table: torch.Tensor, e: torch.Tensor, mod: Modulus
                ) -> torch.Tensor:
    """H3: prod_j table[j][digit_j(e)]; table (ndig, 2^w, L) Montgomery
    form with w in {4, 8}, e (N, Le) standard limbs."""
    if table.device.type == "cpu":
        return mont_fb_exp_plain(table, e, mod)
    ndig, entries, L = table.shape
    window = entries.bit_length() - 1
    if entries != 1 << window or window not in (4, 8) or L != mod.L:
        raise ValueError(f"bad fixed-base table shape {tuple(table.shape)}")
    if table.dtype != torch.int32 or not table.is_contiguous():
        raise ValueError("table must be contiguous int32")
    if table.device != mod.limbs.device:
        raise ValueError(f"table is on {table.device}")
    w = _words(mod)
    N = e.shape[0]
    eT = _limb_major(e, "e", mod.limbs.device, N)
    out = torch.empty((L, N), dtype=torch.int32, device=e.device)
    if N:
        _check("mont_fb_exp", _library().vmn_mont_fb_exp(
            w, window, _ptr(table), _ptr(eT), _ptr(out), _ptr(mod.limbs),
            _ptr(mod.one_mont), mod.mprime32, N, eT.shape[0], ndig,
            _stream(e.device)))
        LAUNCHES["mont_fb_exp"] += 1
    return out.t().contiguous()


def mont_expprod_positions(bases: torch.Tensor, e: torch.Tensor,
                           mod: Modulus, nbits: int) -> torch.Tensor:
    """H4: per-digit-position products P_j = prod_i bases_i^(d_ij),
    (ndig_pad, L) Montgomery form (see mont_expprod_positions_plain)."""
    if bases.device.type == "cpu":
        return mont_expprod_positions_plain(bases, e, mod, nbits)
    N, L = bases.shape
    w = _words(mod)
    bT = _limb_major(bases, "bases", mod.limbs.device, N)
    eT = _limb_major(e, "e", mod.limbs.device, N)
    ndig_pad = _ndig_pad(nbits)
    lib = _library()
    stream = _stream(bases.device)
    partials = []
    for s0 in range(0, N, EP_SUPER):
        bs = bT[:, s0 : s0 + EP_SUPER].contiguous()
        es = eT[:, s0 : s0 + EP_SUPER].contiguous()
        n = bs.shape[1]
        lanes = 1 << max(0, (max(1, n // EP_PER_LANE)).bit_length() - 1)
        lanes = min(lanes, EP_MAX_LANES)
        tbl = torch.empty((16, w, n), dtype=torch.int32, device=bases.device)
        out = torch.empty((L, ndig_pad * lanes), dtype=torch.int32,
                          device=bases.device)
        _check("mont_expprod_positions", lib.vmn_ep_table(
            w, _ptr(bs), _ptr(tbl), _ptr(mod.limbs), _ptr(mod.one_mont),
            mod.mprime32, n, stream))
        _check("mont_expprod_positions", lib.vmn_ep_acc(
            w, _ptr(tbl), _ptr(es), _ptr(out), _ptr(mod.limbs),
            _ptr(mod.one_mont), mod.mprime32, n, es.shape[0], ndig_pad,
            lanes, stream))
        LAUNCHES["mont_expprod_positions"] += 1
        partials.append(out.t().reshape(ndig_pad, lanes, L))
    if not partials:
        return mod.one_mont.expand(ndig_pad, L).contiguous()
    return _lane_tree(torch.cat(partials, dim=1), mod, mont_mul)


def mont_expprod(bases: torch.Tensor, e: torch.Tensor, mod: Modulus,
                 nbits: int) -> torch.Tensor:
    """prod_i bases_i^(e_i) -> (L,) Montgomery form (K7): H4's positions,
    then prod_j P_j^(2^(4j)) through H1 one position at a time."""
    P = mont_expprod_positions(bases, e, mod, nbits)
    acc = mod.one_mont.reshape(1, -1)
    for j in range(P.shape[0] - 1, -1, -1):
        for _ in range(WINDOW):
            acc = mont_mul(acc, acc, mod)
        acc = mont_mul(acc, P[j : j + 1], mod)
    return acc[0]

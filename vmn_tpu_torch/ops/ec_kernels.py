"""Batched elliptic-curve kernels: Hopper CUDA wrappers and plain PyTorch
versions (port of `vmn_tpu.ops.ec_kernels`).

Every point operation of an EC group (arith/ec.py) reduces to these four
functions.  Each has three parts here, as in ops/mont_kernels.py:

* the wrapper (`ec_scalar_mul`, `ec_multiexp_positions`, `ec_fb_exp`,
  `ec_point_add`, plus `ec_multiexp` on top of them).  A CPU tensor goes
  to the plain version; a CUDA tensor goes to the kernel in
  `csrc/ec_kernels.cu` or raises — there is no fallback;
* the plain PyTorch version (`*_plain`): exact integer arithmetic through
  `mont_mul_plain`, `add_mod` and `sub_mod`, the same formulas as the
  kernels, so that both give the same canonical limbs;
* a launch counter per wrapper (`LAUNCHES[name]`), bumped only where the
  wrapper launches its kernel.

Points at this boundary are Jacobian ``(X, Y, Z)`` triples of ``(N, L)``
int32 16-bit limb tensors in Montgomery form (infinity: Z == 0), or
affine ``(x, y)`` with an ``(N,)`` bool infinity mask; exponents are
``(N, Le)`` standard-form limbs.  The wrappers transpose to the
limb-major ``(L, N)`` layout the kernels read.

Kernel notes (what each replaces, what bounds it on an H100, what the
design does about it):

* K8 (the TPU kernels' field and point device functions) is
  `csrc/ec.cuh`: word carry chains instead of Kogge–Stone scans, the
  branchless a = -3 formulas with masks for the exceptional cases.
* H5 `ec_scalar_mul` replaces K9 `ec_scalar_mul_pallas`
  (vmn_tpu/ops/ec_kernels.py:277-331).  One thread per point: 14
  additions build 16 Jacobian multiples (1.5 KB of local memory at
  W = 8), then per 4-bit digit 4 doublings, a masked select over all 16
  entries and one addition.  Bound by the ~3,000 Montgomery products
  per 256-bit scalar (integer multiply-add issue); the table's local
  traffic is second.
* H6 `ec_multiexp_positions` replaces both `pallas_call`s of K10
  `ec_multiexp_pallas` (:444-584): launch 1 writes each point's 16
  multiples to device memory, launch 2 gives each thread one (lane,
  digit position) and folds its lane's points in order; an H8 tree
  joins the lanes.  `ec_multiexp` then combines the positions,
  sum_j 2^(4j)·S_j, as 4 doublings + 1 addition per position in
  single-element H8 launches — a known latency-bound spot, as K7's
  combine is for ModP.
* H7 `ec_fb_exp` replaces K11 `ec_fb_exp_pallas` (:667-719): the block
  stages digit j's 16 affine rows in shared memory and every thread
  masked-selects its row (a warp broadcast) for one addition per digit.
  The TPU's one-hot f32 MXU gather is not carried over.  Off the mix
  path, as in vmn_tpu (arith/ec.py `_exp_impl`).
* H8 `ec_point_add` replaces K12 `ec_point_add_pallas` (:747-773): one
  thread per pair.  Also every single-element addition and doubling of
  the EC path (a doubling is P + P: the addition takes its doubling
  branch exactly when H = R = 0).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from vmn_tpu_torch.ops import mont_kernels as K
from vmn_tpu_torch.ops.mont_kernels import (
    EP_MAX_LANES,
    EP_PER_LANE,
    WINDOW,
    Modulus,
    _digits,
    _ndig_pad,
    add_mod,
    mont_mul_plain,
    sub_mod,
)

ENTRIES = 1 << WINDOW
# Points per H6 table build: the (16, 3, W, n) word table is 1.5 KB per
# point at W = 8, so 2^20 points cap it at 1.5 GiB of the 80 GB card.
EP_SUPER = 1 << 20
_WIDTHS = (8,)  # W = L/2 instantiated in ec_kernels.cu (P-256)

EC_KERNELS = ("ec_scalar_mul", "ec_multiexp_positions", "ec_fb_exp",
              "ec_point_add")
LAUNCHES = dict.fromkeys(EC_KERNELS, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------- plain versions


class _PlainField:
    """Field operations of the plain versions.  The independent products
    (sums, differences) of one formula step go to one stacked call, which
    keeps the number of torch calls per point operation small."""

    def __init__(self, mod: Modulus):
        self.mod = mod

    def mul(self, *pairs):
        a = torch.stack([p[0] for p in pairs])
        b = torch.stack([p[1] for p in pairs])
        return mont_mul_plain(a, b, self.mod).unbind(0)

    def add(self, *pairs):
        a = torch.stack([p[0] for p in pairs])
        b = torch.stack([p[1] for p in pairs])
        return add_mod(a, b, self.mod.limbs).unbind(0)

    def sub(self, *pairs):
        a = torch.stack([p[0] for p in pairs])
        b = torch.stack([p[1] for p in pairs])
        return sub_mod(a, b, self.mod.limbs).unbind(0)


def _is_zero(x: torch.Tensor) -> torch.Tensor:
    return (x == 0).all(dim=-1, keepdim=True)


def _point_double(F: _PlainField, X, Y, Z):
    """a = -3 Jacobian doubling (vmn_tpu/ops/ec_kernels.py:138-152)."""
    delta, gamma = F.mul((Z, Z), (Y, Y))
    (xmd,) = F.sub((X, delta))
    t, xpd, ypz = F.add((xmd, xmd), (X, delta), (Y, Z))
    (t3,) = F.add((t, xmd))
    alpha, beta, g2, yz2 = F.mul((t3, xpd), (X, gamma), (gamma, gamma),
                                 (ypz, ypz))
    beta2, g4, aa = *F.add((beta, beta), (g2, g2)), F.mul((alpha, alpha))[0]
    beta4, g8a = F.add((beta2, beta2), (g4, g4))
    beta8, g8 = F.add((beta4, beta4), (g8a, g8a))
    X3, zt = F.sub((aa, beta8), (yz2, gamma))
    bx, Z3 = F.sub((beta4, X3), (zt, delta))
    (ab,) = F.mul((alpha, bx))
    (Y3,) = F.sub((ab, g8))
    return X3, Y3, Z3


def _point_add(F: _PlainField, X1, Y1, Z1, X2, Y2, Z2):
    """Branchless general Jacobian addition
    (vmn_tpu/ops/ec_kernels.py:155-192)."""
    z1z1, z2z2, y1z2, y2z1, z1z2 = F.mul((Z1, Z1), (Z2, Z2), (Y1, Z2),
                                         (Y2, Z1), (Z1, Z2))
    U1, U2, S1, S2 = F.mul((X1, z2z2), (X2, z1z1), (y1z2, z2z2),
                           (y2z1, z1z1))
    H, R = F.sub((U2, U1), (S2, S1))
    HH, RR, Z3 = F.mul((H, H), (R, R), (z1z2, H))
    HHH, V = F.mul((H, HH), (U1, HH))
    V2, = F.add((V, V))
    (t,) = F.sub((RR, HHH))
    (X3,) = F.sub((t, V2))
    (vx,) = F.sub((V, X3))
    rvx, sh = F.mul((R, vx), (S1, HHH))
    (Y3,) = F.sub((rvx, sh))

    p1_inf, p2_inf = _is_zero(Z1), _is_zero(Z2)
    h_zero, r_zero = _is_zero(H), _is_zero(R)
    same = h_zero & r_zero
    opp = h_zero & ~r_zero
    dX, dY, dZ = _point_double(F, X1, Y1, Z1)
    X3 = torch.where(same, dX, X3)
    Y3 = torch.where(same, dY, Y3)
    Z3 = torch.where(same, dZ, Z3)
    Z3 = torch.where(opp & ~(p1_inf | p2_inf), torch.zeros_like(Z3), Z3)
    X3 = torch.where(p1_inf, X2, X3)
    Y3 = torch.where(p1_inf, Y2, Y3)
    Z3 = torch.where(p1_inf, Z2, Z3)
    X3 = torch.where(p2_inf, X1, X3)
    Y3 = torch.where(p2_inf, Y1, Y3)
    Z3 = torch.where(p2_inf, Z1, Z3)
    return X3, Y3, Z3


def ec_point_add_plain(x1, y1, z1, x2, y2, z2, mod: Modulus):
    """Plain version of H8: (N, L) Jacobian + Jacobian -> Jacobian."""
    return _point_add(_PlainField(mod), x1, y1, z1, x2, y2, z2)


def _multiples_plain(F: _PlainField, x, y, inf, mod: Modulus):
    """(16, N, L) x3: the Jacobian multiples d·P, entry 0 infinity
    (X = 0, Y = one, Z = 0), entry d = entry d-1 + P."""
    zero = torch.zeros_like(x)
    one = mod.one_mont.expand(x.shape)
    z1 = torch.where(inf[:, None], zero, one)
    tX, tY, tZ = [zero, x], [one, y], [zero, z1]
    aX, aY, aZ = x, y, z1
    for _ in range(2, ENTRIES):
        aX, aY, aZ = _point_add(F, aX, aY, aZ, x, y, z1)
        tX.append(aX)
        tY.append(aY)
        tZ.append(aZ)
    return torch.stack(tX), torch.stack(tY), torch.stack(tZ)


def ec_scalar_mul_plain(x, y, inf, e, mod: Modulus, nbits: int):
    """Plain version of H5: e·P per point.  x, y (N, L) affine Montgomery
    form, inf (N,) bool, e (N, Le) standard limbs below 2^nbits.
    Returns Jacobian (X, Y, Z), each (N, L)."""
    F = _PlainField(mod)
    N = x.shape[0]
    ndig = max(1, -(-nbits // WINDOW))
    tX, tY, tZ = _multiples_plain(F, x, y, inf, mod)
    digits = _digits(e, ndig, WINDOW)
    rows = torch.arange(N, device=x.device)
    zero = torch.zeros_like(x)
    acc = (zero, mod.one_mont.expand(x.shape), zero)
    for j in range(ndig - 1, -1, -1):
        for _ in range(WINDOW):
            acc = _point_double(F, *acc)
        d = digits[j]
        acc = _point_add(F, *acc, tX[d, rows], tY[d, rows], tZ[d, rows])
    return tuple(t.contiguous() for t in acc)


def _lanes(n: int) -> int:
    lanes = 1 << max(0, (max(1, n // EP_PER_LANE)).bit_length() - 1)
    return min(lanes, EP_MAX_LANES)


def _lane_tree(PX, PY, PZ, mod: Modulus, add):
    """(J, lanes, L) x3 -> (J, L) x3: the Jacobian sum over the lane axis,
    halves added pairwise (vmn_tpu/ops/ec_kernels.py:557-569)."""
    while PX.shape[1] > 1:
        J, n, L = PX.shape
        h = n // 2
        lo = [t[:, :h].reshape(-1, L) for t in (PX, PY, PZ)]
        hi = [t[:, h : 2 * h].reshape(-1, L) for t in (PX, PY, PZ)]
        out = [t.reshape(J, h, L) for t in add(*lo, *hi, mod)]
        if n % 2:
            out = [torch.cat([o, t[:, 2 * h :]], dim=1)
                   for o, t in zip(out, (PX, PY, PZ))]
        PX, PY, PZ = out
    return PX[:, 0].contiguous(), PY[:, 0].contiguous(), PZ[:, 0].contiguous()


def ec_multiexp_positions_plain(x, y, inf, e, mod: Modulus, nbits: int):
    """Plain version of H6: S_j = sum_i d_ij·P_i for every 4-bit digit
    position j < ndig_pad, as Jacobian (ndig_pad, L) x3.  The points are
    folded in the kernel's order (super-chunks of EP_SUPER points, lane t
    folding points t, t+lanes, ...; then the same lane tree), so the
    Jacobian limbs equal the kernel's."""
    F = _PlainField(mod)
    N, L = x.shape
    ndig_pad = _ndig_pad(nbits)
    one = mod.one_mont
    parts = []
    for s0 in range(0, N, EP_SUPER):
        n = min(EP_SUPER, N - s0)
        lanes = _lanes(n)
        sl = slice(s0, s0 + n)
        tX, tY, tZ = _multiples_plain(F, x[sl], y[sl], inf[sl], mod)
        digits = _digits(e[sl], ndig_pad, WINDOW)  # (ndig_pad, n)
        shape = (ndig_pad * lanes, L)
        aX = torch.zeros(shape, dtype=x.dtype, device=x.device)
        aY = one.expand(shape)
        aZ = aX
        lane = torch.arange(lanes, device=x.device)
        for c0 in range(0, n, lanes):
            i = (c0 + lane).clamp(max=n - 1)
            d = digits[:, i]  # (ndig_pad, lanes)
            f = [t[d, i].reshape(shape) for t in (tX, tY, tZ)]
            new = _point_add(F, aX, aY, aZ, *f)
            live = (c0 + lane < n).repeat(ndig_pad)[:, None]
            aX, aY, aZ = (torch.where(live, a, b)
                          for a, b in zip(new, (aX, aY, aZ)))
        parts.append([t.reshape(ndig_pad, lanes, L) for t in (aX, aY, aZ)])
    if not parts:
        zero = torch.zeros((ndig_pad, L), dtype=x.dtype, device=x.device)
        return zero, one.expand(ndig_pad, L).contiguous(), zero
    P = [torch.cat([p[c] for p in parts], dim=1) for c in range(3)]
    return _lane_tree(*P, mod, ec_point_add_plain)


def ec_fb_exp_plain(table_x, table_y, e, mod: Modulus):
    """Plain version of H7: sum_j T[j][digit_j(e)] for the affine table
    T (ndig, 16, L) of d·2^(4j)·P; digit 0 adds infinity.  Returns
    Jacobian (X, Y, Z), each (N, L)."""
    F = _PlainField(mod)
    ndig, _, L = table_x.shape
    N = e.shape[0]
    digits = _digits(e, ndig, WINDOW)
    zero = torch.zeros((N, L), dtype=table_x.dtype, device=table_x.device)
    one = mod.one_mont.expand(N, L)
    acc = (zero, one, zero)
    for j in range(ndig):
        d = digits[j]
        fZ = torch.where((d == 0)[:, None], zero, one)
        acc = _point_add(F, *acc, table_x[j][d], table_y[j][d], fZ)
    return tuple(t.contiguous() for t in acc)


# ------------------------------------------------------------ the kernels

_lib_lock = threading.Lock()
_bound = None


def _library() -> ctypes.CDLL:
    """The shared library of ops/mont_kernels.py with the EC entry points'
    signatures set."""
    global _bound
    with _lib_lock:
        if _bound is None:
            lib = K._library()
            P, I64, I32, U32 = (ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_int, ctypes.c_uint32)
            sig = {
                "vmn_ec_add": [I32] + [P] * 10 + [U32, I64, P],
                "vmn_ec_smul": [I32] + [P] * 9 + [U32, I64, I32, I32, P],
                "vmn_ec_mexp_tbl": [I32] + [P] * 6 + [U32, I64, P],
                "vmn_ec_mexp_acc": [I32] + [P] * 5 + [U32, I64, I32, I32,
                                                      I32, P],
                "vmn_ec_fb": [I32] + [P] * 8 + [U32, I64, I32, I32, P],
            }
            for name, args in sig.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _bound = lib
    return _bound


def _words(mod: Modulus) -> int:
    w = K._words(mod)
    if w not in _WIDTHS:
        raise ValueError(f"no EC kernel instantiated for L={mod.L}")
    return w


def _coords(ts, names, mod: Modulus, n: int):
    """(n, L) int32 coordinates on the modulus' device -> limb-major
    (L, n) copies; raises on any other device, dtype or shape."""
    out = []
    for t, name in zip(ts, names):
        if t.dim() != 2 or t.shape[1] != mod.L:
            raise ValueError(f"{name}: expected (N, {mod.L}) limbs, got "
                             f"{tuple(t.shape)}")
        out.append(K._limb_major(t, name, mod.limbs.device, n))
    return out


def _mask(inf: torch.Tensor, device, n: int) -> torch.Tensor:
    if inf.device != device or inf.shape != (n,):
        raise ValueError(f"inf: expected ({n},) on {device}, got "
                         f"{tuple(inf.shape)} on {inf.device}")
    return inf.to(torch.uint8).contiguous()


def _pad_exponent(e: torch.Tensor, ndig: int) -> torch.Tensor:
    """Zero limbs up to the digits read, as the JAX wrappers pad."""
    need = -(-ndig * WINDOW // K.LIMB_BITS)
    if e.shape[1] < need:
        e = torch.nn.functional.pad(e, (0, need - e.shape[1]))
    return e


def _out(L: int, N: int, device):
    return [torch.empty((L, N), dtype=torch.int32, device=device)
            for _ in range(3)]


def _rows(ts):
    return tuple(t.t().contiguous() for t in ts)


def ec_point_add(x1, y1, z1, x2, y2, z2, mod: Modulus):
    """H8: batched Jacobian + Jacobian, six (N, L) -> three (N, L)."""
    if x1.device.type == "cpu":
        return ec_point_add_plain(x1, y1, z1, x2, y2, z2, mod)
    N, L = x1.shape
    w = _words(mod)
    ins = _coords((x1, y1, z1, x2, y2, z2),
                  ("x1", "y1", "z1", "x2", "y2", "z2"), mod, N)
    out = _out(L, N, x1.device)
    if N:
        K._check("ec_point_add", _library().vmn_ec_add(
            w, *map(K._ptr, ins), *map(K._ptr, out), K._ptr(mod.limbs),
            mod.mprime32, N, K._stream(x1.device)))
        LAUNCHES["ec_point_add"] += 1
    return _rows(out)


def ec_scalar_mul(x, y, inf, e, mod: Modulus, nbits: int):
    """H5: e·P per point; x, y (N, L) affine Montgomery form, inf (N,)
    bool, e (N, Le) standard limbs below 2^nbits -> Jacobian (N, L) x3."""
    if x.device.type == "cpu":
        return ec_scalar_mul_plain(x, y, inf, e, mod, nbits)
    N, L = x.shape
    w = _words(mod)
    dev = mod.limbs.device
    ndig = max(1, -(-nbits // WINDOW))
    xT, yT = _coords((x, y), ("x", "y"), mod, N)
    eT = K._limb_major(_pad_exponent(e, ndig), "e", dev, N)
    im = _mask(inf, dev, N)
    out = _out(L, N, x.device)
    if N:
        K._check("ec_scalar_mul", _library().vmn_ec_smul(
            w, K._ptr(xT), K._ptr(yT), K._ptr(im), K._ptr(eT),
            *map(K._ptr, out), K._ptr(mod.limbs), K._ptr(mod.one_mont),
            mod.mprime32, N, eT.shape[0], ndig, K._stream(x.device)))
        LAUNCHES["ec_scalar_mul"] += 1
    return _rows(out)


def ec_multiexp_positions(x, y, inf, e, mod: Modulus, nbits: int):
    """H6: per-digit-position sums S_j = sum_i d_ij·P_i, Jacobian
    (ndig_pad, L) x3 (see ec_multiexp_positions_plain)."""
    if x.device.type == "cpu":
        return ec_multiexp_positions_plain(x, y, inf, e, mod, nbits)
    N, L = x.shape
    w = _words(mod)
    dev = mod.limbs.device
    ndig_pad = _ndig_pad(nbits)
    xT, yT = _coords((x, y), ("x", "y"), mod, N)
    eT = K._limb_major(_pad_exponent(e, ndig_pad), "e", dev, N)
    im = _mask(inf, dev, N)
    lib = _library()
    stream = K._stream(x.device)
    parts = []
    for s0 in range(0, N, EP_SUPER):
        xs, ys, es = (t[:, s0 : s0 + EP_SUPER].contiguous()
                      for t in (xT, yT, eT))
        ms = im[s0 : s0 + EP_SUPER].contiguous()
        n = xs.shape[1]
        lanes = _lanes(n)
        tbl = torch.empty((ENTRIES * 3 * w, n), dtype=torch.int32, device=dev)
        out = torch.empty((3, L, ndig_pad * lanes), dtype=torch.int32,
                          device=dev)
        K._check("ec_multiexp_positions", lib.vmn_ec_mexp_tbl(
            w, K._ptr(xs), K._ptr(ys), K._ptr(ms), K._ptr(tbl),
            K._ptr(mod.limbs), K._ptr(mod.one_mont), mod.mprime32, n,
            stream))
        K._check("ec_multiexp_positions", lib.vmn_ec_mexp_acc(
            w, K._ptr(tbl), K._ptr(es), K._ptr(out), K._ptr(mod.limbs),
            K._ptr(mod.one_mont), mod.mprime32, n, es.shape[0], ndig_pad,
            lanes, stream))
        LAUNCHES["ec_multiexp_positions"] += 1
        # (3, L, ndig_pad·lanes) limb-major -> (3, ndig_pad, lanes, L)
        parts.append(out.reshape(3, L, ndig_pad, lanes).permute(0, 2, 3, 1))
    if not parts:
        zero = torch.zeros((ndig_pad, L), dtype=torch.int32, device=dev)
        return zero, mod.one_mont.expand(ndig_pad, L).contiguous(), zero
    P = torch.cat(parts, dim=2)
    return _lane_tree(P[0], P[1], P[2], mod, ec_point_add)


def ec_multiexp(x, y, inf, e, mod: Modulus, nbits: int):
    """sum_i e_i·P_i -> one Jacobian point, (L,) x3 (K10): H6's
    positions, then sum_j 2^(4j)·S_j through H8, one position at a time
    (4 doublings as P + P, then one addition)."""
    PX, PY, PZ = ec_multiexp_positions(x, y, inf, e, mod, nbits)
    zero = torch.zeros((1, mod.L), dtype=torch.int32, device=PX.device)
    acc = (zero, mod.one_mont.reshape(1, -1), zero)
    for j in range(PX.shape[0] - 1, -1, -1):
        for _ in range(WINDOW):
            acc = ec_point_add(*acc, *acc, mod)
        acc = ec_point_add(*acc, PX[j : j + 1], PY[j : j + 1],
                           PZ[j : j + 1], mod)
    return tuple(t[0] for t in acc)


def ec_fb_exp(table_x, table_y, e, mod: Modulus):
    """H7: fixed-base e·P from the affine table (ndig, 16, L) of
    d·2^(4j)·P, e (N, Le) standard limbs -> Jacobian (N, L) x3."""
    if table_x.device.type == "cpu":
        return ec_fb_exp_plain(table_x, table_y, e, mod)
    ndig, entries, L = table_x.shape
    if entries != ENTRIES or L != mod.L or table_y.shape != table_x.shape:
        raise ValueError(f"bad fixed-base table shape {tuple(table_x.shape)}")
    dev = mod.limbs.device
    for t in (table_x, table_y):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != dev:
            raise ValueError("tables must be contiguous int32 on the card")
    w = _words(mod)
    N = e.shape[0]
    eT = K._limb_major(_pad_exponent(e, ndig), "e", dev, N)
    out = _out(L, N, e.device)
    if N:
        K._check("ec_fb_exp", _library().vmn_ec_fb(
            w, K._ptr(table_x), K._ptr(table_y), K._ptr(eT),
            *map(K._ptr, out), K._ptr(mod.limbs), K._ptr(mod.one_mont),
            mod.mprime32, N, eT.shape[0], ndig, K._stream(e.device)))
        LAUNCHES["ec_fb_exp"] += 1
    return _rows(out)

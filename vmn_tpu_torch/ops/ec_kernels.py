"""Batched elliptic-curve kernels: Hopper CUDA wrappers and plain PyTorch
versions (port of `vmn_tpu.ops.ec_kernels`).

Every point operation of an EC group (arith/ec.py) reduces to these five
functions.  Each has three parts here, as in ops/mont_kernels.py:

* the wrapper (`ec_scalar_mul`, `ec_multiexp_positions`,
  `ec_multiexp_combine`, `ec_fb_exp`, `ec_point_add`, plus `ec_multiexp`
  on top of them).  CPU operands with a modulus there go to the plain
  version; CUDA operands go to the kernel in `csrc/ec_kernels.cu` or
  raise, and so does an operand on another device than the modulus —
  there is no fallback;
* the plain PyTorch version (`*_plain`): exact integer arithmetic through
  `mont_mul_plain`, `add_mod` and `sub_mod`, the same formulas as the
  kernels, so that both give the same canonical limbs (H5 and H8 on a
  few rows of a CPU tensor: the same formulas over `K.HostField`);
* a launch counter per wrapper (`LAUNCHES[name]`), bumped only where the
  wrapper launches its kernel; H5 and H8 also count their launches by
  batch size (`LAUNCH_SIZES`, the buckets of ops/mont_kernels.py).

Points at this boundary are Jacobian ``(X, Y, Z)`` triples of ``(N, L)``
int32 16-bit limb tensors in Montgomery form (infinity: Z == 0), or
affine ``(x, y)`` with an ``(N,)`` bool infinity mask; exponents are
``(N, Le)`` standard-form limbs.  H5, H6, H8 and the combine read these
row-major operands as they are (P-521's, L = 33, padded to the inner
width's 2·W' = 40 limbs, and P-224's, L = 14, padded to P-256's 16, each
coordinate taken to the kernel's radix and back inside the kernel:
`Modulus` in ops/mont_kernels.py); H7's wrapper
transposes to the limb-major ``(L, N)`` layout its kernel reads.

Kernel notes (what each replaces, what bounds it on an H100, what the
design does about it):

* K8 (the TPU kernels' field and point device functions) is
  `csrc/ec.cuh`: word carry chains instead of Kogge–Stone scans, the
  branchless a = -3 formulas with masks for the exceptional cases,
  written once over a field type; `csrc/ec_coop.cuh` gives them a field
  spread over TPI lanes of a warp (carries between lanes from ballots,
  products through `mont_coop.cuh`).
* H5 `ec_scalar_mul` replaces K9 `ec_scalar_mul_pallas`
  (vmn_tpu/ops/ec_kernels.py:277-331).  TPI lanes of a warp per point
  (TPI from the point count, `COOP_TPI`: at W = 8 4 up to 8192 points,
  2 from 16384; at W = 12 4): 14 additions build 16 Jacobian multiples
  in shared memory, then
  per 4-bit digit 4 doublings, a masked select over all 16 entries and one
  addition; the formulas run their independent products in pairs.  The
  branchless addition also computes a doubling, 24 products where the
  bound counts 16.  A small batch is bound by one point's chain of
  ~3,900 products; a full card by the integer pipe, where the product
  spread over lanes issues about twice the one-thread product's
  instructions, so at 2^17 points H5 is slower than the one-thread kernel
  it replaced, whose 1.5 KB table a point lived in local memory (PERF.md
  §6).  At 4096 points that kernel filled 32 of the 132 SMs.
* H6 `ec_multiexp_positions` replaces both `pallas_call`s of K10
  `ec_multiexp_pallas` (:444-570) with one launch in which no point's
  table goes through device memory: a block walks chunks of points
  (`MEXP_SHAPES`: 56 at W = 8, 40 at W = 12); two warps build the next
  chunk's 16 multiples a point into shared memory while the others (ten
  warps at W = 8, six at W = 12) fold the current one, each fold thread
  one digit position and every subs-th point (`mexp_shape`), with a
  masked select over all 16 entries; one-thread field, 12 warps an SM at
  W = 8 (168 registers a thread), 8 at W = 12 (255).  P-224 runs the
  W = 8 form with the boundary conversion in its builders (x and y to
  the kernel's radix) and folders (the sums back).  At P-521's inner
  width (W' = 20) one thread cannot hold a product's operands, so the
  builders and folders are groups of MEXP_TPI lanes with the cooperative
  field (16 builder and 80 fold groups of 4 lanes, 160 registers, no
  spill), each fold group taking the 144 positions' items in rounds, its
  running sums in shared memory.  Bound by its products (14 table
  additions a point and one addition a point and position, 24 products
  each).  An H8 tree joins the partials (`_lane_tree`).
* `ec_multiexp_combine` is K10's position combine (:571-584),
  sum_j 2^(4j)·S_j, in one launch: one warp runs the 5·ndig_pad point
  operations back to back on the cooperative field, where a loop over
  H8 would launch 5·ndig_pad single-point batches (320 at 256 bits).
  Its doubling is `point_double` with an infinity input kept as it is,
  which gives the limbs of P + P (the plain version's doubling) at a
  third of the products.  A chain of dependent point operations: bound
  by their latency, not by the card's throughput; TPI 8.
* H7 `ec_fb_exp` replaces K11 `ec_fb_exp_pallas` (:667-719): the block
  stages digit j's 16 affine rows in shared memory and every thread
  masked-selects its row (a warp broadcast) for one addition per digit.
  The TPU's one-hot f32 MXU gather is not carried over.  Off the mix
  path, as in vmn_tpu (arith/ec.py `_exp_impl`).
* H8 `ec_point_add` replaces K12 `ec_point_add_pallas` (:747-773) on the
  row-major operands as they lie, on TPI lanes a pair with the cooperative
  field, TPI by the batch size (`COOP_TPI`: 8 below 4096 pairs, where
  one pair's 24 dependent products are the latency, 4 to 16383, 2 from
  16384, where the integer pipe bounds it).  One thread a pair, with
  its operands in shared memory as in H6, spilled and ran slower at
  every batch (PERF.md §6).  Bound by its products, 24 a pair in the
  branchless form.  Also the EC path's other single-point
  additions and doublings (a doubling is P + P: the addition takes its
  doubling branch exactly when H = R = 0).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from vmn_tpu_torch.ops import mont_kernels as K
from vmn_tpu_torch.ops.mont_kernels import (
    WINDOW,
    Modulus,
    _digits,
    _ndig_pad,
    add_mod,
    mont_mul_plain,
    sub_mod,
)

ENTRIES = 1 << WINDOW
# Points per H6 launch; the partials of the launches are joined together.
EP_SUPER = 1 << 20
# H6's partition at each width W (MexpShape in csrc/ec_kernels.cuh):
# chunks of `chunk` points, `folders` fold threads a block (at the padded
# widths fold groups of MEXP_TPI[W] lanes, each taking `rounds` items);
# at most MEXP_BLOCKS blocks (one an SM of the H100 SXM), at most
# EP_MAX_LANES partials a digit position.
MEXP_SHAPES = {8: (56, 320), 12: (40, 192), 20: (16, 80)}
MEXP_TPI = {20: 4}  # the cooperative form's lanes a group
MEXP_BLOCKS = 132
EP_MAX_LANES = 2048
# The words the ec_*.cu files instantiate: P-256 (W = L/2 = 8; P-224's
# L = 14 at the inner width W' = 8, Modulus), P-384 (12), P-521 (L = 33 at
# the inner width W' = 20)
_WIDTHS = (8, 12, 20)

EC_KERNELS = ("ec_scalar_mul", "ec_multiexp_positions",
              "ec_multiexp_combine", "ec_fb_exp", "ec_point_add")
LAUNCHES = dict.fromkeys(EC_KERNELS, 0)
# H5 and H8 launches by batch size: 1, 2-127, >= 128 points.
LAUNCH_SIZES = {k: dict.fromkeys(K.SIZE_BUCKETS, 0)
                for k in ("ec_point_add", "ec_scalar_mul")}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for sizes in LAUNCH_SIZES.values():
        for b in sizes:
            sizes[b] = 0


def _launched(name: str, n: int) -> None:
    with K.COUNT_LOCK:
        LAUNCHES[name] += 1
        if name in LAUNCH_SIZES:
            LAUNCH_SIZES[name][K.size_bucket(n)] += 1


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

    @staticmethod
    def is_zero(x: torch.Tensor) -> torch.Tensor:
        return (x == 0).all(dim=-1, keepdim=True)

    where = staticmethod(torch.where)
    zeros_like = staticmethod(torch.zeros_like)


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

    p1_inf, p2_inf = F.is_zero(Z1), F.is_zero(Z2)
    h_zero, r_zero = F.is_zero(H), F.is_zero(R)
    same = h_zero & r_zero
    opp = h_zero & ~r_zero
    if bool(same.any()):  # the doubling branch, where a row takes it
        dX, dY, dZ = _point_double(F, X1, Y1, Z1)
        X3 = F.where(same, dX, X3)
        Y3 = F.where(same, dY, Y3)
        Z3 = F.where(same, dZ, Z3)
    Z3 = F.where(opp & ~(p1_inf | p2_inf), F.zeros_like(Z3), Z3)
    X3 = F.where(p1_inf, X2, X3)
    Y3 = F.where(p1_inf, Y2, Y3)
    Z3 = F.where(p1_inf, Z2, Z3)
    X3 = F.where(p2_inf, X1, X3)
    Y3 = F.where(p2_inf, Y1, Y3)
    Z3 = F.where(p2_inf, Z1, Z3)
    return X3, Y3, Z3


def _double_as_add(F: _PlainField, X, Y, Z):
    """P + P as `_point_add` gives it, at a doubling's cost: its doubling
    branch, but P itself where Z = 0 (csrc/ec_coop.cuh,
    point_double_as_add)."""
    dX, dY, dZ = _point_double(F, X, Y, Z)
    inf = F.is_zero(Z)
    return F.where(inf, X, dX), F.where(inf, Y, dY), F.where(inf, Z, dZ)


def ec_point_add_plain(x1, y1, z1, x2, y2, z2, mod: Modulus):
    """Plain version of H8: (N, L) Jacobian + Jacobian -> Jacobian."""
    if K.host_route(x1, x1.shape[0]):
        F = K.host_field(mod)
        out = _point_add(F, *(F.ints(t) for t in (x1, y1, z1, x2, y2, z2)))
        return tuple(F.tensor(t) for t in out)
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
    N = x.shape[0]
    ndig = max(1, -(-nbits // WINDOW))
    if K.host_route(x, N):
        return _scalar_mul_host(x, y, inf, e, mod, ndig)
    F = _PlainField(mod)
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


def _scalar_mul_host(x, y, inf, e, mod: Modulus, ndig: int):
    """ec_scalar_mul_plain's steps on Python integers (`K.HostField`)."""
    F = K.host_field(mod)
    xs, ys = F.ints(x), F.ints(y)
    zero = F.zeros_like(xs)
    one = np.full(len(xs), F.one, dtype=object)
    z1 = np.where(inf.numpy(), zero, one)
    tX, tY, tZ = [zero, xs], [one, ys], [zero, z1]
    aX, aY, aZ = xs, ys, z1
    for _ in range(2, ENTRIES):
        aX, aY, aZ = _point_add(F, aX, aY, aZ, xs, ys, z1)
        tX.append(aX)
        tY.append(aY)
        tZ.append(aZ)
    tX, tY, tZ = np.stack(tX), np.stack(tY), np.stack(tZ)
    digits = _digits(e, ndig, WINDOW).numpy()
    rows = np.arange(len(xs))
    acc = (zero, one, zero)
    for j in range(ndig - 1, -1, -1):
        for _ in range(WINDOW):
            acc = _point_double(F, *acc)
        d = digits[j]
        acc = _point_add(F, *acc, tX[d, rows], tY[d, rows], tZ[d, rows])
    return tuple(F.tensor(t) for t in acc)


def mexp_shape(n: int, npos: int, w: int):
    """(blocks, subs) of an H6 launch at width W over n >= 1 points and
    npos digit positions: `subs` fold threads (groups) a position, each
    folding every subs-th point of a chunk; blocks walk the chunks b,
    b + blocks, ...; partial q = b·subs + s of each position.  The
    cooperative form (MEXP_TPI) takes more items than fold groups in
    rounds."""
    chunk, folders = MEXP_SHAPES[w]
    if npos > folders and w not in MEXP_TPI:
        raise ValueError(f"H6 folds at most {folders} digit positions, "
                         f"got {npos}")
    subs = max(1, folders // npos)
    chunks = -(-n // chunk)
    return max(1, min(MEXP_BLOCKS, chunks, EP_MAX_LANES // subs)), subs


def _mexp_order(n: int, blocks: int, subs: int, chunk: int, device):
    """(blocks·subs, steps) point indices of each H6 partial, in the
    order its fold thread adds them (-1: nothing more), chunks of
    `chunk` points."""
    i = torch.arange(n, device=device)
    k, c = i // chunk, i % chunk
    sub = c % subs
    per_chunk = (chunk - sub + subs - 1) // subs  # a full chunk's
    # every chunk before the last is full, and the last is its block's last
    step = (k // blocks) * per_chunk + c // subs
    q = (k % blocks) * subs + sub
    order = torch.full((blocks * subs, int(step.max()) + 1), -1,
                       dtype=torch.int64, device=device)
    order[q, step] = i
    return order


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
    folded in the kernel's order (launches of EP_SUPER points; in each,
    the partials of `mexp_shape` and `_mexp_order`; then the same lane
    tree), so the Jacobian limbs equal the kernel's."""
    F = _PlainField(mod)
    N, L = x.shape
    ndig_pad = _ndig_pad(nbits)
    one = mod.one_mont
    w = mod.W  # the kernel's shape, whose order this repeats
    parts = []
    for s0 in range(0, N, EP_SUPER):
        n = min(EP_SUPER, N - s0)
        blocks, subs = mexp_shape(n, ndig_pad, w)
        sl = slice(s0, s0 + n)
        tX, tY, tZ = _multiples_plain(F, x[sl], y[sl], inf[sl], mod)
        digits = _digits(e[sl], ndig_pad, WINDOW)  # (ndig_pad, n)
        order = _mexp_order(n, blocks, subs, MEXP_SHAPES[w][0], x.device)
        shape = (ndig_pad * order.shape[0], L)
        aX = torch.zeros(shape, dtype=x.dtype, device=x.device)
        aY = one.expand(shape)
        aZ = aX
        for i in order.T:  # one point a partial at a time
            live = (i >= 0).expand(ndig_pad, -1).reshape(-1, 1)
            i = i.clamp(min=0)
            d = digits[:, i]  # (ndig_pad, partials)
            f = [t[d, i].reshape(shape) for t in (tX, tY, tZ)]
            new = _point_add(F, aX, aY, aZ, *f)
            aX, aY, aZ = (torch.where(live, a, b)
                          for a, b in zip(new, (aX, aY, aZ)))
        parts.append([t.reshape(ndig_pad, -1, L) for t in (aX, aY, aZ)])
    if not parts:
        zero = torch.zeros((ndig_pad, L), dtype=x.dtype, device=x.device)
        return zero, one.expand(ndig_pad, L).contiguous(), zero
    P = [torch.cat([p[c] for p in parts], dim=1) for c in range(3)]
    return _lane_tree(*P, mod, ec_point_add_plain)


def ec_multiexp_combine_plain(PX, PY, PZ, mod: Modulus):
    """Plain version of the combine: sum_j 2^(4j)·S_j of (J, L) Jacobian
    positions -> one Jacobian point, (L,) x3.  Horner from the top
    position, from infinity (X = 0, Y = one, Z = 0): 4 doublings as
    P + P, then one addition, per position.  A chain on one point: on a
    CPU tensor its steps run on Python integers (K.host_route)."""
    if K.host_route(PX, 1):
        F = K.host_field(mod)
        P = [F.ints(t) for t in (PX, PY, PZ)]
        zero = np.zeros(1, dtype=object)
        acc = (zero, np.full(1, F.one, dtype=object), zero)
        for j in range(PX.shape[0] - 1, -1, -1):
            for _ in range(WINDOW):
                acc = _double_as_add(F, *acc)
            acc = _point_add(F, *acc, *(t[j : j + 1] for t in P))
        return tuple(F.tensor(t)[0] for t in acc)
    F = _PlainField(mod)
    zero = torch.zeros((1, mod.L), dtype=PX.dtype, device=PX.device)
    acc = (zero, mod.one_mont.reshape(1, -1), zero)
    for j in range(PX.shape[0] - 1, -1, -1):
        for _ in range(WINDOW):
            acc = _double_as_add(F, *acc)
        acc = _point_add(F, *acc, PX[j : j + 1], PY[j : j + 1],
                         PZ[j : j + 1])
    return tuple(t[0].contiguous() for t in acc)


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
                "vmn_ec_add": [I32, I32] + [P] * 10 + [U32, P, P, I64, I32,
                                                       I64, P],
                "vmn_ec_smul": [I32, I32] + [P] * 9 + [U32, P, P, I64, I32,
                                                       I32, I32, I64, P],
                "vmn_ec_chain": [I32, I32] + [P] * 8 + [U32, P, P, I32, P],
                "vmn_ec_mexp": [I32] + [P] * 7 + [U32, P, P, I64, I32, I32,
                                                  I32, I32, P],
                "vmn_ec_fb": [I32] + [P] * 8 + [U32, I64, I32, I32, P],
            }
            for name, args in sig.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _bound = lib
    return _bound


def _words(mod: Modulus, kernel: str) -> int:
    return K._words(mod, kernel, _WIDTHS)


def _operand(t, name, mod: Modulus, n: int) -> torch.Tensor:
    """An (n, L) coordinate as the kernels read it: row-major, padded to
    2W limbs at a padded modulus."""
    return K._padded(K._rows(t, name, mod.limbs.device, n, mod.L), mod)


def _results(n: int, mod: Modulus):
    """The three (n, 2W) coordinates a kernel writes."""
    return [torch.empty((n, 2 * mod.W), dtype=torch.int32,
                        device=mod.limbs.device) for _ in range(3)]


def _limb_major(x: torch.Tensor, name: str, device, cols: int
                ) -> torch.Tensor:
    """(cols, limbs) int32 on `device` -> its limb-major copy, as H7 reads
    it; raises on any other device, dtype or shape."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != cols:
        raise ValueError(
            f"{name}: expected int32 (N={cols}, limbs), got "
            f"{x.dtype} {tuple(x.shape)}"
        )
    return x.t().contiguous()


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
    """H8: batched Jacobian + Jacobian, six (N, L) -> three (N, L), the
    operands read as they lie (row-major)."""
    if K.on_host("ec_point_add", mod, x1, y1, z1, x2, y2, z2):
        return ec_point_add_plain(x1, y1, z1, x2, y2, z2, mod)
    N = x1.shape[0]
    w = _words(mod, "ec_point_add")
    ins = [_operand(t, name, mod, N) for t, name in zip(
        (x1, y1, z1, x2, y2, z2), ("x1", "y1", "z1", "x2", "y2", "z2"))]
    out = _results(N, mod)
    if N:
        t, threads, blocks = K.coop_launch("ec_point_add", w, N)
        K._check("ec_point_add", _library().vmn_ec_add(
            w, t, *map(K._ptr, ins), *map(K._ptr, out),
            K._ptr(mod.kernel_limbs), mod.mprime32, *K._conv_ptrs(mod), N,
            threads, blocks, K._stream(mod.limbs.device)))
        _launched("ec_point_add", N)
    return tuple(K._unpadded(o, mod) for o in out)


def ec_scalar_mul(x, y, inf, e, mod: Modulus, nbits: int):
    """H5: e·P per point; x, y (N, L) affine Montgomery form, inf (N,)
    bool, e (N, Le) standard limbs below 2^nbits -> Jacobian (N, L) x3."""
    if K.on_host("ec_scalar_mul", mod, x, y, inf, e):
        return ec_scalar_mul_plain(x, y, inf, e, mod, nbits)
    N = x.shape[0]
    w = _words(mod, "ec_scalar_mul")
    dev = mod.limbs.device
    ndig = max(1, -(-nbits // WINDOW))
    x = _operand(x, "x", mod, N)
    y = _operand(y, "y", mod, N)
    e = K._rows(e, "e", dev, N)  # digits past its limbs read as zero
    im = _mask(inf, dev, N)
    out = _results(N, mod)
    if N:
        t, threads, blocks = K.coop_launch("ec_scalar_mul", w, N)
        K._check("ec_scalar_mul", _library().vmn_ec_smul(
            w, t, K._ptr(x), K._ptr(y), K._ptr(im), K._ptr(e),
            *map(K._ptr, out), K._ptr(mod.kernel_limbs),
            K._ptr(mod.kernel_one), mod.mprime32, *K._conv_ptrs(mod), N,
            e.shape[1], ndig, threads, blocks, K._stream(dev)))
        _launched("ec_scalar_mul", N)
    return tuple(K._unpadded(o, mod) for o in out)


def ec_multiexp_positions(x, y, inf, e, mod: Modulus, nbits: int):
    """H6: per-digit-position sums S_j = sum_i d_ij·P_i, Jacobian
    (ndig_pad, L) x3 (see ec_multiexp_positions_plain)."""
    if K.on_host("ec_multiexp_positions", mod, x, y, inf, e):
        return ec_multiexp_positions_plain(x, y, inf, e, mod, nbits)
    N, L = x.shape[0], mod.L
    w = _words(mod, "ec_multiexp_positions")
    dev = mod.limbs.device
    ndig_pad = _ndig_pad(nbits)
    x = _operand(x, "x", mod, N)
    y = _operand(y, "y", mod, N)
    e = K._rows(e, "e", dev, N)  # digits past its limbs read as zero
    im = _mask(inf, dev, N)
    lib = _library()
    parts = []
    for s0 in range(0, N, EP_SUPER):
        n = min(EP_SUPER, N - s0)
        blocks, subs = mexp_shape(n, ndig_pad, w)
        out = torch.empty((3, ndig_pad, blocks * subs, 2 * w),
                          dtype=torch.int32, device=dev)
        K._check("ec_multiexp_positions", lib.vmn_ec_mexp(
            w, K._ptr(x[s0:]), K._ptr(y[s0:]), K._ptr(im[s0:]),
            K._ptr(e[s0:]), K._ptr(out), K._ptr(mod.kernel_limbs),
            K._ptr(mod.kernel_one), mod.mprime32, *K._conv_ptrs(mod), n,
            e.shape[1], ndig_pad, subs, blocks, K._stream(dev)))
        _launched("ec_multiexp_positions", n)
        parts.append(out[..., :L] if mod.conv else out)
    if not parts:
        zero = torch.zeros((ndig_pad, L), dtype=torch.int32, device=dev)
        return zero, mod.one_mont.expand(ndig_pad, L).contiguous(), zero
    P = torch.cat(parts, dim=2)
    return _lane_tree(P[0], P[1], P[2], mod, ec_point_add)


def ec_multiexp_combine(PX, PY, PZ, mod: Modulus):
    """sum_j 2^(4j)·S_j of (J, L) Jacobian positions -> one Jacobian
    point, (L,) x3, as one chain on one warp (see
    ec_multiexp_combine_plain)."""
    if K.on_host("ec_multiexp_combine", mod, PX, PY, PZ):
        return ec_multiexp_combine_plain(PX, PY, PZ, mod)
    J, L = PX.shape[0], mod.L
    w = _words(mod, "ec_multiexp_combine")
    dev = mod.limbs.device
    if J == 0:
        zero = torch.zeros(L, dtype=torch.int32, device=dev)
        return zero, mod.one_mont.clone(), zero.clone()
    ins = [_operand(t, name, mod, J)
           for t, name in zip((PX, PY, PZ), ("PX", "PY", "PZ"))]
    out = _results(1, mod)
    K._check("ec_multiexp_combine", _library().vmn_ec_chain(
        w, K.threads_per_element("ec_multiexp_combine", w, 1),
        *map(K._ptr, ins), *map(K._ptr, out), K._ptr(mod.kernel_limbs),
        K._ptr(mod.kernel_one), mod.mprime32, *K._conv_ptrs(mod), J,
        K._stream(dev)))
    _launched("ec_multiexp_combine", 1)
    return tuple(K._unpadded(o, mod)[0] for o in out)


def ec_multiexp(x, y, inf, e, mod: Modulus, nbits: int):
    """sum_i e_i·P_i -> one Jacobian point, (L,) x3 (K10): H6's
    positions, then their combine."""
    return ec_multiexp_combine(
        *ec_multiexp_positions(x, y, inf, e, mod, nbits), mod)


def ec_fb_exp(table_x, table_y, e, mod: Modulus):
    """H7: fixed-base e·P from the affine table (ndig, 16, L) of
    d·2^(4j)·P, e (N, Le) standard limbs -> Jacobian (N, L) x3."""
    if K.on_host("ec_fb_exp", mod, table_x, table_y, e):
        return ec_fb_exp_plain(table_x, table_y, e, mod)
    ndig, entries, L = table_x.shape
    if entries != ENTRIES or L != mod.L or table_y.shape != table_x.shape:
        raise ValueError(f"bad fixed-base table shape {tuple(table_x.shape)}")
    dev = mod.limbs.device
    for t in (table_x, table_y):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != dev:
            raise ValueError("tables must be contiguous int32 on the card")
    w = _words(mod, "ec_fb_exp")
    N = e.shape[0]
    eT = _limb_major(_pad_exponent(e, ndig), "e", dev, N)
    out = _out(L, N, e.device)
    if N:
        K._check("ec_fb_exp", _library().vmn_ec_fb(
            w, K._ptr(table_x), K._ptr(table_y), K._ptr(eT),
            *map(K._ptr, out), K._ptr(mod.limbs), K._ptr(mod.one_mont),
            mod.mprime32, N, eT.shape[0], ndig, K._stream(e.device)))
        _launched("ec_fb_exp", N)
    return _rows(out)

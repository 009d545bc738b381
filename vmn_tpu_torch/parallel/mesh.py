"""The ciphertext axis split over ranks, and the ops that cross blocks
(port of `vmn_tpu.parallel.mesh`).

The mix-net's scaling axis is N, the number of ciphertexts.  `vmn_tpu`
places each (N, L) limb tensor with N sharded over a 1-D
`jax.sharding.Mesh` and routes its Pallas kernels through `shard_map`.
Here a mesh is the ranks of the process group (`parallel.dist`), one
process and one device each, and a sharded tensor is a `ShardedLimbs`:
this rank's block of rows on its device, the global N and the block's
first row.  Blocks follow `numpy.array_split` (the first N mod s ranks
hold one row more); a block may be empty.

Cross-block work is explicit, as `shard_map` makes it:

* elementwise ops (`blockwise`: products, powers, fixed-base powers,
  modular adds, scalar multiples and point additions with their
  normalization) run the port's kernels on each block;
* reductions (`sharded_prod`, `sharded_sum`, `sharded_exp_prod`,
  `sharded_ec_prod`) reduce each block with the kernels (H4 and K7's
  combine for a multi-exponentiation), exchange one (L,) partial a rank
  and combine them with a small tree that every rank computes alike;
* scans (`sharded_prods_scan`, `sharded_rec_lin`) scan each block and
  compose it with the totals of the blocks before it;
* `row`, `shift_push` and `permute` move rows between blocks, and
  `gather` reads the whole array (the byte codec's and the Fiat–Shamir
  hashes' input).

Montgomery arithmetic and the group law are exact, so every block split
and tree shape gives the unsharded run's limbs.  An empty block launches
nothing and contributes the identity, but joins every exchange in the
same order as the others.  Any other op on a `ShardedLimbs` raises and
names the op: nothing gathers an array unasked.

The protocol layer stays agnostic: `GArray`/`FArray`/`PPArray`/
`ECArray` hold sharded limbs as they hold tensors, so sharding the
inputs of a session shards its mix.  Inside a session over sharded
ciphertexts (`rows_scope`), each draw of N rows from a host source
(prover randomness, the generators, the batching vector) reads the
whole stream and keeps this rank's rows, so that the next draw starts
where the unsharded run's does (`take_rows`).  A draw of a device PRF
(DeviceSource) is addressed by its draw index and row range, so each
rank expands its own block alone (`take_draw`), byte-equal to those
rows of the unsharded draw; an empty block launches nothing.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from vmn_tpu_torch.parallel import dist

CIPH_AXIS = "ciph"


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the ranks of the process group: `size` ranks, this
    one `rank`, computing on `device`."""

    size: int
    rank: int
    device: torch.device

    def counts(self, n: int) -> List[int]:
        """Rows of each rank's block of an N-row array."""
        q, r = divmod(n, self.size)
        return [q + (i < r) for i in range(self.size)]

    def block(self, n: int, rank: Optional[int] = None) -> tuple:
        """(first row, end row) of a rank's block (this rank's)."""
        counts = self.counts(n)
        rank = self.rank if rank is None else rank
        start = sum(counts[:rank])
        return start, start + counts[rank]

    def owner(self, n: int, i: int) -> int:
        """The rank whose block holds row i."""
        start = 0
        for r, c in enumerate(self.counts(n)):
            if i < start + c:
                return r
            start += c
        raise IndexError(f"row {i} of {n}")


def ciph_mesh(n_ranks: Optional[int] = None, device=None) -> Mesh:
    """The mesh over every rank of the process group (one rank without
    `dist.init_from_env`)."""
    size, rank = dist.world_size(), dist.process_index()
    if n_ranks is not None and n_ranks != size:
        raise ValueError(f"a mesh spans all {size} ranks, not {n_ranks}")
    dev = dist.device()
    if dev is None or device is not None:
        dev = dist.rank_device(rank, device)
    return Mesh(size, rank, dev)


make_mesh = ciph_mesh


class ShardedLimbs:
    """This rank's block of an (N, ...) tensor whose axis 0 is split over
    a mesh: `local` holds rows [start, start + len(local)) of the N."""

    __slots__ = ("local", "n", "start", "mesh")

    def __init__(self, local: torch.Tensor, n: int, start: int, mesh: Mesh):
        if local.dim() < 1:
            raise ValueError("a sharded tensor has a row axis")
        self.local = local
        self.n = n
        self.start = start
        self.mesh = mesh

    @property
    def shape(self) -> torch.Size:
        return torch.Size((self.n,) + tuple(self.local.shape[1:]))

    def dim(self) -> int:
        return self.local.dim()

    @property
    def device(self) -> torch.device:
        return self.local.device

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @property
    def rows(self) -> int:
        return int(self.local.shape[0])

    @property
    def stop(self) -> int:
        return self.start + self.rows

    def like(self, local: torch.Tensor) -> "ShardedLimbs":
        """A tensor of this one's block, rows and mesh."""
        if local.dim() < 1 or local.shape[0] != self.rows:
            raise ValueError(f"block of {tuple(local.shape)}, expected "
                             f"{self.rows} rows")
        return ShardedLimbs(local, self.n, self.start, self.mesh)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", str(func))
        raise NotImplementedError(
            f"torch.{name} is not defined on a sharded array "
            "(vmn_tpu_torch.parallel.mesh routes the ops that are)")

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        raise AttributeError(
            f"'{name}' is not defined on a sharded array "
            "(vmn_tpu_torch.parallel.mesh routes the ops that are)")

    def __getitem__(self, idx):
        raise NotImplementedError(
            "indexing is not defined on a sharded array: mesh.row, "
            "mesh.permute or mesh.gather name the exchange")

    def __repr__(self):
        return (f"ShardedLimbs(rows {self.start}:{self.stop} of "
                f"{tuple(self.shape)}, rank {self.mesh.rank} of "
                f"{self.mesh.size}, {self.device})")


def is_sharded(t) -> bool:
    return isinstance(t, ShardedLimbs)


def shard_limbs(limbs: torch.Tensor, mesh: Mesh):
    """This rank's block of an (N, ...) tensor that every rank holds; the
    tensor itself on a one-rank mesh."""
    if isinstance(limbs, ShardedLimbs) or mesh.size == 1:
        return limbs
    n = int(limbs.shape[0])
    a, b = mesh.block(n)
    return ShardedLimbs(limbs[a:b].clone(), n, a, mesh)


shard_garray = shard_limbs


def shard_array(arr, mesh: Mesh):
    """Shard a GArray/FArray/PPArray/PPFArray/ECArray over the mesh (N
    axis)."""
    from vmn_tpu_torch.arith.ec import ECArray
    from vmn_tpu_torch.arith.pgroup import FArray, GArray, PPArray, PPFArray

    if isinstance(arr, (PPArray, PPFArray)):
        return type(arr)(
            arr.parent, tuple(shard_array(c, mesh) for c in arr.components))
    if isinstance(arr, GArray):
        return GArray(arr.grp, shard_limbs(arr.limbs, mesh))
    if isinstance(arr, FArray):
        return FArray(arr.field, shard_limbs(arr.limbs, mesh))
    if isinstance(arr, ECArray):
        return ECArray(arr.grp, *(shard_limbs(t, mesh)
                                  for t in (arr.x, arr.y, arr.inf)))
    raise TypeError(f"cannot shard {type(arr)!r}")


def gather(t: ShardedLimbs) -> torch.Tensor:
    """The whole (N, ...) tensor on every rank, on this rank's device."""
    got = dist.exchange(t.local, t.mesh.counts(t.n))
    return torch.cat(got).to(t.device)


def replicate(x, mesh: Optional[Mesh] = None):
    """A tensor every rank holds whole: a sharded one gathered, any other
    as it is."""
    return gather(x) if isinstance(x, ShardedLimbs) else x


def array_mesh(arr) -> Optional[tuple]:
    """(mesh, N) of the first sharded tensor of a group array (GArray,
    FArray, ECArray, their product arrays), or None."""
    for c in getattr(arr, "components", ()):
        got = array_mesh(c)
        if got is not None:
            return got
    for name in ("limbs", "x"):
        t = getattr(arr, name, None)
        if isinstance(t, ShardedLimbs):
            return t.mesh, t.n
    return None


# ------------------------------------------------------------ draw scope

_SCOPE = threading.local()


@contextlib.contextmanager
def rows_scope(mesh: Mesh, n: int):
    """Within it, `take_rows` keeps this rank's block of each N-row draw
    (thread-local)."""
    prev = getattr(_SCOPE, "value", None)
    _SCOPE.value = (mesh, n)
    try:
        yield
    finally:
        _SCOPE.value = prev


def take_rows(full, n: int, to_tensor):
    """to_tensor(rows) of a draw of n rows (a host array or a tensor):
    this rank's block as a ShardedLimbs inside a `rows_scope` of n rows,
    all of them otherwise."""
    scope = getattr(_SCOPE, "value", None)
    if scope is None or scope[1] != n or scope[0].size == 1:
        return to_tensor(full)
    mesh = scope[0]
    a, b = mesh.block(n)
    return ShardedLimbs(to_tensor(full[a:b]), n, a, mesh)


def take_draw(n: int, draw):
    """draw(rows) of a device draw of n rows, `rows` a (first, end) range
    or None for all: this rank's block, expanded alone, as a
    ShardedLimbs inside a `rows_scope` of n rows; the whole draw
    otherwise."""
    scope = getattr(_SCOPE, "value", None)
    if scope is None or scope[1] != n or scope[0].size == 1:
        return draw(None)
    mesh = scope[0]
    a, b = mesh.block(n)
    return ShardedLimbs(draw((a, b)), n, a, mesh)


# ------------------------------------------------------------ elementwise


def _ref(*args) -> ShardedLimbs:
    for a in args:
        if isinstance(a, ShardedLimbs):
            return a
    raise ValueError("no sharded operand")


def _split(ref: ShardedLimbs, t):
    """An operand's rows for ref's block: a sharded one's own block, a
    whole one's rows [start, stop) where it has ref's dims and N rows,
    anything else (a scalar, a broadcast row) as it is."""
    if isinstance(t, ShardedLimbs):
        if t.n != ref.n or t.mesh != ref.mesh:
            raise ValueError(f"operands sharded differently: {t!r}, {ref!r}")
        return t.local
    if (isinstance(t, torch.Tensor) and t.dim() == ref.dim()
            and t.shape[0] == ref.n):
        return t[ref.start:ref.stop]
    return t


def blockwise(fn, *args):
    """fn on this rank's block of each operand (`_split`); its tensor (or
    tuple of tensors) of the block's rows comes back sharded alike."""
    ref = _ref(*args)
    out = fn(*(_split(ref, a) for a in args))
    if isinstance(out, tuple):
        return tuple(ref.like(o) for o in out)
    return ref.like(out)


def sharded_mul(ctx, a, b):
    """(N, L) x (N, L) Montgomery product, N sharded (H1 on each block)."""
    return blockwise(ctx.mul, a, b)


def sharded_exp(ctx, base, e, nbits: int):
    """base^e elementwise, N sharded (H2 on each block)."""
    return blockwise(lambda b, x: ctx.exp(b, x, nbits), base, e)


def sharded_fb_exp(ctx, base_int: int, e: ShardedLimbs, nbits: int):
    """Fixed-base power of a shared base: the table on every rank, the
    exponents sharded (H3 on each block; an empty block builds no
    table)."""
    if not e.rows:
        return e.like(torch.empty((0,) + tuple(e.shape[1:-1]) + (ctx.L,),
                                  dtype=torch.int32, device=e.device))
    return e.like(ctx.exp_fixed(base_int, e.local, nbits))


# ------------------------------------------------------------ reductions


def _partials(part: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Each rank's (...) partial, stacked (size, ...) on every rank."""
    got = dist.exchange(part[None], [1] * mesh.size)
    return torch.cat(got).to(part.device)


def _one(ctx, t: ShardedLimbs) -> torch.Tensor:
    return ctx.one_mont.expand(tuple(t.shape[1:])).contiguous()


def sharded_prod(ctx, x: ShardedLimbs) -> torch.Tensor:
    """Montgomery product over the sharded axis 0: each block's H1 tree,
    then the tree of the partials (replicated result)."""
    part = ctx.prod(x.local) if x.rows else _one(ctx, x)
    return ctx.prod(_partials(part, x.mesh))


def sharded_sum(ctx, x: ShardedLimbs) -> torch.Tensor:
    """Modular sum over the sharded axis 0 (replicated result)."""
    part = ctx.sum(x.local) if x.rows else torch.zeros(
        tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return ctx.sum(_partials(part, x.mesh))


def sharded_exp_prod(ctx, bases, e, nbits: int) -> torch.Tensor:
    """prod_i b_i^{e_i} with N sharded: each block's H4 + K7's combine,
    one (L,) partial a rank, an H1 tree of the partials (replicated)."""
    ref = _ref(bases, e)
    b, x = _split(ref, bases), _split(ref, e)
    part = ctx.expprod(b, x, nbits) if ref.rows else _one(ctx, ref)
    return ctx.prod(_partials(part, ref.mesh))


def sharded_prods_scan(ctx, x: ShardedLimbs) -> ShardedLimbs:
    """Inclusive cumulative Montgomery product over the sharded axis 0:
    each block's scan times the product of the earlier blocks' totals."""
    y = ctx.prods_scan(x.local)
    total = y[-1] if x.rows else _one(ctx, x)
    totals = _partials(total, x.mesh)
    if x.mesh.rank == 0 or not x.rows:
        return x.like(y)
    return x.like(ctx.mul(y, ctx.prod(totals[: x.mesh.rank])))


def sharded_rec_lin(ctx, mm, aa) -> ShardedLimbs:
    """x_i = x_{i-1}·e_i + b_i over the sharded axis 0: each block's
    affine scan from x_in = 0, then x_in composed from the earlier
    blocks' (M_total, A_last) pairs: x_i = A_loc_i + x_in·M_pref_i."""
    ref = _ref(mm, aa)
    m, a = _split(ref, mm), _split(ref, aa)
    a_loc = ctx.rec_lin(m, a)
    m_pref = ctx.prods_scan(m)
    if ref.rows:
        m_last, a_last = m_pref[-1], a_loc[-1]
    else:
        m_last = _one(ctx, ref)
        a_last = torch.zeros_like(m_last)
    ms = _partials(m_last, ref.mesh)
    as_ = _partials(a_last, ref.mesh)
    if ref.mesh.rank == 0 or not ref.rows:
        return ref.like(a_loc)
    counts = ref.mesh.counts(ref.n)
    x_in = torch.zeros_like(a_last)
    for j in range(ref.mesh.rank):
        if counts[j]:
            x_in = ctx.add(ctx.mul(ms[j], x_in), as_[j])
    return ref.like(ctx.add(ctx.mul(m_pref, x_in), a_loc))


# ------------------------------------------------------------ row moves


def row(t: ShardedLimbs, i: int) -> torch.Tensor:
    """Row i of the whole array, on every rank (one exchange)."""
    if not -t.n <= i < t.n:
        raise IndexError(f"row {i} of {t.n}")
    i %= t.n
    owner = t.mesh.owner(t.n, i)
    counts = [int(r == owner) for r in range(t.mesh.size)]
    mine = t.local[i - t.start: i - t.start + 1] if owner == t.mesh.rank \
        else t.local[:0]
    return dist.exchange(mine, counts)[owner][0].to(t.device)


def shift_push(t: ShardedLimbs, first: torch.Tensor) -> ShardedLimbs:
    """[first, x_0, ..., x_{N-2}]: each block takes the row before it
    from the previous non-empty block (one exchange of last rows)."""
    counts = [int(c > 0) for c in t.mesh.counts(t.n)]
    lasts = dist.exchange(t.local[-1:] if t.rows else t.local[:0], counts)
    if not t.rows:
        return t
    if t.start == 0:
        head = first.reshape((1,) + tuple(t.shape[1:]))
    else:
        head = lasts[t.mesh.owner(t.n, t.start - 1)].to(t.device)
    return t.like(torch.cat([head, t.local[:-1]]))


def permute(t: ShardedLimbs, tbl: np.ndarray) -> ShardedLimbs:
    """out[i] = in[tbl[i]] for this block's rows i: the whole array is
    exchanged, each rank keeps the rows its block names."""
    full = gather(t)
    idx = torch.from_numpy(np.asarray(tbl[t.start:t.stop], np.int64))
    return t.like(full[idx.to(t.device)])


# ------------------------------------------------------------ EC routes


def _points(ref: ShardedLimbs, x, y, inf) -> tuple:
    """A point array's (x, y, inf) for ref's block: sharded ones' blocks,
    a whole (N, L) one's rows, a single point as it is."""
    if isinstance(x, ShardedLimbs):
        return _split(ref, x), _split(ref, y), _split(ref, inf)
    if x.dim() == 2 and x.shape[0] == ref.n:
        return (x[ref.start:ref.stop], y[ref.start:ref.stop],
                inf[ref.start:ref.stop])
    return x, y, inf


def sharded_ec_smul(curve, x, y, inf, e, nbits: int) -> tuple:
    """e_i·P_i with N sharded: H5 on each block, then the block's
    normalization (its own batched inversion); affine (x, y, inf)."""
    from vmn_tpu_torch.arith.ec import _scalar_mul

    ref = _ref(x, e)
    px = _points(ref, x, y, inf)
    return tuple(ref.like(t) for t in
                 _scalar_mul(curve, *px, _split(ref, e), nbits))


def sharded_ec_add(curve, p, q) -> tuple:
    """P_i + Q_i of two (x, y, inf) point arrays, N sharded: H8 on each
    block, then its normalization."""
    from vmn_tpu_torch.arith.ec import _add_points

    ref = _ref(*p, *q)
    return tuple(ref.like(t) for t in
                 _add_points(curve, _points(ref, *p), _points(ref, *q)))


def sharded_ec_prod(curve, x, y, inf) -> tuple:
    """Sum of a sharded point array: each block's H8 tree, one Jacobian
    partial a rank (infinity for an empty block), the tree of the
    partials, one normalization (replicated)."""
    from vmn_tpu_torch.arith.ec import _jac, _tree

    ref = _ref(x)
    if ref.rows:
        part = _tree(curve, *_jac(curve, x.local, y.local, inf.local))
    else:
        zero = torch.zeros(tuple(x.shape[1:]), dtype=x.dtype,
                           device=x.device)
        part = (zero, zero, zero)
    X, Y, Z = (_partials(t, ref.mesh) for t in part)
    return curve.normalize(*_tree(curve, X, Y, Z))

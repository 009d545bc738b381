"""Prime-order group / field / product layer over batched limb tensors
(port of `vmn_tpu.arith.pgroup`).

* `GArray`: ``(..., L)`` int32 limb tensor in Montgomery form plus its
  `ModPGroup`; the leading axis is the ciphertext batch N, scalars are
  ``(L,)``.
* `FArray`: standard-form limb tensor over the field Z_q of exponents.
* `PPGroup`/`PPRing` and their arrays are tuples of component arrays
  (the El Gamal ciphertext is ``PPArray((u, v))``).

The device is explicit: `ModPGroup.named(name, device=...)` builds the
group's Montgomery constants on that device — the card unless the caller
asks for ``device="cpu"`` — and every array of the group lives there.  Byte-tree encodings follow `vmn_tpu` (fixed-size
unsigned big-endian leaves of ``p.bit_length()//8 + 1`` bytes).

An array's limbs may be a `parallel.mesh.ShardedLimbs`, this rank's
block of its N rows: the Montgomery ops route through `MontCtx`, the row
moves (`get`, `shift_push`, `permute`, `rec_lin`'s last row) through
`parallel.mesh`, byte-tree export gathers, and within a session over
sharded ciphertexts each N-row draw keeps this rank's rows
(`mesh.take_rows`; a device draw expands those rows alone,
`mesh.take_draw`).
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vmn_tpu_torch.arith.limbs import (
    LIMB_BITS,
    bytes_be_to_limbs,
    int_to_limbs,
    ints_to_limbs,
    limbs_to_bytes_be,
    limbs_to_int,
    limbs_to_ints,
    num_limbs,
)
from vmn_tpu_torch.arith import storage
from vmn_tpu_torch.arith.mont import MontCtx, device_limbs, host_limbs
from vmn_tpu_torch.eio.bytetree import (
    ByteTree,
    ByteTreeError,
    array_leaf_node,
    int_leaf,
    leaf,
    node,
    parse_uniform_array,
    signed_int_leaf,
)
from vmn_tpu_torch.native.build import get_lib, jacobi_batch
from vmn_tpu_torch.ops.mont_kernels import mont_expprod_positions
from vmn_tpu_torch.parallel import mesh as pmesh


def _bytelen(n: int) -> int:
    """Java BigInteger.toByteArray() length for a positive integer n."""
    return n.bit_length() // 8 + 1


# ------------------------------------------------- deferred membership
#
# Inside a `deferred_membership` scope, `elem_from_bytetree` hands its
# subgroup-membership predicate to the collector instead of evaluating it
# inline; the standalone verifier joins the results before its verdict
# and reruns eagerly on any failure.

_DEFER_TLS = threading.local()


class deferred_membership:
    """Context manager routing membership checks to `submit(thunk)`.

    `submit` receives zero-arg callables returning bool and must return
    a handle with `.result()` (e.g. concurrent.futures).  Thread-local."""

    def __init__(self, submit):
        self.submit = submit

    def __enter__(self):
        self._prev = getattr(_DEFER_TLS, "hook", None)
        _DEFER_TLS.hook = self.submit
        return self

    def __exit__(self, *exc):
        _DEFER_TLS.hook = self._prev
        return False


def _range_check_be(raw: np.ndarray, p: int, bytelen: int,
                    allow_zero: bool = False) -> bool:
    """Vectorized check that every (bytelen,)-row satisfies 0 < x < p
    (0 <= x < p with allow_zero, for EC coordinates)."""
    pb = np.frombuffer(p.to_bytes(bytelen, "big"), np.uint8)
    diff = raw.astype(np.int16) - pb.astype(np.int16)
    first_nz = (diff != 0).argmax(axis=1)
    lt = diff[np.arange(raw.shape[0]), first_nz] < 0
    if allow_zero:
        return bool(lt.all())
    return bool((lt & raw.any(axis=1)).all())


def _row(t, i: int):
    """Row i of a limb tensor, sharded or not."""
    return pmesh.row(t, i) if pmesh.is_sharded(t) else t[i]


def _shift_push(t, first):
    """[first, t_0, ..., t_{N-2}] of a limb tensor, sharded or not."""
    if pmesh.is_sharded(t):
        return pmesh.shift_push(t, first)
    return torch.cat([first.reshape((1,) + tuple(t.shape[1:])), t[:-1]])


def _permute(t, pi: "Permutation"):
    """out[i] = t[pi.tbl[i]] of a limb tensor, sharded or not."""
    if pmesh.is_sharded(t):
        return pmesh.permute(t, pi.tbl)
    return t[pi.index(t.device)]


def _masked_raw(src, n: int, bits: int) -> np.ndarray:
    """n uniform `bits`-bit integers as (n, nbytes) big-endian rows."""
    nbytes = (bits + 7) // 8
    raw = np.frombuffer(src.read_bytes(n * nbytes), np.uint8).reshape(
        n, nbytes
    )
    extra = 8 * nbytes - bits
    if extra:
        raw = raw.copy()
        raw[:, 0] &= 0xFF >> extra
    return raw


# =====================================================================
# Permutation
# =====================================================================


class Permutation:
    """A permutation of {0..n-1}: ``out[i] = in[tbl[i]]`` under
    `GArray.permute` (host numpy index vector)."""

    def __init__(self, tbl: np.ndarray):
        self.tbl = np.asarray(tbl, dtype=np.int64)

    @property
    def size(self) -> int:
        return int(self.tbl.shape[0])

    @staticmethod
    def random(n: int, randomsource) -> "Permutation":
        """Uniform random permutation: exact Fisher–Yates for n <= 4096,
        argsort of 128-bit random keys above."""
        if n <= 4096:
            tbl = np.arange(n, dtype=np.int64)
            for i in range(n - 1, 0, -1):
                j = randomsource.random_int_mod(i + 1)
                tbl[i], tbl[j] = tbl[j], tbl[i]
            return Permutation(tbl)
        raw = np.frombuffer(randomsource.read_bytes(16 * n), np.uint64)
        keys = raw.reshape(n, 2)
        order = np.lexsort((keys[:, 1], keys[:, 0]))
        return Permutation(order.astype(np.int64))

    @staticmethod
    def identity(n: int) -> "Permutation":
        return Permutation(np.arange(n, dtype=np.int64))

    def inv(self) -> "Permutation":
        out = np.empty_like(self.tbl)
        out[self.tbl] = np.arange(self.tbl.shape[0], dtype=np.int64)
        return Permutation(out)

    def shrink(self, n: int) -> "Permutation":
        """Restriction keeping the relative order of the images < n
        (reference: Permutation.shrink, used by the maxciph shrink)."""
        return Permutation(self.tbl[self.tbl < n])

    def index(self, device) -> torch.Tensor:
        return torch.from_numpy(self.tbl).to(device)

    def to_bytetree(self) -> ByteTree:
        return node(*[int_leaf(int(i)) for i in self.tbl])

    @staticmethod
    def from_bytetree(bt: ByteTree) -> "Permutation":
        tbl = np.asarray([c.to_u32() for c in bt.children], dtype=np.int64)
        return Permutation(tbl)


# =====================================================================
# Field of exponents  Z_q
# =====================================================================


class PField:
    """Prime field Z_q — the ring of exponents of a prime-order group."""

    def __init__(self, q: int, device="cuda"):
        self.q = q
        self.ctx = MontCtx(q, device)
        self.device = self.ctx.device
        self.L = self.ctx.L
        self.bytelen = _bytelen(q)
        self.nbits = q.bit_length()

    def _limbs(self, arr) -> torch.Tensor:
        return device_limbs(arr, self.device)

    # ------------------------------------------------------------ build

    def zeros(self, shape=()) -> "FArray":
        return FArray(self, torch.zeros(tuple(shape) + (self.L,),
                                        dtype=torch.int32, device=self.device))

    def ones(self, shape=()) -> "FArray":
        return FArray(self, self.ctx.one.expand(tuple(shape) + (self.L,)))

    def from_ints(self, xs: Sequence[int]) -> "FArray":
        return FArray(self, self._limbs(
            ints_to_limbs([x % self.q for x in xs], self.L)))

    def from_int(self, x: int) -> "FArray":
        return FArray(self, self._limbs(int_to_limbs(x % self.q, self.L)))

    def random(self, shape, randomsource, rbitlen: int) -> "FArray":
        """(nbits+rbitlen)-bit uniform integers reduced mod q
        (reference: PRing.randomElementArray semantics)."""
        shape = tuple(shape)
        n = int(np.prod(shape)) if shape else 1
        wide = self.random_bits_raw(n, self.nbits + rbitlen, randomsource,
                                    rows=len(shape) == 1)
        arr = self.ctx.reduce_std(wide)
        if len(shape) != 1:
            arr = arr.reshape(shape + (self.L,))
        return FArray(self, arr)

    def random_bits_raw(self, n: int, bits: int, randomsource,
                        rows: bool = True):
        """n uniform `bits`-bit integers as (n, Lw) standard limbs (an
        array of n rows: this rank's block inside a sharded session).
        A source with a device PRF (DeviceSource) expands the draw on
        this field's device, as `vmn_tpu` hands it over
        (vmn_tpu/arith/pgroup.py:218): no host bytes, no upload; inside
        a sharded session only this rank's rows are expanded."""
        Lw = max(self.L, num_limbs(bits))
        device_draw = getattr(randomsource, "random_limbs", None)
        if device_draw is not None:
            def block(r):
                t = device_draw(n, bits, self.device, rows=r)
                if t.shape[1] == Lw:
                    return t
                return torch.constant_pad_nd(t, (0, Lw - t.shape[1]))

            return pmesh.take_draw(n, block) if rows else block(None)
        raw = _masked_raw(randomsource, n, bits)

        def limbs(r):
            return self._limbs(bytes_be_to_limbs(r, Lw))

        return pmesh.take_rows(raw, n, limbs) if rows else limbs(raw)

    def random_bits(self, n: int, bits: int, randomsource) -> "FArray":
        """n uniform `bits`-bit integers as field elements, reduced mod q
        when they can exceed it."""
        raw = self.random_bits_raw(n, bits, randomsource)
        if bits >= self.nbits:
            return FArray(self, self.ctx.reduce_std(raw))
        return FArray(self, raw)

    def random_bits_prg(self, n: int, ebitlen: int, prg) -> "FArray":
        """Batching vector: n integers of `ebitlen` bits from a PRG
        (reference: PoSBasicTW.setBatchVector)."""
        raw = _masked_raw(prg, n, ebitlen)
        Lw = max(self.L, num_limbs(ebitlen)) if ebitlen >= self.nbits \
            else self.L
        limbs = pmesh.take_rows(
            raw, n, lambda r: self._limbs(bytes_be_to_limbs(r, Lw)))
        if ebitlen >= self.nbits:
            return FArray(self, self.ctx.reduce_std(limbs))
        return FArray(self, limbs)

    # --------------------------------------------------------- serialize

    def to_bytetree(self, fa: "FArray") -> ByteTree:
        """Array -> node of fixed-size leaves; scalar -> single leaf."""
        arr = host_limbs(fa.limbs)
        if arr.ndim == 1:
            return leaf(
                limbs_to_bytes_be(arr[None], self.bytelen)[0].tobytes()
            )
        b = limbs_to_bytes_be(arr.reshape(-1, self.L), self.bytelen)
        return node(*[leaf(b[i].tobytes()) for i in range(b.shape[0])])

    def from_bytetree(self, bt: ByteTree, size: Optional[int] = None):
        if bt.is_leaf:
            x = bt.to_int_unsigned()
            if x >= self.q:
                raise ByteTreeError("field element out of range")
            return self.from_int(x)
        if size is not None and len(bt.children) != size:
            raise ByteTreeError("wrong field array length")
        raw = parse_uniform_array(bt)
        if raw is not None and raw.shape[1] == self.bytelen:
            qb = np.frombuffer(self.q.to_bytes(self.bytelen, "big"),
                               np.uint8)
            diff = raw.astype(np.int16) - qb.astype(np.int16)
            first_nz = (diff != 0).argmax(axis=1)
            lt = diff[np.arange(raw.shape[0]), first_nz] < 0
            if not lt.all():
                raise ByteTreeError("field element out of range")
            fa = FArray(self, self._limbs(bytes_be_to_limbs(raw, self.L)))
            fa._bt = bt  # canonical encoding == input
            return fa
        xs = [c.to_int_unsigned() for c in bt.children]
        if any(x >= self.q for x in xs):
            raise ByteTreeError("field element out of range")
        return FArray(self, self._limbs(ints_to_limbs(xs, self.L)))

    def __eq__(self, other):
        return isinstance(other, PField) and other.q == self.q

    def __repr__(self):
        return f"PField({self.nbits} bits)"


class FArray:
    """Array (or scalar) of field elements in standard form."""

    __slots__ = ("field", "limbs", "_bt")

    def __init__(self, field: PField, limbs: torch.Tensor):
        self.field = field
        self.limbs = limbs
        self._bt = None

    @property
    def shape(self):
        return tuple(self.limbs.shape[:-1])

    @property
    def size(self) -> int:
        return int(self.limbs.shape[0])

    def __len__(self):
        return self.size

    def get(self, i: int) -> "FArray":
        return FArray(self.field, _row(self.limbs, i))

    def copy_of_range(self, a: int, b: int) -> "FArray":
        return FArray(self.field, self.limbs[a:b])

    def to_ints(self) -> List[int]:
        return limbs_to_ints(host_limbs(self.limbs))

    def spill(self) -> "FArray":
        """The array with its limbs on disk when arrays=file; an op loads
        them whole onto the field's device (`arith/storage.py`)."""
        if isinstance(self, _SpilledFArray):
            return self
        limbs = storage.maybe_spill(self.limbs)
        if limbs is self.limbs:
            return self
        return _SpilledFArray(self.field, limbs)

    def to_int(self) -> int:
        if self.limbs.dim() != 1:
            raise ValueError("not a scalar")
        return limbs_to_int(host_limbs(self.limbs))

    # --------------------------------------------------------------- ops

    def _f(self, other) -> "FArray":
        if isinstance(other, FArray):
            return other
        return self.field.from_int(other)

    def add(self, other) -> "FArray":
        o = self._f(other)
        return FArray(self.field, self.field.ctx.add(self.limbs, o.limbs))

    def sub(self, other) -> "FArray":
        o = self._f(other)
        return FArray(self.field, self.field.ctx.sub(self.limbs, o.limbs))

    def neg(self) -> "FArray":
        return FArray(self.field, self.field.ctx.neg(self.limbs))

    def mul(self, other) -> "FArray":
        """Standard-form product: one extra Montgomery conversion."""
        o = self._f(other)
        c = self.field.ctx
        return FArray(self.field, c.mul(c.to_mont(self.limbs), o.limbs))

    def mul_add(self, v: "FArray", t: "FArray") -> "FArray":
        """self * v + t (reference: PRingElement.mulAdd)."""
        return self.mul(v).add(t)

    def inv(self) -> "FArray":
        c = self.field.ctx
        return FArray(self.field, c.from_mont(c.inv(c.to_mont(self.limbs))))

    def sum(self) -> "FArray":
        return FArray(self.field, self.field.ctx.sum(self.limbs, axis=0))

    def prod(self) -> "FArray":
        c = self.field.ctx
        return FArray(self.field,
                      c.from_mont(c.prod(c.to_mont(self.limbs), axis=0)))

    def inner_product(self, other: "FArray") -> "FArray":
        return self.mul(other).sum()

    def prods(self) -> "FArray":
        """Cumulative products e_0, e_0e_1, ... (reference:
        PRingElementArray.prods)."""
        c = self.field.ctx
        return FArray(self.field,
                      c.from_mont(c.prods_scan(c.to_mont(self.limbs))))

    def rec_lin(self, e: "FArray") -> Tuple["FArray", "FArray"]:
        """x_0 = b_0; x_i = x_{i-1} e_i + b_i.  Returns (x, x_{N-1})
        (reference: PRingElementArray.recLin)."""
        c = self.field.ctx
        x = c.rec_lin(c.to_mont(e.limbs), self.limbs)
        return FArray(self.field, x), FArray(self.field, _row(x, -1))

    def shift_push(self, first: "FArray") -> "FArray":
        """[first, x_0, ..., x_{N-2}]."""
        return FArray(self.field, _shift_push(self.limbs, first.limbs))

    def permute(self, pi: Permutation) -> "FArray":
        return FArray(self.field, _permute(self.limbs, pi))

    def concat(self, other: "FArray") -> "FArray":
        return FArray(self.field, torch.cat([self.limbs, other.limbs]))

    def equals(self, other: "FArray") -> bool:
        return bool(torch.equal(self.limbs, other.limbs))

    def to_bytetree(self) -> ByteTree:
        if self._bt is None:
            self._bt = self.field.to_bytetree(self)
        return self._bt

    def __repr__(self):
        return f"FArray(shape={self.shape}, {self.field})"


_SpilledFArray = storage.spilled_class(FArray, ("limbs",))


# =====================================================================
# Multiplicative group  (safe-prime subgroup)
# =====================================================================


class ModPGroup:
    """Subgroup of prime order q of Z_p^* (reference: arithm.ModPGroup);
    for a safe prime p = 2q+1 the quadratic residues, co-order 2."""

    MARSHAL_NAME = "com.verificatum.arithm.ModPGroup"

    # Device quadratic-residuosity test from this many elements of a CUDA
    # array up; host Jacobi below (ROADMAP: the floor is still to be
    # measured on the H100 host).
    QR_DEVICE_FLOOR = 4096
    # 100 independent 4-bit digit positions -> soundness 2^-100
    _QR_BITS = 400

    def __init__(self, p: int, q: int, g: int, encoding: int = 1,
                 device="cuda"):
        if (p - 1) % q != 0:
            raise ValueError("q must divide p-1")
        self.p = p
        self.q = q
        self.g_int = g
        self.encoding = encoding
        self.coorder = (p - 1) // q
        self.ctx = MontCtx(p, device)
        self.device = self.ctx.device
        self.L = self.ctx.L
        self.nbits = p.bit_length()
        self.bytelen = _bytelen(p)
        self.ring = PField(q, device)
        self._g = None
        self._p_bytes = p.to_bytes((p.bit_length() + 7) // 8, "big")

    _NAMED = {}

    @classmethod
    def named(cls, name: str, device="cuda") -> "ModPGroup":
        key = (name, str(torch.device(device)))
        grp = cls._NAMED.get(key)
        if grp is None:
            p, g = _NAMED_GROUPS[name]
            grp = cls(p, (p - 1) // 2, g, device=device)
            cls._NAMED[key] = grp
        return grp

    # ------------------------------------------------------------ build

    @property
    def g(self) -> "GArray":
        if self._g is None:
            self._g = self.from_ints([self.g_int]).get(0)
        return self._g

    def one(self, shape=()) -> "GArray":
        return GArray(self, self.ctx.one_mont.expand(tuple(shape) + (self.L,)))

    def from_ints(self, xs: Sequence[int]) -> "GArray":
        return GArray(self, self.ctx.encode([x % self.p for x in xs]))

    def random_array(self, n: int, prg, rbitlen: int) -> "GArray":
        """n group elements from a PRG byte stream: (nbits+rbitlen)-bit
        integers mod p raised to the co-order (reference:
        ModPGroup.randomElementArray, IndependentGeneratorsRO.java:129)."""
        bits = self.nbits + rbitlen
        raw = _masked_raw(prg, n, bits)
        Lw = max(self.L, num_limbs(bits))
        wide = pmesh.take_rows(raw, n, lambda r: device_limbs(
            bytes_be_to_limbs(r, Lw), self.device))
        base = self.ctx.to_mont(self.ctx.reduce_std(wide))
        # the co-order's own limbs (vmn_tpu takes 64 bits, and raises for
        # a co-order above them: README, the port's deviations)
        e = device_limbs(int_to_limbs(
            self.coorder, num_limbs(max(64, self.coorder.bit_length()))),
            self.device)
        return GArray(self, self.ctx.exp(base, e, self.coorder.bit_length()))

    # --------------------------------------------------------- serialize

    def elem_to_bytetree(self, ga: "GArray") -> ByteTree:
        arr = host_limbs(self.ctx.from_mont(ga.limbs))
        if arr.ndim == 1:
            return leaf(limbs_to_bytes_be(arr[None], self.bytelen)[0]
                        .tobytes())
        return array_leaf_node(
            limbs_to_bytes_be(arr.reshape(-1, self.L), self.bytelen)
        )

    def elem_from_bytetree(self, bt: ByteTree, size: Optional[int] = None,
                           validate: bool = True) -> "GArray":
        """Parse an element/array and check subgroup membership
        (reference: ModPGroup.toElementArray)."""
        scalar = bt.is_leaf
        if scalar:
            if len(bt.data) != self.bytelen:
                raise ByteTreeError("wrong element byte length")
            raw = np.frombuffer(bt.data, np.uint8)[None]
        else:
            raw = parse_uniform_array(bt)
            if raw is None or raw.shape[1] != self.bytelen:
                raise ByteTreeError("malformed element array")
            if size is not None and raw.shape[0] != size:
                raise ByteTreeError(
                    f"wrong array length {raw.shape[0]} != {size}"
                )
        if not _range_check_be(raw, self.p, self.bytelen):
            raise ByteTreeError("element out of range")
        limbs = bytes_be_to_limbs(raw, self.L)
        ga = GArray(self, self.ctx.to_mont(device_limbs(limbs, self.device)))
        hook = getattr(_DEFER_TLS, "hook", None)
        validated = False
        if validate and self.coorder == 2:
            # Safe prime: x in QR(p) <=> (x|p) == 1.
            if (hook is not None and self.device.type == "cuda"
                    and raw.shape[0] >= self.QR_DEVICE_FLOOR):
                hook(self._qr_check_device(ga.limbs))
                validated = True
            elif (hook is not None and raw.shape[0] >= 256
                    and get_lib() is not None):
                pb = self._p_bytes
                nt = max(1, min(16, (os.cpu_count() or 2) - 2))

                def _check(raw=raw, pb=pb, nt=nt):
                    ok = jacobi_batch(raw, pb, nthreads=nt)
                    return ok is not None and bool(ok.all())

                hook(_check)
                validated = True
            else:
                ok = jacobi_batch(raw, self._p_bytes)
                if ok is not None:
                    if not bool(ok.all()):
                        raise ByteTreeError("element not in subgroup")
                    validated = True
        if validate and not validated and not ga.is_in_group():
            raise ByteTreeError("element not in subgroup")
        if scalar:
            ga = ga.get(0)
        ga._bt = bt  # canonical encoding == input: no fetch on export
        return ga

    def _qr_check_device(self, mont_limbs):
        """Batched randomized quadratic-residuosity test on the device.

        Verifier-local uniform 400-bit exponents r_i (os.urandom) and the
        per-digit-position products P_j = prod_i x_i^(d_ij) of H4: if any
        x_i is a non-residue, each P_j is one with independent
        probability 1/2, so 100 passing positions leave 2^-100.
        Montgomery form is transparent: chi(R) = chi(2)^(16L) = +1.
        The returned thunk fetches the ~100 products and Jacobi-checks
        them on the host."""
        n = mont_limbs.shape[0]
        lw = self._QR_BITS // LIMB_BITS
        e = np.frombuffer(os.urandom(2 * n * lw), np.uint16).reshape(n, lw)
        P = mont_expprod_positions(
            mont_limbs, device_limbs(e, self.device), self.ctx.mod,
            self._QR_BITS,
        )

        def _check(P=P):
            arr = host_limbs(P)
            raw = limbs_to_bytes_be(arr, self.bytelen)
            ok = jacobi_batch(raw, self._p_bytes, nthreads=1)
            if ok is not None:
                return bool(ok.all())
            e2 = (self.p - 1) // 2
            return all(pow(v, e2, self.p) == 1 for v in limbs_to_ints(arr))

        return _check

    def to_bytetree(self) -> ByteTree:
        return node(
            signed_int_leaf(self.p),
            signed_int_leaf(self.q),
            self.elem_to_bytetree(self.g),
            int_leaf(self.encoding),
        )

    @classmethod
    def from_bytetree(cls, bt: ByteTree, device="cuda") -> "ModPGroup":
        p = bt[0].to_int_signed()
        q = bt[1].to_int_signed()
        enc = bt[3].to_u32()
        grp = cls(p, q, 1, enc, device=device)
        grp.g_int = grp.elem_from_bytetree(bt[2]).to_ints()[0]
        grp._g = None
        return grp

    # ----------------------------------------------------- plain encode

    def encode_message(self, msg: bytes) -> int:
        """Encode a message as a group element: m+1 or p-(m+1), whichever
        is a QR (reference: ModPGroup safe-prime encoding)."""
        mlen = self.nbits // 8 - 4
        if len(msg) > mlen:
            raise ValueError("message too long")
        padded = len(msg).to_bytes(4, "big") + msg.ljust(mlen, b"\x00")
        m = int.from_bytes(padded, "big") + 1
        if pow(m, self.q, self.p) == 1:
            return m
        return self.p - m

    def encode_messages(self, msgs: Sequence[bytes]) -> "GArray":
        """`encode_message` of each message, as one array.  For a safe
        prime, m is a QR exactly when its Jacobi symbol is 1, so the
        branch of the whole batch is one native Jacobi pass instead of a
        2048-bit power each."""
        if self.coorder != 2:
            return self.from_ints([self.encode_message(m) for m in msgs])
        mlen = self.nbits // 8 - 4
        ms = []
        for msg in msgs:
            if len(msg) > mlen:
                raise ValueError("message too long")
            padded = len(msg).to_bytes(4, "big") + msg.ljust(mlen, b"\x00")
            ms.append(int.from_bytes(padded, "big") + 1)
        raw = np.frombuffer(
            b"".join(m.to_bytes(self.bytelen, "big") for m in ms), np.uint8
        ).reshape(len(ms), self.bytelen)
        qr = jacobi_batch(raw, self._p_bytes) if ms else np.zeros(0)
        if qr is None:  # no native library: the powers themselves
            qr = [pow(m, self.q, self.p) == 1 for m in ms]
        return self.from_ints(
            [m if ok else self.p - m for m, ok in zip(ms, qr)])

    def decode_message(self, x: int) -> bytes:
        mlen = self.nbits // 8 - 4
        for cand in (x, self.p - x):
            m = cand - 1
            if not 0 <= m < 1 << (8 * (mlen + 4)):
                continue
            raw = m.to_bytes(mlen + 4, "big")
            n = int.from_bytes(raw[:4], "big")
            if n <= mlen:
                return raw[4 : 4 + n]
        return b""

    def __eq__(self, other):
        return (
            isinstance(other, ModPGroup)
            and other.p == self.p
            and other.q == self.q
            and other.g_int == self.g_int
        )

    def __repr__(self):
        return f"ModPGroup({self.nbits} bits)"


class GArray:
    """Array (or scalar) of group elements in Montgomery form."""

    __slots__ = ("grp", "limbs", "_bt")

    def __init__(self, grp: ModPGroup, limbs: torch.Tensor):
        self.grp = grp
        self.limbs = limbs
        self._bt = None

    @property
    def shape(self):
        return tuple(self.limbs.shape[:-1])

    @property
    def size(self) -> int:
        return int(self.limbs.shape[0])

    def __len__(self):
        return self.size

    def get(self, i: int) -> "GArray":
        return GArray(self.grp, _row(self.limbs, i))

    def copy_of_range(self, a: int, b: int) -> "GArray":
        return GArray(self.grp, self.limbs[a:b])

    def broadcast(self, n: int) -> "GArray":
        return GArray(self.grp, self.limbs.expand((n,) + self.limbs.shape))

    def spill(self) -> "GArray":
        """The array with its limbs on disk when arrays=file; an op loads
        them whole onto the group's device (`arith/storage.py`)."""
        if isinstance(self, _SpilledGArray):
            return self
        limbs = storage.maybe_spill(self.limbs)
        if limbs is self.limbs:
            return self
        return _SpilledGArray(self.grp, limbs)

    def to_ints(self) -> List[int]:
        arr = host_limbs(self.grp.ctx.from_mont(self.limbs))
        if arr.ndim == 1:
            return [limbs_to_int(arr)]
        return limbs_to_ints(arr)

    # --------------------------------------------------------------- ops

    def mul(self, other: "GArray") -> "GArray":
        return GArray(self.grp, self.grp.ctx.mul(self.limbs, other.limbs))

    def div(self, other: "GArray") -> "GArray":
        return self.mul(other.inv())

    def inv(self) -> "GArray":
        return GArray(self.grp, self.grp.ctx.inv(self.limbs))

    def exp(self, e: Union[FArray, int]) -> "GArray":
        """Element-wise power; broadcasts scalar^array and array^scalar."""
        if isinstance(e, int):
            e = self.grp.ring.from_int(e)
        return GArray(self.grp, self.grp.ctx.exp(self.limbs, e.limbs,
                                                 self.grp.ring.nbits))

    def exp_bits(self, e: FArray, nbits: int) -> "GArray":
        """Power with a declared exponent bit bound."""
        return GArray(self.grp, self.grp.ctx.exp(self.limbs, e.limbs, nbits))

    def exp_prod(self, e: FArray, nbits: Optional[int] = None) -> "GArray":
        """prod_i self_i^(e_i) — simultaneous multi-exponentiation."""
        nbits = self.grp.ring.nbits if nbits is None else nbits
        return GArray(self.grp,
                      self.grp.ctx.expprod(self.limbs, e.limbs, nbits))

    def exp_mul(self, v: FArray, other: "GArray") -> "GArray":
        return self.exp(v).mul(other)

    def prod(self) -> "GArray":
        return GArray(self.grp, self.grp.ctx.prod(self.limbs, axis=0))

    def permute(self, pi: Permutation) -> "GArray":
        return GArray(self.grp, _permute(self.limbs, pi))

    def shift_push(self, first: "GArray") -> "GArray":
        return GArray(self.grp, _shift_push(self.limbs, first.limbs))

    def concat(self, other: "GArray") -> "GArray":
        return GArray(self.grp, torch.cat([self.limbs, other.limbs]))

    def take(self, idx: np.ndarray) -> "GArray":
        return GArray(self.grp,
                      self.limbs[torch.from_numpy(idx).to(self.limbs.device)])

    def equals(self, other: "GArray") -> bool:
        return bool(torch.equal(self.limbs, other.limbs))

    def is_in_group(self) -> bool:
        """Batch subgroup-membership check: x^q == 1 for all elements."""
        qbits = self.grp.q.bit_length()
        eq = device_limbs(int_to_limbs(self.grp.q, num_limbs(qbits)),
                          self.grp.device)
        powed = self.grp.ctx.exp(self.limbs, eq, qbits)
        return bool((powed == self.grp.ctx.one_mont).all())

    def to_bytetree(self) -> ByteTree:
        """Serialized form, memoized (arrays are immutable)."""
        if self._bt is None:
            self._bt = self.grp.elem_to_bytetree(self)
        return self._bt

    def __repr__(self):
        return f"GArray(shape={self.shape}, {self.grp})"


_SpilledGArray = storage.spilled_class(GArray, ("limbs",))


# =====================================================================
# Product groups
# =====================================================================


class PPGroup:
    """Product group: tuple of component groups (reference: PPGroup)."""

    MARSHAL_NAME = "com.verificatum.arithm.PPGroup"

    def __init__(self, *factors):
        if len(factors) == 2 and isinstance(factors[1], int):
            factors = (factors[0],) * factors[1]
        self.factors: tuple = tuple(factors)

    @property
    def width(self) -> int:
        return len(self.factors)

    def project(self, i: int):
        return self.factors[i]

    @property
    def ring(self) -> "PPRing":
        return PPRing(*[f.ring for f in self.factors])

    @property
    def g(self) -> "PPArray":
        return PPArray(self, tuple(f.g for f in self.factors))

    def one(self, shape=()) -> "PPArray":
        return PPArray(self, tuple(f.one(shape) for f in self.factors))

    def product(self, *elements) -> "PPArray":
        if len(elements) != len(self.factors):
            raise ValueError("wrong number of components")
        return PPArray(self, tuple(elements))

    def random_array(self, n: int, prg, rbitlen: int) -> "PPArray":
        return PPArray(
            self, tuple(f.random_array(n, prg, rbitlen) for f in self.factors)
        )

    def elem_from_bytetree(self, bt, size=None, validate=True):
        if bt.is_leaf or len(bt.children) != self.width:
            raise ByteTreeError("malformed product-group element")
        return PPArray(self, tuple(
            f.elem_from_bytetree(c, size, validate)
            for f, c in zip(self.factors, bt.children)
        ))

    def to_bytetree(self) -> ByteTree:
        return node(*[f.to_bytetree() for f in self.factors])

    def __eq__(self, other):
        return (
            isinstance(other, PPGroup)
            and len(other.factors) == len(self.factors)
            and all(a == b for a, b in zip(self.factors, other.factors))
        )

    equals = __eq__

    def __repr__(self):
        return f"PPGroup({self.factors!r})"


class PPRing:
    """Product ring: tuple of component rings/fields."""

    def __init__(self, *factors):
        if len(factors) == 2 and isinstance(factors[1], int):
            factors = (factors[0],) * factors[1]
        self.factors: tuple = tuple(factors)

    @property
    def width(self) -> int:
        return len(self.factors)

    def project(self, i: int):
        return self.factors[i]

    def random(self, shape, randomsource, rbitlen: int) -> "PPFArray":
        return PPFArray(self, tuple(
            f.random(shape, randomsource, rbitlen) for f in self.factors))

    def from_ints(self, xs) -> "PPFArray":
        return PPFArray(self, tuple(f.from_ints(xs) for f in self.factors))

    def from_int(self, x: int) -> "PPFArray":
        return PPFArray(self, tuple(f.from_int(x) for f in self.factors))

    def zeros(self, shape=()) -> "PPFArray":
        return PPFArray(self, tuple(f.zeros(shape) for f in self.factors))

    def product(self, *elements) -> "PPFArray":
        return PPFArray(self, tuple(elements))

    def from_bytetree(self, bt, size=None):
        if bt.is_leaf or len(bt.children) != self.width:
            raise ByteTreeError("malformed product-ring element")
        return PPFArray(self, tuple(
            f.from_bytetree(c, size)
            for f, c in zip(self.factors, bt.children)
        ))

    def __eq__(self, other):
        return (
            isinstance(other, PPRing)
            and len(other.factors) == len(self.factors)
            and all(a == b for a, b in zip(self.factors, other.factors))
        )

    def __repr__(self):
        return f"PPRing({self.factors!r})"


def _zip_op(name):
    def op(self, other):
        if len(self.components) != len(other.components):
            raise ValueError("component count mismatch")
        return type(self)(self.parent, tuple(
            getattr(a, name)(b)
            for a, b in zip(self.components, other.components)
        ))

    return op


def _map_op(name):
    def op(self, *args):
        return type(self)(
            self.parent, tuple(getattr(a, name)(*args) for a in self.components)
        )

    return op


class PPArray:
    """Element (array) of a product group: tuple of component arrays."""

    __slots__ = ("parent", "components")

    def __init__(self, parent: PPGroup, components: tuple):
        self.parent = parent
        self.components = tuple(components)

    @property
    def grp(self) -> PPGroup:
        return self.parent

    @property
    def size(self) -> int:
        return self.components[0].size

    def project(self, i: int):
        return self.components[i]

    def spill(self) -> "PPArray":
        """Each component spilled (arrays=file)."""
        return PPArray(self.parent,
                       tuple(c.spill() for c in self.components))

    mul = _zip_op("mul")
    div = _zip_op("div")

    inv = _map_op("inv")
    prod = _map_op("prod")
    permute = _map_op("permute")
    get = _map_op("get")
    copy_of_range = _map_op("copy_of_range")
    broadcast = _map_op("broadcast")
    take = _map_op("take")

    def _ring_matches(self, e) -> bool:
        """True when `e` is an element of this product group's ring, so
        the exponent maps componentwise; any other exponent is applied to
        every component (reference: PPGroupElement.exp)."""
        return isinstance(e, PPFArray) and self.parent.ring == e.parent

    def _exp_like(self, name, e, *args) -> "PPArray":
        if self._ring_matches(e):
            return PPArray(self.parent, tuple(
                getattr(a, name)(b, *args)
                for a, b in zip(self.components, e.components)
            ))
        return PPArray(self.parent, tuple(
            getattr(a, name)(e, *args) for a in self.components))

    def exp(self, e) -> "PPArray":
        return self._exp_like("exp", e)

    def exp_bits(self, e, nbits: int) -> "PPArray":
        return self._exp_like("exp_bits", e, nbits)

    def exp_prod(self, e, nbits=None) -> "PPArray":
        return self._exp_like("exp_prod", e, nbits)

    def exp_mul(self, v, other: "PPArray") -> "PPArray":
        return self.exp(v).mul(other)

    def shift_push(self, first: "PPArray") -> "PPArray":
        return PPArray(self.parent, tuple(
            a.shift_push(b) for a, b in zip(self.components, first.components)
        ))

    def concat(self, other: "PPArray") -> "PPArray":
        return PPArray(self.parent, tuple(
            a.concat(b) for a, b in zip(self.components, other.components)
        ))

    def equals(self, other) -> bool:
        return all(
            a.equals(b) for a, b in zip(self.components, other.components)
        )

    def is_in_group(self) -> bool:
        return all(a.is_in_group() for a in self.components)

    def to_bytetree(self) -> ByteTree:
        return node(*[a.to_bytetree() for a in self.components])

    def __repr__(self):
        return f"PPArray({self.components!r})"


class PPFArray:
    """Element (array) of a product ring: tuple of component FArrays."""

    __slots__ = ("parent", "components")

    def __init__(self, parent: PPRing, components: tuple):
        self.parent = parent
        self.components = tuple(components)

    @property
    def ring(self) -> PPRing:
        return self.parent

    @property
    def size(self) -> int:
        return self.components[0].size

    def project(self, i: int):
        return self.components[i]

    def spill(self) -> "PPFArray":
        """Each component spilled (arrays=file)."""
        return PPFArray(self.parent,
                        tuple(c.spill() for c in self.components))

    def _zip_or_map(self, other, name):
        """Zip with a matching product-ring element, otherwise apply the
        operand to every component."""
        if isinstance(other, PPFArray) and other.parent == self.parent:
            return PPFArray(self.parent, tuple(
                getattr(a, name)(b)
                for a, b in zip(self.components, other.components)
            ))
        return PPFArray(self.parent, tuple(
            getattr(a, name)(other) for a in self.components))

    def add(self, other) -> "PPFArray":
        return self._zip_or_map(other, "add")

    def sub(self, other) -> "PPFArray":
        return self._zip_or_map(other, "sub")

    def mul(self, other) -> "PPFArray":
        return self._zip_or_map(other, "mul")

    def inner_product(self, other) -> "PPFArray":
        return self._zip_or_map(other, "inner_product")

    neg = _map_op("neg")
    sum = _map_op("sum")
    permute = _map_op("permute")
    get = _map_op("get")
    copy_of_range = _map_op("copy_of_range")

    def mul_add(self, v, t: "PPFArray") -> "PPFArray":
        vs = (v.components if isinstance(v, PPFArray)
              else (v,) * len(self.components))
        return PPFArray(self.parent, tuple(
            a.mul_add(vv, tt)
            for a, vv, tt in zip(self.components, vs, t.components)
        ))

    def concat(self, other: "PPFArray") -> "PPFArray":
        return PPFArray(self.parent, tuple(
            a.concat(b) for a, b in zip(self.components, other.components)
        ))

    def equals(self, other) -> bool:
        return all(
            a.equals(b) for a, b in zip(self.components, other.components)
        )

    def to_bytetree(self) -> ByteTree:
        return node(*[a.to_bytetree() for a in self.components])

    def __repr__(self):
        return f"PPFArray({self.components!r})"


# =====================================================================
# Named groups (vmn_tpu/arith/pgroup.py:1285-1344)
# =====================================================================

# RFC 3526 MODP primes (safe primes); generator 4 = 2^2 generates the
# prime-order subgroup of quadratic residues.
_RFC3526_2048 = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AACAA68FFFFFFFFFFFFFFFF",
    16,
)
_RFC3526_3072 = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AAAC42DAD33170D04507A33"
    "A85521ABDF1CBA64ECFB850458DBEF0A8AEA71575D060C7DB3970F85A6E1E4C7"
    "ABF5AE8CDB0933D71E8C94E04A25619DCEE3D2261AD2EE6BF12FFA06D98A0864"
    "D87602733EC86A64521F2B18177B200CBBE117577A615D6C770988C0BAD946E2"
    "08E24FA074E5AB3143DB5BFCE0FD108E4B82D120A93AD2CAFFFFFFFFFFFFFFFF",
    16,
)
_RFC3526_4096 = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AAAC42DAD33170D04507A33"
    "A85521ABDF1CBA64ECFB850458DBEF0A8AEA71575D060C7DB3970F85A6E1E4C7"
    "ABF5AE8CDB0933D71E8C94E04A25619DCEE3D2261AD2EE6BF12FFA06D98A0864"
    "D87602733EC86A64521F2B18177B200CBBE117577A615D6C770988C0BAD946E2"
    "08E24FA074E5AB3143DB5BFCE0FD108E4B82D120A92108011A723C12A787E6D7"
    "88719A10BDBA5B2699C327186AF4E23C1A946834B6150BDA2583E9CA2AD44CE8"
    "DBBBC2DB04DE8EF92E8EFC141FBECAA6287C59474E6BC05D99B2964FA090C3A2"
    "233BA186515BE7ED1F612970CEE2D7AFB81BDD762170481CD0069127D5B05AA9"
    "93B4EA988D8FDDC186FFB7DC90A6C08F4DF435C934063199FFFFFFFFFFFFFFFF",
    16,
)

# 256-bit safe prime for fast tests (largest below 2^256).
_TEST256_P = int(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff72ef",
    16,
)

_NAMED_GROUPS = {
    "test256": (_TEST256_P, 4),
    "modp2048": (_RFC3526_2048, 4),
    "modp3072": (_RFC3526_3072, 4),
    "modp4096": (_RFC3526_4096, 4),
}

from vmn_tpu_torch.eio.marshal import register as _register  # noqa: E402

_register(ModPGroup.MARSHAL_NAME)(ModPGroup)

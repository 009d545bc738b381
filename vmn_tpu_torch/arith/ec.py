"""Elliptic-curve groups over prime fields, batched on one device (port of
`vmn_tpu.arith.ec`).

Points are pairs of ``(..., L)`` int32 coordinate tensors over
``MontCtx(p, device)`` in Montgomery form with an explicit ``(...,)``
bool infinity mask (affine at rest).  Operations run in Jacobian form
and normalize once per public operation with a batched Montgomery-trick
inversion (two Hillis–Steele product scans through H1 and one field
power through H2).

Every point addition and scalar multiplication goes through a wrapper
of `ops.ec_kernels`: on a CUDA device the Hopper kernels H5 (scalar
multiple), H6 (multi-exponentiation, from 2^17 points up, as vmn_tpu
routes it) and H8 (addition; a doubling is P + P), on the CPU their
plain PyTorch versions.  Single points go through the same kernels as a
batch of one.  Field arithmetic outside the point formulas (normalize,
the on-curve test, point derivation) is `MontCtx`'s.

`ECqPGroup` / `ECArray` mirror `ModPGroup` / `GArray`, so the protocol
layer runs unchanged over EC groups.  Left out of the JAX version: the
sharded (`shard_map`) routes and `spill` (ROADMAP queue 11).

Element byte-tree format: node(leaf(x), leaf(y)) with fixed-size
unsigned big-endian coordinates of ``p.bit_length()//8 + 1`` bytes; the
point at infinity uses all-0xFF coordinates (reference: VCR encodes
infinity as (-1, -1)).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from vmn_tpu_torch.arith.limbs import (
    LIMB_BITS,
    bytes_be_to_limbs,
    limbs_to_bytes_be,
    num_limbs,
)
from vmn_tpu_torch.arith.mont import MontCtx, device_limbs, host_limbs
from vmn_tpu_torch.arith.pgroup import (
    _DEFER_TLS,
    PField,
    _bytelen,
    _range_check_be,
)
from vmn_tpu_torch.eio.bytetree import (
    ByteTree,
    ByteTreeError,
    ec_points_node,
    leaf,
    node,
    parse_ec_point_array,
    string_leaf,
)
from vmn_tpu_torch.ops import ec_kernels as E

# Points from which `exp_prod` takes the multi-exponentiation kernels
# (H6): vmn_tpu's measured crossover against scalar multiples plus an
# addition tree (vmn_tpu/arith/ec.py:933-943).
MULTIEXP_MIN = 1 << 17
WINDOW = 4


def _select(mask, a, b):
    """mask (...,) bool -> elementwise choose a else b over limb axes."""
    return torch.where(mask[..., None], a, b)


# ====================================================================
# Curve constants and Jacobian helpers
# ====================================================================


class _Curve:
    """Device constants for one curve; coordinates in Montgomery form."""

    def __init__(self, p: int, a: int, b: int, device="cuda"):
        self.ctx = MontCtx(p, device)
        c = self.ctx
        self.a_m = c._const(a % p * c.R % p)
        self.b_m = c._const(b % p * c.R % p)
        self.one_m = c.one_mont

    # field operations (Montgomery form): products through H1
    def mul(self, x, y):
        return self.ctx.mul(x, y)

    def add(self, x, y):
        return self.ctx.add(x, y)

    def sq(self, x):
        return self.mul(x, x)

    @staticmethod
    def is_zero(x):
        return (x == 0).all(dim=-1)

    # ------------------------------------------------------- jacobian ops

    def point_add(self, X1, Y1, Z1, X2, Y2, Z2):
        """Jacobian + Jacobian of one shape, as one batch through H8."""
        shape = X1.shape
        L = self.ctx.L
        out = E.ec_point_add(*(t.reshape(-1, L) for t in
                               (X1, Y1, Z1, X2, Y2, Z2)), self.ctx.mod)
        return tuple(t.reshape(shape) for t in out)

    def point_double(self, X, Y, Z):
        """2P as P + P: H8's addition takes its doubling branch."""
        return self.point_add(X, Y, Z, X, Y, Z)

    def normalize(self, X, Y, Z):
        """Jacobian -> affine + inf mask, via batched inversion."""
        inf = self.is_zero(Z)
        Zs = _select(inf, self.one_m.expand(Z.shape), Z)
        Zi = self.batch_inv(Zs)
        Zi2 = self.sq(Zi)
        x = self.mul(X, Zi2)
        y = self.mul(Y, self.mul(Zi, Zi2))
        zero = torch.zeros_like(x)
        return _select(inf, zero, x), _select(inf, zero, y), inf

    def batch_inv(self, z):
        """Montgomery-trick inversion of (..., L) nonzero elements over
        axis 0: two prefix-product scans (H1) and one power (H2)."""
        c = self.ctx
        if z.dim() == 1:
            return self.inv_single(z)
        pre = c.prods_scan(z)  # inclusive prefix products
        total_inv = self.inv_single(pre[-1])
        suf = c.prods_scan(torch.flip(z, dims=[0]))
        ones = self.one_m.expand((1,) + z.shape[1:])
        suffix_after = torch.cat([torch.flip(suf[:-1], dims=[0]), ones])
        inv_prefix = self.mul(total_inv.expand(z.shape), suffix_after)
        prefix_before = torch.cat([ones, pre[:-1]])
        return self.mul(inv_prefix, prefix_before)

    def inv_single(self, z):
        """Fermat inversion of a single (or broadcast) element."""
        c = self.ctx
        e = c._const(c.m - 2)
        return c.exp(z, e, c.nbits)


# ====================================================================
# Scalar multiplication
# ====================================================================


def _scalar_mul(curve: _Curve, x, y, inf, e, nbits: int):
    """e·P, broadcasting points against exponents; every shape (a
    scalar too) goes to H5 as one flat batch, then normalize.

    x, y: (..., L) affine Montgomery coords; inf: (...,) bool;
    e: (..., Le) standard-form scalar limbs."""
    shape = torch.broadcast_shapes(x.shape[:-1], e.shape[:-1])
    L = x.shape[-1]
    x2 = x.expand(shape + (L,)).reshape(-1, L)
    y2 = y.expand(shape + (L,)).reshape(-1, L)
    i2 = inf.expand(shape).reshape(-1)
    e2 = e.expand(shape + e.shape[-1:]).reshape(-1, e.shape[-1])
    X, Y, Z = E.ec_scalar_mul(x2, y2, i2, e2, curve.ctx.mod, nbits)
    xo, yo, io = curve.normalize(X, Y, Z)
    return xo.reshape(shape + (L,)), yo.reshape(shape + (L,)), io.reshape(shape)


def _ec_fb_table(curve: _Curve, X, Y, Z, ndig: int):
    """Windowed fixed-base table of the scalar Jacobian point P: affine
    coords of d·2^(4j)·P for d in [1, 16), j in [0, ndig).  Returns
    (tx, ty), each (ndig, 16, L); row d = 0 is zeros (H7 flags it as
    infinity by the digit).  Port of `_ec_fb_table_device`
    (vmn_tpu/arith/ec.py:357-385)."""
    bx, by, bz = [], [], []
    X, Y, Z = (t.reshape(1, -1) for t in (X, Y, Z))
    for _ in range(ndig):
        bx.append(X)
        by.append(Y)
        bz.append(Z)
        for _ in range(WINDOW):
            X, Y, Z = curve.point_double(X, Y, Z)
    BX, BY, BZ = torch.cat(bx), torch.cat(by), torch.cat(bz)  # (ndig, L)
    TX, TY, TZ = [BX], [BY], [BZ]
    cx, cy, cz = BX, BY, BZ
    for _ in range(2, 1 << WINDOW):
        cx, cy, cz = curve.point_add(cx, cy, cz, BX, BY, BZ)
        TX.append(cx)
        TY.append(cy)
        TZ.append(cz)
    L = BX.shape[-1]
    k = (1 << WINDOW) - 1
    ax, ay, _ = curve.normalize(*(torch.cat(t) for t in (TX, TY, TZ)))
    zeros = torch.zeros((1, ndig, L), dtype=ax.dtype, device=ax.device)

    def table(a):
        t = torch.cat([zeros, a.reshape(k, ndig, L)])
        return t.permute(1, 0, 2).contiguous()

    return table(ax), table(ay)


# ====================================================================
# Group + element array classes (GArray-compatible surface)
# ====================================================================


class ECqPGroup:
    """Prime-order EC group (reference: VCR arithm.ECqPGroup) on one
    device: the card unless the caller asks for ``device="cpu"``."""

    MARSHAL_NAME = "com.verificatum.arithm.ECqPGroup"

    def __init__(self, name: str, p: int, a: int, b: int, gx: int, gy: int,
                 n: int, device="cuda"):
        self.name = name
        self.p = p
        self.a = a % p
        self.b = b % p
        self.gx = gx
        self.gy = gy
        self.n = n  # group order (prime)
        self.curve = _Curve(p, a, b, device)
        self.ctx = self.curve.ctx
        self.device = self.ctx.device
        self.L = self.ctx.L
        self.nbits = n.bit_length()
        self.fbytelen = _bytelen(p)
        self.ring = PField(n, device)
        self._g = None

    _NAMED = {}

    @classmethod
    def named(cls, name: str, device="cuda") -> "ECqPGroup":
        key = (name, str(torch.device(device)))
        grp = cls._NAMED.get(key)
        if grp is None:
            grp = cls(name, *_CURVES[name], device=device)
            cls._NAMED[key] = grp
        return grp

    # ------------------------------------------------------------- build

    @property
    def g(self) -> "ECArray":
        if self._g is None:
            self._g = self.from_affine([(self.gx, self.gy)]).get(0)
        return self._g

    def one(self, shape=()) -> "ECArray":
        shape = tuple(shape)
        z = torch.zeros(shape + (self.L,), dtype=torch.int32,
                        device=self.device)
        return ECArray(self, z, z, torch.ones(shape, dtype=torch.bool,
                                              device=self.device))

    def from_affine(self, pts: Sequence[tuple]) -> "ECArray":
        return ECArray(
            self,
            self.ctx.encode([p[0] for p in pts]),
            self.ctx.encode([p[1] for p in pts]),
            torch.zeros((len(pts),), dtype=torch.bool, device=self.device),
        )

    def to_affine(self, arr: "ECArray") -> List[Optional[tuple]]:
        xs = self.ctx.decode(arr.x)
        ys = self.ctx.decode(arr.y)
        infs = arr.inf.cpu().numpy().reshape(-1)
        return [None if i else (x, y) for x, y, i in zip(xs, ys, infs)]

    def sqrt(self, v: int) -> Optional[int]:
        """Modular square root (host-side; message encoding and the
        sequential point derivation)."""
        p = self.p
        if pow(v, (p - 1) // 2, p) != 1:
            return None if v % p != 0 else 0
        if p % 4 == 3:
            return pow(v, (p + 1) // 4, p)
        # Tonelli-Shanks for p = 1 mod 4 (P-224)
        q, s = p - 1, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        m, c, t, r = s, pow(z, q, p), pow(v, q, p), pow(v, (q + 1) // 2, p)
        while t != 1:
            i, tt = 0, t
            while tt != 1:
                tt = tt * tt % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t = t * c % p
            r = r * b % p
        return r

    def curve_y(self, x: int) -> Optional[int]:
        """y with (x, y) on curve, or None."""
        rhs = (pow(x, 3, self.p) + self.a * x + self.b) % self.p
        return self.sqrt(rhs)

    def random_array(self, nelem: int, prg, rbitlen: int) -> "ECArray":
        """Derive points from a PRG stream: candidate x values until on
        curve, even y (reference: ECqPGroup.randomElementArray try-and-
        increment derivation).

        For p = 3 (mod 4) (P-256, P-384) the candidates are evaluated in
        device batches — the square root is rhs^((p+1)/4), one H2 power —
        taking the first `nelem` valid candidates in stream order, which
        gives exactly the sequential derivation's points."""
        if nelem == 0:
            return self.one((0,))
        bits = self.p.bit_length() + rbitlen
        nbytes = (bits + 7) // 8
        extra = 8 * nbytes - bits
        if self.p % 4 == 3 and hasattr(prg, "unread"):
            xs_parts, ys_parts, got = [], [], 0
            while got < nelem:
                k = max(2 * (nelem - got) + 16, 64)
                chunk = prg.read_bytes(k * nbytes)
                raw = np.frombuffer(chunk, np.uint8).reshape(k, nbytes).copy()
                if extra:
                    # the sequential derivation right-shifts the whole
                    # candidate by `extra` bits
                    wide = np.zeros((k, nbytes + 1), np.uint8)
                    wide[:, 1:] = raw
                    raw = ((wide[:, 1:] >> extra)
                           | (wide[:, :-1] << (8 - extra))).astype(np.uint8)
                x_m, y_m, valid = self._derive_candidates(raw)
                idx = np.nonzero(valid.cpu().numpy())[0][: nelem - got]
                if len(idx):
                    take = torch.from_numpy(idx).to(self.device)
                    xs_parts.append(x_m[take])
                    ys_parts.append(y_m[take])
                    got += len(idx)
                if got >= nelem:
                    # push the unused tail back so the stream position
                    # matches the sequential derivation exactly (a later
                    # draw from the same prg must see it)
                    consumed = int(idx[-1]) + 1
                    if consumed < k:
                        prg.unread(chunk[consumed * nbytes:])
            return ECArray(
                self, torch.cat(xs_parts), torch.cat(ys_parts),
                torch.zeros((nelem,), dtype=torch.bool, device=self.device),
            )
        pts = []
        while len(pts) < nelem:
            t = int.from_bytes(prg.read_bytes(nbytes), "big")
            if extra:
                t >>= extra
            x = t % self.p
            y = self.curve_y(x)
            if y is not None:
                if y % 2 == 1:
                    y = self.p - y
                pts.append((x, y))
        return self.from_affine(pts)

    def _derive_candidates(self, raw: np.ndarray):
        """Batched candidate evaluation (p = 3 mod 4): x = cand mod p,
        rhs = x^3 + ax + b, s = rhs^((p+1)/4), valid iff s^2 == rhs;
        y = s normalized to even (y -> p - y when odd)."""
        ctx = self.ctx
        c = self.curve
        Lw = max(ctx.L, num_limbs(8 * raw.shape[1]))
        wide = device_limbs(bytes_be_to_limbs(raw, Lw), self.device)
        x_m = ctx.to_mont(ctx.reduce_std(wide))
        rhs = c.add(c.add(c.mul(c.sq(x_m), x_m), c.mul(c.a_m, x_m)), c.b_m)
        e_int = (self.p + 1) // 4
        s = ctx.exp(rhs, ctx._const(e_int), e_int.bit_length())
        valid = (ctx.mul(s, s) == rhs).all(dim=-1)
        odd = (ctx.from_mont(s)[..., 0] & 1).bool()
        y_m = torch.where(odd[..., None], ctx.neg(s), s)
        return x_m, y_m, valid

    # --------------------------------------------------------- serialize

    def elem_to_bytetree(self, arr: "ECArray") -> ByteTree:
        if arr._bt is not None:
            return arr._bt
        xs = host_limbs(self.ctx.from_mont(arr.x))
        ys = host_limbs(self.ctx.from_mont(arr.y))
        infs = arr.inf.cpu().numpy()
        scalar = xs.ndim == 1
        if scalar:
            xs, ys, infs = xs[None], ys[None], infs.reshape(1)
        xb = limbs_to_bytes_be(xs, self.fbytelen)
        yb = limbs_to_bytes_be(ys, self.fbytelen)
        if infs.any():
            xb = xb.copy()
            yb = yb.copy()
            xb[infs] = 0xFF  # infinity = (-1, -1), reference encoding
            yb[infs] = 0xFF
        if scalar:
            return node(leaf(xb[0].tobytes()), leaf(yb[0].tobytes()))
        bt = ec_points_node(xb, yb)
        arr._bt = bt
        return bt

    def _from_coord_bytes(self, xb, yb, bt, validate: bool) -> "ECArray":
        """(n, fb) big-endian coordinate bytes -> validated ECArray:
        infinity detection and range checks on the host, the on-curve
        test batched on the device."""
        infs = np.logical_and((xb == 0xFF).all(axis=1),
                              (yb == 0xFF).all(axis=1))
        if infs.any():
            xb = xb.copy()
            yb = yb.copy()
            xb[infs] = 0
            yb[infs] = 0
        fin_x = xb[~infs]
        fin_y = yb[~infs]
        if fin_x.size and not (
            _range_check_be(fin_x, self.p, self.fbytelen, allow_zero=True)
            and _range_check_be(fin_y, self.p, self.fbytelen,
                                allow_zero=True)
        ):
            raise ByteTreeError("EC coordinate out of range")
        ctx = self.ctx
        x_m = ctx.to_mont(device_limbs(bytes_be_to_limbs(xb, ctx.L),
                                       self.device))
        y_m = ctx.to_mont(device_limbs(bytes_be_to_limbs(yb, ctx.L),
                                       self.device))
        arr = ECArray(self, x_m, y_m, torch.from_numpy(infs).to(self.device))
        if validate:
            hook = getattr(_DEFER_TLS, "hook", None)
            if hook is not None and xb.shape[0] >= 256:
                # Deferred on-curve check: the device value is fetched on
                # the membership worker (same contract as the ModP
                # deferred checks; a failure reruns the verification
                # inline).
                ok_dev = arr._on_curve_device()
                hook(lambda: bool(ok_dev))
            elif not arr.is_in_group():
                raise ByteTreeError("point not on curve")
        arr._bt = bt
        return arr

    def elem_from_bytetree(self, bt: ByteTree, size: Optional[int] = None,
                           validate: bool = True) -> "ECArray":
        # The raw uniform-array path first: materializing the children
        # of a lazy byte tree builds one object per point.
        pair = parse_ec_point_array(bt, self.fbytelen)
        if pair is not None:
            if size is not None and pair[0].shape[0] != size:
                raise ByteTreeError("wrong EC array length")
            return self._from_coord_bytes(*pair, bt, validate)
        if not bt.is_leaf and bt.children and bt.children[0].is_leaf:
            kids = [bt]  # single point node(x,y)
            scalar = True
        else:
            kids = list(bt.children)
            scalar = False
            if size is not None and len(kids) != size:
                raise ByteTreeError("wrong EC array length")
        ff = b"\xff" * self.fbytelen
        xs, ys, infs = [], [], []
        for k in kids:
            if k.is_leaf or len(k.children) != 2:
                raise ByteTreeError("malformed EC point")
            xd, yd = k[0].data, k[1].data
            if len(xd) != self.fbytelen or len(yd) != self.fbytelen:
                raise ByteTreeError("wrong EC coordinate length")
            if xd == ff and yd == ff:
                xs.append(0)
                ys.append(0)
                infs.append(True)
            else:
                x = int.from_bytes(xd, "big")
                y = int.from_bytes(yd, "big")
                if x >= self.p or y >= self.p:
                    raise ByteTreeError("EC coordinate out of range")
                if validate and (
                    (y * y - (x * x * x + self.a * x + self.b)) % self.p
                    != 0
                ):
                    raise ByteTreeError("point not on curve")
                xs.append(x)
                ys.append(y)
                infs.append(False)
        arr = ECArray(
            self,
            self.ctx.encode(xs),
            self.ctx.encode(ys),
            torch.tensor(infs, dtype=torch.bool, device=self.device),
        )
        if scalar:
            p0 = arr.get(0)
            p0._bt = bt
            return p0
        return arr

    def to_bytetree(self) -> ByteTree:
        return string_leaf(self.name)

    @classmethod
    def from_bytetree(cls, bt: ByteTree, device="cuda") -> "ECqPGroup":
        return cls.named(bt.to_string(), device)

    # ------------------------------------------------------ msg encoding

    def encode_message(self, msg: bytes) -> tuple:
        """Try-and-increment message encoding into a point."""
        mlen = self.p.bit_length() // 8 - 4
        if len(msg) > mlen:
            raise ValueError("message too long")
        padded = len(msg).to_bytes(2, "big") + msg.ljust(mlen, b"\x00")
        base = int.from_bytes(padded, "big") << 16  # 16 bits of tries
        for t in range(1 << 16):
            x = base + t
            y = self.curve_y(x)
            if y is not None:
                return (x, min(y, self.p - y))
        raise ValueError("could not encode message")

    def decode_message(self, pt) -> bytes:
        if pt is None:
            return b""
        x = pt[0] >> 16
        mlen = self.p.bit_length() // 8 - 4
        raw = x.to_bytes(mlen + 2, "big")
        nlen = int.from_bytes(raw[:2], "big")
        if nlen > mlen:
            return b""
        return raw[2 : 2 + nlen]

    def __eq__(self, other):
        return isinstance(other, ECqPGroup) and other.name == self.name

    def __repr__(self):
        return f"ECqPGroup({self.name}, {self.device})"


class ECArray:
    """Array (or scalar) of EC points: affine Montgomery coords + inf
    mask.  Mirrors the GArray surface (exp = scalar multiple, mul =
    point addition, prod, exp_prod, ...)."""

    __slots__ = ("grp", "x", "y", "inf", "_bt")

    def __init__(self, grp: ECqPGroup, x, y, inf):
        self.grp = grp
        self.x = x
        self.y = y
        self.inf = inf
        self._bt = None  # serialization memo (set by the codec paths)

    # -------------------------------------------------------------- meta

    @property
    def shape(self):
        return tuple(self.x.shape[:-1])

    @property
    def size(self) -> int:
        return int(self.x.shape[0])

    def __len__(self):
        return self.size

    def get(self, i: int) -> "ECArray":
        return ECArray(self.grp, self.x[i], self.y[i], self.inf[i])

    def copy_of_range(self, a: int, b: int) -> "ECArray":
        return ECArray(self.grp, self.x[a:b], self.y[a:b], self.inf[a:b])

    def broadcast(self, n: int) -> "ECArray":
        return ECArray(
            self.grp,
            self.x.expand((n,) + self.x.shape),
            self.y.expand((n,) + self.y.shape),
            self.inf.expand((n,) + self.inf.shape),
        )

    def to_affine(self):
        return self.grp.to_affine(self)

    # --------------------------------------------------------------- ops

    def _jac(self):
        c = self.grp.curve
        Z = _select(self.inf, torch.zeros_like(self.x),
                    c.one_m.expand(self.x.shape))
        return self.x, self.y, Z

    def mul(self, other: "ECArray") -> "ECArray":
        c = self.grp.curve
        coords = (*self._jac(), *other._jac())
        shape = torch.broadcast_shapes(*(t.shape for t in coords))
        x, y, inf = c.normalize(*c.point_add(*(t.expand(shape)
                                                for t in coords)))
        return ECArray(self.grp, x, y, inf)

    def inv(self) -> "ECArray":
        return ECArray(self.grp, self.x, self.grp.ctx.neg(self.y), self.inf)

    def div(self, other: "ECArray") -> "ECArray":
        return self.mul(other.inv())

    def exp(self, e) -> "ECArray":
        if isinstance(e, int):
            e = self.grp.ring.from_int(e)
        return self._exp_impl(e.limbs, self.grp.ring.nbits)

    def exp_bits(self, e, nbits: int) -> "ECArray":
        # Clamp to the exponent's own limbs (vmn_tpu/arith/ec.py:855-863).
        nbits = min(nbits, LIMB_BITS * e.limbs.shape[-1])
        return self._exp_impl(e.limbs, nbits)

    def _exp_impl(self, e_limbs, nbits: int) -> "ECArray":
        """Scalar multiples through H5.  The fixed-base kernel (H7) is
        not on this path, as in vmn_tpu, whose TPU table layout made it
        slower (vmn_tpu/arith/ec.py:873-896); whether shared bases go
        through H7 on the card is an open routing decision (ROADMAP)."""
        x, y, inf = _scalar_mul(self.grp.curve, self.x, self.y, self.inf,
                                e_limbs, nbits)
        return ECArray(self.grp, x, y, inf)

    def exp_prod(self, e, nbits: Optional[int] = None) -> "ECArray":
        """Simultaneous multi-exponentiation sum_i e_i·P_i (reference:
        PGroupElementArray.expProd): H6 + H8 from MULTIEXP_MIN points
        up, scalar multiples (H5) and an addition tree (H8) below."""
        nbits = self.grp.ring.nbits if nbits is None else nbits
        nbits = min(nbits, LIMB_BITS * e.limbs.shape[-1])
        c = self.grp.curve
        if (self.x.dim() == 2 and e.limbs.dim() == 2
                and self.x.shape[0] >= MULTIEXP_MIN):
            X, Y, Z = E.ec_multiexp(self.x, self.y, self.inf, e.limbs,
                                    c.ctx.mod, nbits)
            x, y, inf = c.normalize(X, Y, Z)
            return ECArray(self.grp, x, y, inf)
        return self.exp_bits(e, nbits).prod()

    def exp_mul(self, v, other: "ECArray") -> "ECArray":
        return self.exp(v).mul(other)

    def prod(self) -> "ECArray":
        c = self.grp.curve
        X, Y, Z = self._jac()
        while X.shape[0] > 1:
            nel = X.shape[0]
            h = nel // 2
            out = c.point_add(X[:h], Y[:h], Z[:h], X[h : 2 * h],
                              Y[h : 2 * h], Z[h : 2 * h])
            if nel % 2:
                out = [torch.cat([o, t[2 * h :]])
                       for o, t in zip(out, (X, Y, Z))]
            X, Y, Z = out
        x, y, inf = c.normalize(X[0], Y[0], Z[0])
        return ECArray(self.grp, x, y, inf)

    def permute(self, pi) -> "ECArray":
        idx = pi.index(self.x.device)
        return ECArray(self.grp, self.x[idx], self.y[idx], self.inf[idx])

    def take(self, idx) -> "ECArray":
        idx = torch.from_numpy(np.asarray(idx)).to(self.x.device)
        return ECArray(self.grp, self.x[idx], self.y[idx], self.inf[idx])

    def shift_push(self, first: "ECArray") -> "ECArray":
        L = self.grp.L
        return ECArray(
            self.grp,
            torch.cat([first.x.reshape(1, L), self.x[:-1]]),
            torch.cat([first.y.reshape(1, L), self.y[:-1]]),
            torch.cat([first.inf.reshape(1), self.inf[:-1]]),
        )

    def concat(self, other: "ECArray") -> "ECArray":
        return ECArray(
            self.grp,
            torch.cat([self.x, other.x]),
            torch.cat([self.y, other.y]),
            torch.cat([self.inf, other.inf]),
        )

    def equals(self, other: "ECArray") -> bool:
        return (torch.equal(self.x, other.x) and torch.equal(self.y, other.y)
                and torch.equal(self.inf, other.inf))

    def _on_curve_device(self):
        """y^2 == x^3 + ax + b for all non-infinity points, as a 0-d
        device bool (no host sync)."""
        c = self.grp.curve
        y2 = c.sq(self.y)
        x3 = c.mul(c.sq(self.x), self.x)
        rhs = c.add(c.add(x3, c.mul(c.a_m, self.x)), c.b_m)
        return ((y2 == rhs).all(dim=-1) | self.inf).all()

    def is_in_group(self) -> bool:
        """On-curve test for all points (cofactor 1 on all NIST curves,
        so on-curve implies in-group)."""
        return bool(self._on_curve_device())

    def to_bytetree(self) -> ByteTree:
        return self.grp.elem_to_bytetree(self)

    def __repr__(self):
        return f"ECArray(shape={self.shape}, {self.grp})"


# ====================================================================
# NIST curves (vmn_tpu/arith/ec.py:1052-1102)
# ====================================================================

from vmn_tpu_torch.eio.marshal import register as _register  # noqa: E402

_register(ECqPGroup.MARSHAL_NAME)(ECqPGroup)

_CURVES = {
    "P-224": (
        int("ffffffffffffffffffffffffffffffff000000000000000000000001", 16),
        -3,
        int("b4050a850c04b3abf54132565044b0b7d7bfd8ba270b39432355ffb4", 16),
        int("b70e0cbd6bb4bf7f321390b94a03c1d356c21122343280d6115c1d21", 16),
        int("bd376388b5f723fb4c22dfe6cd4375a05a07476444d5819985007e34", 16),
        int("ffffffffffffffffffffffffffff16a2e0b8f03e13dd29455c5c2a3d", 16),
    ),
    "P-256": (
        int("ffffffff00000001000000000000000000000000ffffffffffffffff"
            "ffffffff", 16),
        -3,
        int("5ac635d8aa3a93e7b3ebbd55769886bc651d06b0cc53b0f63bce3c3e"
            "27d2604b", 16),
        int("6b17d1f2e12c4247f8bce6e563a440f277037d812deb33a0f4a13945"
            "d898c296", 16),
        int("4fe342e2fe1a7f9b8ee7eb4a7c0f9e162bce33576b315ececbb64068"
            "37bf51f5", 16),
        int("ffffffff00000000ffffffffffffffffbce6faada7179e84f3b9cac2"
            "fc632551", 16),
    ),
    "P-384": (
        (1 << 384) - (1 << 128) - (1 << 96) + (1 << 32) - 1,
        -3,
        int("b3312fa7e23ee7e4988e056be3f82d19181d9c6efe8141120314088f5013"
            "875ac656398d8a2ed19d2a85c8edd3ec2aef", 16),
        int("aa87ca22be8b05378eb1c71ef320ad746e1d3b628ba79b9859f741e08254"
            "2a385502f25dbf55296c3a545e3872760ab7", 16),
        int("3617de4a96262c6f5d9e98bf9292dc29f8f41dbd289a147ce9da3113b5f0"
            "b8c00a60b1ce1d7e819d7a431d7c90ea0e5f", 16),
        int("ffffffffffffffffffffffffffffffffffffffffffffffffc7634d81f43"
            "72ddf581a0db248b0a77aecec196accc52973", 16),
    ),
    "P-521": (
        (1 << 521) - 1,
        -3,
        int("0051953eb9618e1c9a1f929a21a0b68540eea2da725b99b315f3b8b4899"
            "18ef109e156193951ec7e937b1652c0bd3bb1bf073573df883d2c34f1ef"
            "451fd46b503f00", 16),
        int("00c6858e06b70404e9cd9e3ecb662395b4429c648139053fb521f828af6"
            "06b4d3dbaa14b5e77efe75928fe1dc127a2ffa8de3348b3c1856a429bf9"
            "7e7e31c2e5bd66", 16),
        int("011839296a789a3bc0045c8a5fb42c7d1bd998f54449579b446817afbd1"
            "7273e662c97ee72995ef42640c550b9013fad0761353c7086a272c24088"
            "be94769fd16650", 16),
        int("01fffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
            "ffffffffa51868783bf2f966b7fcc0148f709a5d03bb5c9b8899c47aebb"
            "6fb71e91386409", 16),
    ),
}

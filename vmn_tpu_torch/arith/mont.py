"""Batched Montgomery arithmetic over multi-limb integers (port of
`vmn_tpu.arith.mont`).

`MontCtx(m, device)` holds the constants of one odd modulus on a device
(the card unless the caller asks for ``device="cpu"``); every array
handed to it lies on that device.  Elements are ``(..., L)``
int32 tensors of 16-bit limbs (arith/limbs.py).  Every Montgomery product
goes through the `mont_mul` wrapper of `ops.mont_kernels`, and powers
through its `mont_exp`, `mont_fb_exp` and `mont_expprod` wrappers: on a
CUDA device they launch the Hopper kernels, on the CPU they run the plain
PyTorch versions.

The product trees and the Hillis–Steele scans (`prod`, `prods_scan`,
`rec_lin`, `sum`) and the modular add/sub are torch code around those
wrappers, as they were XLA code around the Pallas kernels.  Left out of
the JAX version, because nothing on a GPU needs them: the exp launch
chunking for the TPU watchdog, `backpressure`, u16 transfer narrowing,
the `use_pallas` switches and the shard_map routing.
"""

from __future__ import annotations

import collections
from typing import List, Optional

import numpy as np
import torch

from vmn_tpu_torch.arith.limbs import (
    LIMB_BITS,
    LIMB_DTYPE,
    int_to_limbs,
    ints_to_limbs,
    limbs_to_int,
    limbs_to_ints,
    num_limbs,
)
from vmn_tpu_torch.ops import mont_kernels as K


def device_limbs(arr, device) -> torch.Tensor:
    """Host limb array (any unsigned dtype, values < 2^16) -> int32
    limb tensor on `device`."""
    arr = np.ascontiguousarray(arr)
    return torch.from_numpy(arr.astype(np.int32, copy=False)).to(device)


def host_limbs(t: torch.Tensor) -> np.ndarray:
    """Limb tensor -> host uint16 array (the byte codec's input)."""
    return t.cpu().numpy().astype(np.uint16)


def _flatten_pair(a, e):
    """Broadcast the leading dims of (.., L) x (.., Le) and flatten to 2D."""
    shape = torch.broadcast_shapes(a.shape[:-1], e.shape[:-1])
    a = a.expand(shape + a.shape[-1:]).reshape(-1, a.shape[-1])
    e = e.expand(shape + e.shape[-1:]).reshape(-1, e.shape[-1])
    return shape, a.contiguous(), e.contiguous()


class MontCtx:
    """Montgomery context for a fixed odd modulus on one device.

    Group elements are kept in Montgomery form by the group layer;
    field/ring elements in standard form (they are exponents)."""

    def __init__(self, m: int, device="cuda"):
        if m <= 0 or m % 2 == 0:
            raise ValueError("modulus must be positive and odd")
        self.m = m
        self.device = torch.device(device)
        self.nbits = m.bit_length()
        self.L = num_limbs(self.nbits)
        self.R = 1 << (LIMB_BITS * self.L)
        self.R2 = self.R * self.R % m
        self.mod = K.Modulus.of(m, self.L, self.device)
        self.m_limbs = self.mod.limbs
        self.one_mont = self.mod.one_mont
        self.r2_limbs = self._const(self.R2)
        self.one = self._const(1)
        self.zero = self._const(0)
        # Fixed-base tables are large device buffers (window 8 at 2048
        # bits: 33 MB).  Session-derived bases (h0 per mix session) would
        # accrete one table per session, so the cache is a small LRU;
        # long-lived bases (g, pk) are re-touched and stay resident.
        self._fb_tables = collections.OrderedDict()
        self._known_ints = collections.OrderedDict()

    _FB_CACHE_MAX = 24
    _KNOWN_INT_MAX = 256

    def _const(self, x: int) -> torch.Tensor:
        return device_limbs(int_to_limbs(x, self.L), self.device)

    # -------------------------------------------------------- conversions

    def to_mont(self, a):
        return self.mul(a, self.r2_limbs)

    def from_mont(self, a):
        return self.mul(a, self.one)

    def encode(self, xs) -> torch.Tensor:
        """Python ints -> Montgomery-form limbs (N, L)."""
        return self.to_mont(self.encode_std(xs))

    def encode_std(self, xs) -> torch.Tensor:
        """Python ints -> standard-form limbs (N, L)."""
        return device_limbs(ints_to_limbs(list(xs), self.L), self.device)

    def decode(self, a) -> List[int]:
        """Montgomery-form limbs -> Python ints."""
        return limbs_to_ints(host_limbs(self.from_mont(a)))

    def decode_std(self, a) -> List[int]:
        return limbs_to_ints(host_limbs(a))

    # --------------------------------------------------------- operations

    def mul(self, a, b):
        shape, a2, b2 = _flatten_pair(a, b)
        return K.mont_mul(a2, b2, self.mod).reshape(shape + (self.L,))

    def add(self, a, b):
        return K.add_mod(a, b, self.m_limbs)

    def sub(self, a, b):
        return K.sub_mod(a, b, self.m_limbs)

    def neg(self, a):
        return K.sub_mod(self.zero.expand(a.shape), a, self.m_limbs)

    def exp(self, base, e, nbits: Optional[int] = None):
        """base^e, broadcasting scalar^array and array^scalar.  A shared
        host-known base goes to the fixed-base kernel (no squarings)."""
        nbits = self.nbits if nbits is None else nbits
        if base.dim() == 1 and e.dim() > 1:
            return self.exp_fixed(self.known_int(base), e, nbits)
        shape, b2, e2 = _flatten_pair(base, e)
        return K.mont_exp(b2, e2, self.mod, nbits).reshape(shape + (self.L,))

    def expprod(self, bases, e, nbits: Optional[int] = None):
        """prod_i bases_i^(e_i) over axis 0 of (N, L) x (N, Le)."""
        nbits = self.nbits if nbits is None else nbits
        if bases.dim() != 2 or e.dim() != 2:
            raise ValueError("expprod takes (N, L) bases and (N, Le) exponents")
        return K.mont_expprod(bases.contiguous(), e.contiguous(), self.mod,
                              nbits)

    def prod(self, x, axis=0):
        """Log-depth product over `axis` (identity-padded tree)."""
        x = torch.movedim(x, axis, 0)
        n = x.shape[0]
        if n == 1:
            return x[0]
        p2 = 1 << (n - 1).bit_length()
        if p2 != n:
            pad = self.one_mont.expand((p2 - n,) + x.shape[1:])
            x = torch.cat([x, pad], dim=0)
        while x.shape[0] > 1:
            h = x.shape[0] // 2
            x = self.mul(x[:h], x[h:])
        return x[0]

    def prods_scan(self, x):
        """Inclusive cumulative product over axis 0 (Hillis–Steele, one
        batched product per round)."""
        n = x.shape[0]
        d = 1
        while d < n:
            pad = self.one_mont.expand((d,) + x.shape[1:])
            x = self.mul(x, torch.cat([pad, x[:-d]], dim=0))
            d *= 2
        return x

    def rec_lin(self, mult_mont, add_std):
        """x_i = x_{i-1}·e_i + b_i over axis 0 (e_i in Montgomery form,
        b_i standard); composition of affine maps, Hillis–Steele.
        Returns standard-form x."""
        mm, aa = mult_mont, add_std
        n = mm.shape[0]
        d = 1
        while d < n:
            pad_m = self.one_mont.expand((d,) + mm.shape[1:])
            pad_a = torch.zeros((d,) + aa.shape[1:], dtype=aa.dtype,
                                device=aa.device)
            m_sh = torch.cat([pad_m, mm[:-d]], dim=0)
            a_sh = torch.cat([pad_a, aa[:-d]], dim=0)
            mm, aa = self.mul(m_sh, mm), self.add(self.mul(a_sh, mm), aa)
            d *= 2
        return aa

    def sum(self, x, axis=0):
        """Log-depth modular sum over `axis`."""
        x = torch.movedim(x, axis, 0)
        n = x.shape[0]
        if n == 1:
            return x[0]
        p2 = 1 << (n - 1).bit_length()
        if p2 != n:
            x = torch.cat([x, torch.zeros((p2 - n,) + x.shape[1:],
                                          dtype=x.dtype, device=x.device)])
        while x.shape[0] > 1:
            h = x.shape[0] // 2
            x = self.add(x[:h], x[h:])
        return x[0]

    def reduce_std(self, wide):
        """(…, Lw) canonical limbs of any magnitude -> value mod m.

        Horner over L-limb chunks: acc = acc·R + chunk (mod m), with
        acc·R mod m = to_mont(acc) and chunk mod m = to_mont(from_mont(·))."""
        L = self.L
        Lw = wide.shape[-1]
        nchunks = -(-Lw // L)
        if nchunks * L != Lw:
            wide = torch.nn.functional.pad(wide, (0, nchunks * L - Lw))
        acc = None
        for j in range(nchunks - 1, -1, -1):
            chunk = wide[..., j * L : (j + 1) * L]
            cm = self.to_mont(self.from_mont(chunk))
            acc = cm if acc is None else self.add(self.to_mont(acc), cm)
        return acc

    def inv(self, a, order: Optional[int] = None):
        """Inverse via Fermat: a^(m-2) (m prime), or a^(order-1)."""
        e_int = (self.m - 2) if order is None else (order - 1)
        e = device_limbs(
            int_to_limbs(e_int, num_limbs(e_int.bit_length())), self.device
        )
        return self.exp(a, e, e_int.bit_length())

    # -------------------------------------------------------- fixed base

    def known_int(self, limbs) -> int:
        """Montgomery-form (L,) limbs -> int, cached by their bytes."""
        raw = host_limbs(limbs)
        key = raw.tobytes()
        val = self._known_ints.get(key)
        if val is None:
            val = limbs_to_int(host_limbs(self.from_mont(limbs)))
            self._known_ints[key] = val
            while len(self._known_ints) > self._KNOWN_INT_MAX:
                self._known_ints.popitem(last=False)
        else:
            self._known_ints.move_to_end(key)
        return val

    def fixed_base_table(self, base_int: int, max_ebits: int,
                         window: int = 8):
        """(ndig, 2^window, L) Montgomery-form table T[j, d] =
        (base^(2^(window·j)))^d, built on the device and kept in an LRU."""
        key = (base_int, max_ebits, window)
        tbl = self._fb_tables.get(key)
        if tbl is not None:
            self._fb_tables.move_to_end(key)
            return tbl
        ndig = max(1, -(-max_ebits // window))
        step = 1 << window
        bases = []
        bj = base_int % self.m
        for _ in range(ndig):
            bases.append(bj)
            bj = pow(bj, step, self.m)
        b_mont = self.encode(bases)  # (ndig, L)
        cols = [self.one_mont.expand(ndig, self.L), b_mont]
        for _ in range(2, step):
            cols.append(self.mul(cols[-1], b_mont))
        tbl = torch.stack(cols, dim=1).contiguous()
        self._fb_tables[key] = tbl
        while len(self._fb_tables) > self._FB_CACHE_MAX:
            self._fb_tables.popitem(last=False)
        return tbl

    def exp_fixed(self, base_int: int, e, nbits: Optional[int] = None):
        """base^e for a shared host-known base; `e` (..., Le) standard
        limbs.  Window 8 from 512 exponent bits up, window 4 below
        (vmn_tpu/arith/mont.py:1055)."""
        nbits = self.nbits if nbits is None else nbits
        window = 8 if nbits >= 512 else 4
        table = self.fixed_base_table(base_int, nbits, window)
        shape = e.shape[:-1]
        e2 = e.reshape(-1, e.shape[-1]).contiguous()
        out = K.mont_fb_exp(table, e2, self.mod)
        return out.reshape(shape + (self.L,))

    def __repr__(self):
        return f"MontCtx(bits={self.nbits}, L={self.L}, {self.device})"


__all__ = ["MontCtx", "device_limbs", "host_limbs", "LIMB_DTYPE"]

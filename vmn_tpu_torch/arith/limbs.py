"""Port of `vmn_tpu.arith.limbs`: the multi-limb integer format.

Big integers are ``(..., L)`` arrays of 16-bit limbs, least significant
limb first, ``L = num_limbs(nbits)`` and Montgomery radix
``R = 2^(16·L)`` — the layout of `vmn_tpu`, so that a port tensor and a
`vmn_tpu` array compare by plain equality after
``t.cpu().numpy().astype(np.uint32)``.

Storage choice of the port: torch tensors hold the limbs as ``int32``
(`LIMB_DTYPE`).  torch on the CPU has no ``uint32`` add, shift or
compare, so the plain PyTorch arithmetic widens to ``int64`` internally;
the CUDA kernels read the same ``int32`` limbs and pack pairs of them
into 32-bit words.

The host-side helpers below are numpy copies of `vmn_tpu`'s, unchanged.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
LIMB_DTYPE = torch.int32

# Row count above which the native single-pass limb<->byte codec takes
# over from the numpy strided route (below it, call overhead dominates).
_NATIVE_MIN_ROWS = 1024


def num_limbs(nbits: int) -> int:
    """Number of 16-bit limbs needed for an nbits integer."""
    return max(1, (nbits + LIMB_BITS - 1) // LIMB_BITS)


# ------------------------------------------------------------ single ints


def int_to_limbs(x: int, L: int) -> np.ndarray:
    """Non-negative int -> (L,) uint32 limb vector, LSB first."""
    if x < 0:
        raise ValueError("negative integer")
    if x >> (LIMB_BITS * L):
        raise ValueError(f"integer too large for {L} limbs")
    out = np.empty(L, dtype=np.uint32)
    for i in range(L):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    return out


def limbs_to_int(arr) -> int:
    """(L,) limb vector -> int."""
    arr = np.asarray(arr, dtype=np.uint64)
    x = 0
    for i in range(arr.shape[-1] - 1, -1, -1):
        x = (x << LIMB_BITS) | int(arr[i])
    return x


# ------------------------------------------------------------- int arrays


def ints_to_limbs(xs: Sequence[int], L: int) -> np.ndarray:
    """List of non-negative ints -> (N, L) uint32 limbs."""
    nbytes = 2 * L
    buf = bytearray(len(xs) * nbytes)
    for i, x in enumerate(xs):
        buf[i * nbytes : (i + 1) * nbytes] = x.to_bytes(nbytes, "little")
    flat = np.frombuffer(bytes(buf), dtype="<u2").reshape(len(xs), L)
    return flat.astype(np.uint32)


def limbs_to_ints(arr) -> List[int]:
    """(..., L) limbs -> flat list of ints (C-order over leading dims)."""
    arr = np.asarray(arr, dtype=np.uint32)
    flat = arr.reshape(-1, arr.shape[-1])
    le = flat.astype("<u2").tobytes()
    nbytes = 2 * flat.shape[1]
    return [
        int.from_bytes(le[i * nbytes : (i + 1) * nbytes], "little")
        for i in range(flat.shape[0])
    ]


# -------------------------------------------------- fixed-width byte views
# Used by byte-tree serialization of element arrays: unsigned big-endian
# fixed-size representations, vectorized (no Python loop over elements).


def limbs_to_bytes_be(arr, nbytes: int) -> np.ndarray:
    """(..., L) limbs -> (..., nbytes) uint8 big-endian unsigned.

    Accepts uint16 or uint32 limb arrays (values are 16-bit either
    way; the device<->host paths move uint16 to halve transfer)."""
    arr = np.asarray(arr)
    if arr.dtype not in (np.uint16, np.uint32):
        arr = arr.astype(np.uint32)
    L = arr.shape[-1]
    n = int(np.prod(arr.shape[:-1]))
    if n >= _NATIVE_MIN_ROWS:
        # Native single-pass codec (vmn_tpu/native/bytetree.cpp): the
        # numpy route below needs several strided passes over the
        # buffer — seconds per 2^20-element transcript array.
        from vmn_tpu_torch.native.build import limbs_to_be

        out = limbs_to_be(arr.reshape(n, L), nbytes)
        if out is not None:
            return out.reshape(*arr.shape[:-1], nbytes)
    # MSB-first limb order, each limb as 2 big-endian bytes.
    be = np.ascontiguousarray(arr[..., ::-1]).astype(">u2")
    raw = be.view(np.uint8).reshape(*arr.shape[:-1], 2 * L)
    if nbytes >= 2 * L:
        pad_shape = (*arr.shape[:-1], nbytes - 2 * L)
        return np.concatenate(
            [np.zeros(pad_shape, dtype=np.uint8), raw], axis=-1
        )
    # Trimming: assert the dropped leading bytes are zero.
    head = raw[..., : 2 * L - nbytes]
    if head.any():
        raise ValueError("integer does not fit in requested byte width")
    return np.ascontiguousarray(raw[..., 2 * L - nbytes :])


def bytes_be_to_limbs(data: np.ndarray, L: int) -> np.ndarray:
    """(..., nbytes) uint8 big-endian -> (..., L) uint16 limbs.

    Pure strided arithmetic (no byteswap dtype views — those cost
    seconds at N=65536); callers upload via `arith.mont.device_limbs`.
    """
    data = np.asarray(data, dtype=np.uint8)
    nbytes = data.shape[-1]
    n = int(np.prod(data.shape[:-1]))
    if n >= _NATIVE_MIN_ROWS:
        from vmn_tpu_torch.native.build import be_to_limbs

        out = be_to_limbs(data.reshape(n, nbytes), L)
        if out is not None:
            return out.reshape(*data.shape[:-1], L)
    want = 2 * L
    if nbytes < want:
        pad_shape = (*data.shape[:-1], want - nbytes)
        data = np.concatenate(
            [np.zeros(pad_shape, dtype=np.uint8), data], axis=-1
        )
    elif nbytes > want:
        head = data[..., : nbytes - want]
        if head.any():
            raise ValueError(f"integer too large for {L} limbs")
        data = data[..., nbytes - want :]
    # limb k (LSB-first) = data[2L-2k-2]*256 + data[2L-2k-1]
    hi = data[..., 0::2][..., ::-1].astype(np.uint16)
    lo = data[..., 1::2][..., ::-1].astype(np.uint16)
    return (hi << 8) | lo


def bitlen_ints(arr) -> int:
    """Max bit length over an array of limb vectors."""
    arr = np.asarray(arr)
    nz = np.nonzero(arr.reshape(-1, arr.shape[-1]))
    if len(nz[0]) == 0:
        return 0
    top = int(arr.reshape(-1, arr.shape[-1])[:, ::-1].argmax(axis=1).min())
    # Simple conservative bound; exact value rarely needed.
    L = arr.shape[-1]
    return (L - top) * LIMB_BITS

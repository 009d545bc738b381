"""State carried across from `vmn_tpu` without importing it.

`vmn_tpu` holds limbs as ``(..., L)`` uint32 numpy/JAX arrays of 16-bit
limbs in the same order and Montgomery radix as the port, so conversion
is a dtype change and a device copy.  Byte-tree files (`KeyAndPoly.bt`,
`FullPublicKey.bt`, `Ciphertexts.bt`, transcripts) need no conversion:
both packages read and write the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from vmn_tpu_torch.arith.ec import ECArray, ECqPGroup
from vmn_tpu_torch.arith.mont import device_limbs
from vmn_tpu_torch.arith.pgroup import (
    FArray, GArray, ModPGroup, PField, PPArray, PPGroup,
)


def limbs_from_numpy(arr, device="cuda") -> torch.Tensor:
    """uint32 (or any unsigned) 16-bit limb array -> port limb tensor, on
    the card unless the caller names another device (raises without
    one)."""
    arr = np.asarray(arr)
    if arr.size and int(arr.max()) >> 16:
        raise ValueError("limb values must be below 2^16")
    return device_limbs(arr, device)


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Port limb tensor -> uint32 numpy array, `vmn_tpu`'s limb dtype."""
    return t.cpu().numpy().astype(np.uint32)


def garray_from_numpy(group: ModPGroup, limbs, mont: bool = True) -> GArray:
    """Group elements from `vmn_tpu` limbs: Montgomery-form limbs (as
    `vmn_tpu.arith.pgroup.GArray.limbs` holds them) when `mont`, else
    standard-form values."""
    t = limbs_from_numpy(limbs, group.device)
    return GArray(group, t if mont else group.ctx.to_mont(t))


def farray_from_numpy(ring: PField, limbs) -> FArray:
    """Field elements from `vmn_tpu` standard-form limbs."""
    return FArray(ring, limbs_from_numpy(limbs, ring.device))


def ecarray_from_numpy(group: ECqPGroup, x, y, inf) -> ECArray:
    """EC points from `vmn_tpu.arith.ec.ECArray`'s fields: Montgomery-form
    coordinate limbs `x`, `y` and the bool infinity mask `inf`."""
    inf = torch.from_numpy(np.asarray(inf, dtype=bool).copy())
    return ECArray(group, limbs_from_numpy(x, group.device),
                   limbs_from_numpy(y, group.device), inf.to(group.device))


def pparray_from_numpy(parent: PPGroup, components, mont: bool = True
                       ) -> PPArray:
    """Product-group element from nested component limb arrays, mirroring
    `parent.factors` (a width-1 El Gamal ciphertext batch is
    ``(u_limbs, v_limbs)``)."""
    if len(components) != parent.width:
        raise ValueError("component count does not match the group")
    parts = []
    for f, c in zip(parent.factors, components):
        if isinstance(f, PPGroup):
            parts.append(pparray_from_numpy(f, c, mont))
        else:
            parts.append(garray_from_numpy(f, c, mont))
    return PPArray(parent, tuple(parts))

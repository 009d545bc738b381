"""Array storage backends: RAM or disk-spilled (out-of-core) (port of
`vmn_tpu.arith.storage`).

The reference keeps file-mapped `LargeIntegerArray`s so that N can
exceed memory (reference: ProtocolElGamal.java:332-345, the `arrays`
private-info field, toggled in the check matrix `ARRAYS=file`).

In file mode the large resident arrays (cached generators, permutation
commitments, re-encryption exponents and factors, the ciphertext lists
between the parties' shuffles) are written to ``.npy`` files, and the
array keeps a `Spilled` handle in place of its limb tensor.  The handle
remembers the tensor's dtype, shape and device: an op that reads a
spilled array loads the whole file onto that device first, so a spilled
array never reaches a kernel wrapper as a host tensor.  The classes that
can hold a handle are `spilled_class` subclasses; an array that never
spilled is an instance of its own class and pays nothing.
"""

from __future__ import annotations

import atexit
import itertools
import os
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

_BACKEND = "ram"
_SPILL_DIR: Optional[Path] = None
_COUNTER = itertools.count(1)
_LOCK = threading.Lock()
# Arrays smaller than this stay in RAM even in file mode (spilling tiny
# arrays costs more in file churn than it saves).
MIN_SPILL_BYTES = 1 << 20


def set_backend(mode: str, directory=None) -> None:
    """Select the array backend: ``ram`` (default) or ``file``.

    ``directory`` is where spill files live (the party's working
    directory in protocol runs); a temp dir is used if omitted.
    """
    global _BACKEND, _SPILL_DIR
    if mode not in ("ram", "file"):
        raise ValueError(f"unknown array backend: {mode}")
    _BACKEND = mode
    if directory is not None:
        _SPILL_DIR = Path(directory)
        _SPILL_DIR.mkdir(parents=True, exist_ok=True)


def backend() -> str:
    return _BACKEND


def _spill_path() -> Path:
    global _SPILL_DIR
    with _LOCK:
        if _SPILL_DIR is None:
            d = tempfile.mkdtemp(prefix="vmn_arrays_")
            _SPILL_DIR = Path(d)
            atexit.register(_cleanup, d)
        return _SPILL_DIR / f"spill{next(_COUNTER):06d}.npy"


def _cleanup(d: str) -> None:
    try:
        for f in Path(d).glob("spill*.npy"):
            f.unlink(missing_ok=True)
        os.rmdir(d)
    except OSError:
        pass


class Spilled:
    """A tensor written to a ``.npy`` file, opened read-only as a memmap,
    with the device it came from."""

    __slots__ = ("path", "shape", "dtype", "device", "_mm")

    def __init__(self, path: Path, t: torch.Tensor):
        self.path = path
        self.shape = t.shape
        self.dtype = t.dtype
        self.device = t.device
        a = t.detach().cpu().contiguous().numpy()
        mm = np.lib.format.open_memmap(path, mode="w+", dtype=a.dtype,
                                       shape=a.shape)
        mm[...] = a
        mm.flush()
        del mm
        # Reopen read-only so accidental writes cannot corrupt cached state.
        self._mm = np.load(path, mmap_mode="r")

    def load(self) -> torch.Tensor:
        """The whole array, on its device."""
        return torch.from_numpy(np.array(self._mm)).to(self.device)


def maybe_spill(t):
    """Move a tensor to a disk-backed `Spilled` handle when in file mode.

    Returns the input unchanged in ram mode, for a handle, or for tensors
    under MIN_SPILL_BYTES.
    """
    if _BACKEND != "file" or isinstance(t, Spilled):
        return t
    if t.element_size() * t.numel() < MIN_SPILL_BYTES:
        return t
    return Spilled(_spill_path(), t)


def _loaded(v):
    return v.load() if isinstance(v, Spilled) else v


def spilled_class(cls, fields):
    """The subclass of the slotted class `cls` whose tensor `fields` may
    hold `Spilled` handles: reading such a field loads it onto its
    device, and `shape` and `size` read the first field's handle without
    loading it."""
    slots = [cls.__dict__[f] for f in fields]
    ns = {"__slots__": ()}
    for f, slot in zip(fields, slots):
        ns[f] = property(lambda self, s=slot: _loaded(s.__get__(self)),
                         slot.__set__)
    ns["shape"] = property(lambda self: tuple(slots[0].__get__(self)
                                              .shape[:-1]))
    ns["size"] = property(lambda self: int(slots[0].__get__(self).shape[0]))
    return type(f"Spilled{cls.__name__}", (cls,), ns)

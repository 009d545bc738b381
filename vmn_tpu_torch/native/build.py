"""Port of `vmn_tpu.native.build`: on-demand compilation and loading of
the host C++ library (`bytetree.cpp`, a copy of `vmn_tpu`'s).

The library is built with g++ on first use into the git-ignored
`vmn_tpu_torch/_build/`, named by a hash of the source, and is never
committed.  Concurrent first uses (test workers) each compile to a
private temporary file and rename it into place atomically.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_DIR = Path(__file__).parent
_SRC = _DIR / "bytetree.cpp"
_BUILD = _DIR.parent / "_build"

_lock = threading.Lock()
_lib = None
_tried = False


def _so_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD / f"_vmn_native_{digest}.so"


def _compile(so: Path) -> bool:
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", "-O3", "-pthread", "-shared", "-fPIC", "-o", str(tmp),
             str(_SRC)],
            check=True,
            capture_output=True,
            timeout=120,
        )
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, so)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, compiling it on first use; None if no
    toolchain is available (callers fall back to numpy)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _so_path()
        if not so.exists() and not _compile(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.bt_encoded_size.restype = ctypes.c_size_t
        lib.bt_encoded_size.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
        lib.bt_encode_array.restype = ctypes.c_size_t
        lib.bt_encode_array.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_char_p,
        ]
        lib.bt_decode_array.restype = ctypes.c_int
        lib.bt_decode_array.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.bt_probe_array.restype = ctypes.c_int
        lib.bt_probe_array.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.bt_subtree_end.restype = ctypes.c_longlong
        lib.bt_subtree_end.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
        ]
        lib.bt_child_offsets.restype = ctypes.c_longlong
        lib.bt_child_offsets.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_size_t,
        ]
        lib.prg_expand_sha256.restype = None
        lib.prg_expand_sha256.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int32,
            ctypes.c_size_t, ctypes.c_char_p,
        ]
        lib.jacobi_batch.restype = ctypes.c_int
        lib.jacobi_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ctypes.c_char_p,
        ]
        lib.limbs_to_be.restype = ctypes.c_int
        lib.limbs_to_be.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.be_to_limbs.restype = ctypes.c_int
        lib.be_to_limbs.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def limbs_to_be(limbs, nbytes: int, nthreads: int = 0):
    """(n, L) uint16 LSB-first limbs -> (n, nbytes) big-endian bytes.

    One cache-friendly native pass (numpy needs several strided passes
    over hundreds of MB at transcript scale).  Returns None when the
    native library is unavailable; raises ValueError when a value does
    not fit the requested width (matching the numpy path).
    """
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    limbs = np.ascontiguousarray(limbs, dtype=np.uint16)
    n, L = limbs.shape
    out = np.empty((n, nbytes), np.uint8)
    if nthreads <= 0:
        nthreads = min(8, os.cpu_count() or 1)
    rc = lib.limbs_to_be(
        limbs.ctypes.data, n, L, nbytes, out.ctypes.data, nthreads
    )
    if rc != 0:
        raise ValueError("integer does not fit in requested byte width")
    return out


def be_to_limbs(data, L: int, nthreads: int = 0):
    """(n, nbytes) big-endian bytes -> (n, L) uint16 LSB-first limbs.

    Returns None when the native library is unavailable; raises
    ValueError when a value does not fit L limbs.
    """
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n, nbytes = data.shape
    out = np.empty((n, L), np.uint16)
    if nthreads <= 0:
        nthreads = min(8, os.cpu_count() or 1)
    rc = lib.be_to_limbs(
        data.ctypes.data, n, nbytes, L, out.ctypes.data, nthreads
    )
    if rc != 0:
        raise ValueError(f"integer too large for {L} limbs")
    return out


def jacobi_batch(raw, p_bytes: bytes, nthreads: int = 0):
    """Jacobi symbols of n big-endian elements against an odd modulus.

    raw: C-contiguous (n, eb) uint8 array.  Returns a length-n uint8
    array (1 where (x|p) == 1), or None when the native library is
    unavailable (callers fall back to the device exponentiation path).
    """
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    n, eb = raw.shape
    if eb > len(p_bytes):
        # canonical encodings carry a leading zero byte (Java
        # BigInteger.toByteArray length); values are already
        # range-checked < p, so the extra columns must be zero
        extra = eb - len(p_bytes)
        if raw[:, :extra].any():
            return np.zeros(n, np.uint8)  # out of range -> not members
        raw = np.ascontiguousarray(raw[:, extra:])
        eb = len(p_bytes)
    out = np.empty(n, np.uint8)
    if nthreads <= 0:
        nthreads = min(32, os.cpu_count() or 1)
    rc = lib.jacobi_batch(
        raw.ctypes.data_as(ctypes.c_char_p), n, eb,
        p_bytes, len(p_bytes), nthreads,
        out.ctypes.data_as(ctypes.c_char_p),
    )
    if rc != 0:
        return None
    return out

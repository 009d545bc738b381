"""Port of `vmn_tpu.protocol.state` (a host-only copy; byte-identical behaviour).

Disk-state machinery: marker files, cached byte trees, resume.

Rebuild of the reference's `Protocol` working-directory state surface
(reference: SURVEY.md §2.4 protocol base — `getFile`, marker booleans
`writeBoolean/readBoolean`, `deleteState`; used for the one-way session
state machine `MixNetElGamalSession.java:162-170,278-285`, the DKG
`KeyAndPoly` cache `DKG.java:147-175`, the permutation-commitment cache
`PermutationCommitment.java:156-218` and the precomputed shuffle arrays
`ShufflerElGamalSession.java:548-663`).

Every protocol step persists its outputs here and reloads them
idempotently on restart, so a crashed or restarted mix-server resumes
from the last completed step, and `vmn -precomp` state survives into a
later `vmn -mix` process.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from vmn_tpu_torch.eio.bytetree import ByteTree


class StateDir:
    """A working directory holding marker files and cached byte trees."""

    def __init__(self, path):
        self.path = Path(path)

    def sub(self, name: str) -> "StateDir":
        return StateDir(self.path / name)

    def file(self, name: str) -> Path:
        return self.path / name

    def exists(self, name: str) -> bool:
        return (self.path / name).exists()

    # ------------------------------------------------------------ markers

    def write_marker(self, name: str) -> None:
        """One-way state-machine marker (reference: writeBoolean)."""
        self.path.mkdir(parents=True, exist_ok=True)
        (self.path / name).write_bytes(b"")

    def has_marker(self, name: str) -> bool:
        return (self.path / name).exists()

    # ----------------------------------------------------------- scalars

    def write_text(self, name: str, text: str) -> None:
        self.path.mkdir(parents=True, exist_ok=True)
        tmp = self.path / (name + ".tmp")
        tmp.write_text(text)
        tmp.replace(self.path / name)

    def read_text(self, name: str) -> Optional[str]:
        f = self.path / name
        return f.read_text() if f.exists() else None

    def write_int(self, name: str, value: int) -> None:
        self.write_text(name, str(value))

    def read_int(self, name: str) -> Optional[int]:
        t = self.read_text(name)
        return int(t) if t is not None else None

    # --------------------------------------------------------- byte trees

    def write_bytetree(self, name: str, bt: ByteTree) -> None:
        """Atomic write (tmp + rename): a crash mid-write never leaves a
        truncated cache file behind."""
        self.path.mkdir(parents=True, exist_ok=True)
        tmp = self.path / (name + ".tmp")
        tmp.write_bytes(bt.to_bytes())
        tmp.replace(self.path / name)

    def read_bytetree(self, name: str) -> Optional[ByteTree]:
        f = self.path / name
        if not f.exists():
            return None
        return ByteTree.from_bytes(f.read_bytes())

    # ------------------------------------------------- numpy index arrays

    def write_indices(self, name: str, arr: np.ndarray) -> None:
        """Permutation/keep-list tables as little-endian int64 leaves."""
        from vmn_tpu_torch.eio.bytetree import leaf

        self.write_bytetree(
            name, leaf(np.asarray(arr, dtype="<i8").tobytes())
        )

    def read_indices(self, name: str) -> Optional[np.ndarray]:
        bt = self.read_bytetree(name)
        if bt is None:
            return None
        return np.frombuffer(bt.data, dtype="<i8").copy()

    # ------------------------------------------------------------ cleanup

    def delete(self) -> None:
        """Recursive wipe (reference: Protocol.deleteState)."""
        import shutil

        if self.path.exists():
            shutil.rmtree(self.path)

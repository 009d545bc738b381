"""Port of `vmn_tpu.protocol.log` (a host-only copy; byte-identical behaviour).

Hierarchical logging (reference: VCR `Log` with newChildLog —
child-indented entries teed to `<dir>/log` and stdout,
MixNetElGamalTool.setupLogFile:771-789).

A `Log` holds shared sinks and a depth; `child()` returns a log whose
entries indent one step deeper, giving the reference's nested progress
rendering.  `plain()` writes without the timestamp header (used by the
postlude report block).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import IO, List, Optional


class Log:
    """Hierarchical, tee-able logger."""

    def __init__(self, sinks: Optional[List[IO]] = None, depth: int = 0):
        self._sinks = sinks if sinks is not None else []
        self.depth = depth

    # ------------------------------------------------------- constructors

    @classmethod
    def tee(cls, path=None, stdout: bool = True) -> "Log":
        sinks: List[IO] = []
        if stdout:
            sinks.append(sys.stdout)
        if path is not None:
            p = Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            sinks.append(open(p, "a", buffering=1))  # noqa: SIM115
        return cls(sinks)

    @classmethod
    def silent(cls) -> "Log":
        return cls([])

    def child(self) -> "Log":
        """Indented child log (reference: Log.newChildLog)."""
        return Log(self._sinks, self.depth + 1)

    # ------------------------------------------------------------- output

    def info(self, msg: str) -> None:
        if not self._sinks:
            return
        stamp = time.strftime("%y%m%d %H:%M:%S")
        indent = "  " * self.depth
        line = f"{stamp} {indent}{msg}\n"
        for s in self._sinks:
            s.write(line)

    def plain(self, msg: str) -> None:
        for s in self._sinks:
            s.write(msg + "\n")


def human_bytes(n: int) -> str:
    """Bytes -> human string (reference: ExtIO.bytesToHuman)."""
    units = ["B", "KB", "MB", "GB", "TB"]
    f = float(n)
    for u in units:
        if f < 1024 or u == units[-1]:
            return f"{f:.1f} {u}" if u != "B" else f"{int(f)} B"
        f /= 1024
    return f"{n} B"


def postlude_report(
    log: Log,
    operation: str,
    execution_s: float,
    network_s: float,
    waiting_s: float,
    sent_bytes: int,
    received_bytes: int,
    nizkp_bytes: int = 0,
) -> None:
    """The reference's full timing/communication report
    (reference: MixNetElGamalTool.postlude:130-207):

        Execution   = total wall time
        Network     = time in network transfer
        Effective   = Execution - Network
        Idle        = time blocked waiting for peers (excl. transfer)
        Computation = Effective - Idle
    """
    effective = execution_s - network_s
    computation = effective - waiting_s
    total_bytes = sent_bytes + received_bytes
    ms = 1000.0

    log.plain("-" * 59)
    log.plain(f"Completed {operation}.\n")
    log.plain(f"{'Running time:':17s}{'':13s}{'(ms)':>21s}")
    log.plain(f"- Execution      {execution_s:13.3f}{execution_s * ms:21.0f}")
    log.plain(f"- Network        {network_s:13.3f}{network_s * ms:21.0f}")
    log.plain(f"- Effective      {effective:13.3f}{effective * ms:21.0f}")
    log.plain(f"- Idle           {waiting_s:13.3f}{waiting_s * ms:21.0f}")
    log.plain(
        f"- Computation    {computation:13.3f}{computation * ms:21.0f}"
    )
    log.plain("")
    log.plain(f"{'Communication:':17s}{'':13s}{'(bytes)':>21s}")
    log.plain(
        f"- Sent           {human_bytes(sent_bytes):>13s}{sent_bytes:21d}"
    )
    log.plain(
        f"- Received       {human_bytes(received_bytes):>13s}"
        f"{received_bytes:21d}"
    )
    log.plain(
        f"- Total          {human_bytes(total_bytes):>13s}{total_bytes:21d}"
    )
    if nizkp_bytes:
        log.plain(
            f"\nProof size:      {human_bytes(nizkp_bytes):>13s}"
            f"{nizkp_bytes:21d}"
        )

"""Port of `vmn_tpu.protocol.com.board` (a host-only copy; byte-identical behaviour).

Bulletin-board abstraction.

Semantics follow the reference's BullBoard (reference: SURVEY.md §2.4
protocol.com): an append-only, authenticated, sender-hosted message
board with exactly two verbs —

    publish(label, data)        # as myself
    wait_for(l, label) -> data  # block until party l's message arrives

Every message is tagged (party, scoped-label) and immutable once
published.  Byte/time accounting mirrors the reference counters used in
the `postlude` report (reference: MixNetElGamalTool.java:144-157).

`LocalBoardHub` is the in-process implementation used by the demo/test
harness (the reference runs k parties as threads in one JVM over
localhost HTTP, Demo.java:257-300 — here the HTTP stack is replaced by a
shared dict + condition variable).  The signed HTTP implementation over
DCN lives in `vmn_tpu_torch.protocol.com.http`.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple


class BoardError(Exception):
    pass


class BulletinBoard:
    """Abstract per-party view of the board."""

    j: int  # own party index (1-based)
    k: int  # number of parties

    def publish(self, label: str, data: bytes) -> None:
        raise NotImplementedError

    def wait_for(self, l: int, label: str) -> bytes:
        raise NotImplementedError

    def scope(self, sid: str) -> "BulletinBoard":
        """Sub-board with labels prefixed by a subprotocol sid
        (the reference scopes messages by the protocol instance tree)."""
        raise NotImplementedError

    # ------------------------------------------------------- accounting

    sent_bytes: int = 0
    received_bytes: int = 0
    waiting_time: float = 0.0


class LocalBoardHub:
    """Shared in-memory message store for k simulated parties."""

    def __init__(self, k: int):
        self.k = k
        self._messages: Dict[Tuple[int, str], bytes] = {}
        self._cond = threading.Condition()

    def post(self, j: int, label: str, data: bytes) -> None:
        with self._cond:
            key = (j, label)
            if key in self._messages:
                # Idempotent-put: a restarted party replaying identical
                # bytes resumes; a DIFFERENT payload is equivocation and
                # is refused (matches the HTTP board semantics).
                if self._messages[key] == bytes(data):
                    return
                raise BoardError(f"duplicate publish: party {j} {label!r}")
            self._messages[key] = bytes(data)
            self._cond.notify_all()

    def get(self, l: int, label: str, timeout: float = 300.0) -> bytes:
        deadline = time.monotonic() + timeout
        with self._cond:
            while (l, label) not in self._messages:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise BoardError(
                        f"timeout waiting for party {l} {label!r}"
                    )
                self._cond.wait(remaining)
            return self._messages[(l, label)]

    def delete_scope(self, prefix: str) -> None:
        """Prune every message under a scope prefix (bounds growth of a
        long-lived hub across many sessions)."""
        with self._cond:
            for key in [
                key for key in self._messages
                if key[1].startswith(prefix + "/")
            ]:
                del self._messages[key]

    def board(self, j: int) -> "LocalBoard":
        return LocalBoard(self, j, "")


class LocalBoard(BulletinBoard):
    """Party j's view of a LocalBoardHub."""

    def __init__(self, hub: LocalBoardHub, j: int, prefix: str):
        self.hub = hub
        self.j = j
        self.k = hub.k
        self.prefix = prefix
        self.sent_bytes = 0
        self.received_bytes = 0
        self.waiting_time = 0.0
        self._parent: Optional[LocalBoard] = None

    def _label(self, label: str) -> str:
        return f"{self.prefix}{label}"

    def publish(self, label: str, data: bytes) -> None:
        self._account(len(data), 0, 0.0)
        self.hub.post(self.j, self._label(label), data)

    def wait_for(self, l: int, label: str) -> bytes:
        t0 = time.monotonic()
        data = self.hub.get(l, self._label(label))
        self._account(0, len(data), time.monotonic() - t0)
        return data

    def scope(self, sid: str) -> "LocalBoard":
        child = LocalBoard(self.hub, self.j, f"{self.prefix}{sid}/")
        child._parent = self
        return child

    def delete_scope(self, sid: str) -> None:
        self.hub.delete_scope(f"{self.prefix}{sid}")

    # propagate accounting up the scope chain
    def _account(self, sent: int, received: int, waited: float):
        self.sent_bytes += sent
        self.received_bytes += received
        self.waiting_time += waited
        if self._parent is not None:
            self._parent._account(sent, received, waited)

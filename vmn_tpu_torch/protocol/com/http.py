"""Port of `vmn_tpu.protocol.com.http`: the same wire format, spool,
hints and accounting.  It moves bytes only: no tensor crosses a socket.
Beside `vmn_tpu`'s accounting the root board sums the seconds spent
signing (`sign_time`) and verifying (`verify_time`) messages, which are
host `pow`s (`crypto.signature`).

Signed HTTP bulletin board over DCN.

Rebuild of the reference's distributed communication backend
(reference: SURVEY.md §2.4 protocol.com — every party runs an HTTP
server hosting its own published messages; peers fetch and verify
signatures; a UDP "hint" datagram wakes waiting peers so they re-poll
immediately instead of backing off).

Message wire format (byte tree):

    node(leaf(payload), leaf(signature))

where signature = Schnorr_sk(sid-scoped-label || sender || payload).
This boundary is between mutually-distrusting parties: it must stay
authenticated HTTP and never become a device collective.
"""

from __future__ import annotations

import socket
import threading
import time
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from vmn_tpu_torch.crypto.signature import SignatureKeyPair, SignaturePKey
from vmn_tpu_torch.eio.bytetree import ByteTree, leaf, node
from vmn_tpu_torch.protocol.com.board import BoardError, BulletinBoard


def _sign_payload(label: str, sender: int, payload: bytes) -> bytes:
    return (
        label.encode("utf-8") + b"\x00"
        + sender.to_bytes(4, "big") + payload
    )


class _Store:
    """Published messages of the local party, served over HTTP.

    Disk-backed when a spool directory is given: every published blob
    is written to disk (and re-served from there after a restart, so
    peers can re-fetch everything a crashed party already published —
    the board side of crash recovery), and only blobs up to
    `CACHE_LIMIT` bytes stay in the in-memory cache, bounding RAM for
    large-N transcripts."""

    CACHE_LIMIT = 1 << 20  # keep blobs <= 1 MB in RAM

    def __init__(self, directory=None):
        self._data: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self._dir = None
        if directory is not None:
            from pathlib import Path

            self._dir = Path(directory)
            self._dir.mkdir(parents=True, exist_ok=True)

    def _path(self, label: str):
        import hashlib
        from urllib.parse import quote

        parts = label.split("/")
        if len(parts) > 1:
            # one spool subdirectory per scope SEGMENT (e.g.
            # "session.<auxsid>/shuffle/...") so `delete_scope` of ANY
            # scope prefix — root or nested — maps to one directory
            # (reference: MixNetElGamalSession.deleteState:136-150)
            sub = self._dir
            for seg in parts[:-1]:
                sub = sub / quote(seg, safe="")
            sub.mkdir(parents=True, exist_ok=True)
            return sub / hashlib.sha256(parts[-1].encode()).hexdigest()
        return self._dir / hashlib.sha256(label.encode()).hexdigest()

    def delete_scope(self, prefix: str):
        """Remove every message whose label lives under `prefix`."""
        import shutil
        from urllib.parse import quote

        with self._lock:
            for k in [k for k in self._data if k.startswith(prefix + "/")]:
                del self._data[k]
            if self._dir is not None:
                sub = self._dir
                for seg in prefix.split("/"):
                    sub = sub / quote(seg, safe="")
                if sub.exists():
                    shutil.rmtree(sub)

    def put(self, label: str, blob: bytes, spool: bool = True):
        """Publish `blob`; with spool=False it lives in memory only, so
        a later process of this party never serves it."""
        with self._lock:
            prev = self._data.get(label)
            if prev is None and self._dir is not None and spool:
                p = self._path(label)
                if p.exists():
                    prev = p.read_bytes()
            if prev is not None:
                # Idempotent re-publish after restart is a no-op; a
                # CHANGED message under the same label breaks the
                # append-only discipline and is refused.
                if prev == blob:
                    return
                raise BoardError(f"duplicate publish {label!r}")
            if self._dir is not None and spool:
                tmp = self._path(label).with_suffix(".tmp")
                tmp.write_bytes(blob)
                tmp.replace(self._path(label))
                if len(blob) <= self.CACHE_LIMIT:
                    self._data[label] = blob
            else:
                self._data[label] = blob

    def get(self, label: str) -> Optional[bytes]:
        with self._lock:
            blob = self._data.get(label)
            if blob is None and self._dir is not None:
                p = self._path(label)
                if p.exists():
                    blob = p.read_bytes()
            return blob


class HTTPBulletinBoard(BulletinBoard):
    """Party j's view: serves own messages, polls peers for theirs."""

    POLL_INTERVAL = 0.2
    TIMEOUT = 600.0

    def __init__(self, prot, priv, j: int, prefix: str = ""):
        self.prot = prot
        self.j = j
        self.k = prot.nopart
        self.prefix = prefix
        self.sent_bytes = 0
        self.received_bytes = 0
        self.waiting_time = 0.0
        self.network_time = 0.0
        self.sign_time = 0.0
        self.verify_time = 0.0
        self._parent = None

        # Configurable patience (reference: the board timeouts are
        # operator-tunable; env override keeps info files stable).
        import os

        self.TIMEOUT = float(
            os.environ.get("VMN_BOARD_TIMEOUT", self.TIMEOUT)
        )
        if prefix == "":
            spool = None
            if getattr(priv, "dir", None):
                from pathlib import Path

                spool = Path(priv.dir) / "board"
            self._store = _Store(spool)
            self._skey = SignatureKeyPair.from_hex(priv.skey)
            self._pkeys = {
                i + 1: SignaturePKey.from_hex(p.pkey)
                for i, p in enumerate(prot.parties)
            }
            self._urls = {
                i + 1: p.http.rstrip("/")
                for i, p in enumerate(prot.parties)
            }
            self._hints = {}
            for i, p in enumerate(prot.parties):
                if p.hint:
                    host, port = p.hint.rsplit(":", 1)
                    self._hints[i + 1] = (host, int(port))
            from vmn_tpu_torch.crypto.randomsource import RandomDevice

            self._rs = RandomDevice()
            self._hint_event = threading.Event()
            self._start_server(priv, prot)

    # ------------------------------------------------------------ server

    def _start_server(self, priv, prot):
        me = prot.parties[self.j - 1]
        url = urllib.parse.urlparse(me.http)
        store = self._store
        hint_event = self._hint_event

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence
                pass

            def do_GET(self):  # noqa: N802
                label = urllib.parse.unquote(self.path.lstrip("/"))
                blob = store.get(label)
                if blob is None:
                    self.send_response(404)
                    self.end_headers()
                else:
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(blob)))
                    self.end_headers()
                    self.wfile.write(blob)

        self._server = ThreadingHTTPServer(
            ("0.0.0.0", url.port), Handler
        )
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()

        # Hint server: any datagram wakes local waiters.
        if self.j in self._hints:
            _, hint_port = self._hints[self.j]
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            sock.bind(("0.0.0.0", hint_port))
            # A close from another thread does not wake a blocked
            # receive, which would hold the port: the loop looks at
            # `stop` between short receives, and `shutdown` joins it.
            sock.settimeout(self.POLL_INTERVAL)
            stop = threading.Event()

            def hint_loop():
                while not stop.is_set():
                    try:
                        sock.recvfrom(16)
                        hint_event.set()
                    except socket.timeout:
                        continue
                    except OSError:
                        return

            self._hint_thread = threading.Thread(target=hint_loop,
                                                 daemon=True)
            self._hint_thread.start()
            self._hint_sock, self._hint_stop = sock, stop

    def shutdown(self):
        if self.prefix == "":
            self._server.shutdown()
            self._server.server_close()  # release the listening port
            if hasattr(self, "_hint_sock"):
                self._hint_stop.set()
                self._hint_thread.join()
                self._hint_sock.close()

    # ------------------------------------------------------------- verbs

    def _root(self) -> "HTTPBulletinBoard":
        b = self
        while b._parent is not None:
            b = b._parent
        return b

    def publish(self, label: str, data: bytes, spool: bool = True) -> None:
        """Sign and serve `data` under `label`; with spool=False only
        in this process's memory (the closing round's messages)."""
        root = self._root()
        full = f"{self.prefix}{label}"
        prev = root._store.get(full)
        if prev is not None:
            # Idempotent re-publish after a restart (same payload under
            # a fresh randomized signature) is a no-op; changed content
            # breaks append-only and is refused in the store.
            if ByteTree.from_bytes(prev)[0].data == data:
                return
        ts = time.perf_counter()
        sig = root._skey.sign(
            _sign_payload(full, self.j, data), root._rs
        )
        root.sign_time += time.perf_counter() - ts
        blob = node(leaf(data), leaf(sig)).to_bytes()
        root._store.put(full, blob, spool)
        self._account(len(data), 0, 0.0)
        # hint everyone
        for l, (host, port) in root._hints.items():
            if l != self.j:
                try:
                    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                    s.sendto(b"h", (host, port))
                    s.close()
                except OSError:
                    pass

    def wait_for(self, l: int, label: str,
                 gone_unless: Optional[str] = None):
        """Party l's message under `label`, its signature checked.  With
        `gone_unless`, None once party l's process that published the
        in-memory message `gone_unless` has ended: its server refuses
        connections, or a later process serves the port without it."""
        root = self._root()
        full = f"{self.prefix}{label}"
        url = f"{root._urls[l]}/{urllib.parse.quote(full, safe='')}"
        t0 = time.monotonic()
        deadline = t0 + self.TIMEOUT
        net = 0.0  # transfer time vs idle waiting (postlude split)
        while True:
            ta = time.monotonic()
            try:
                with urllib.request.urlopen(url, timeout=10) as resp:
                    blob = resp.read()
                net += time.monotonic() - ta
                break
            except (OSError, urllib.error.URLError) as e:
                net += time.monotonic() - ta
                if gone_unless is not None and self._gone(l, gone_unless, e):
                    return None
                if time.monotonic() > deadline:
                    raise BoardError(
                        f"timeout waiting for party {l} {full!r}"
                    )
                root._hint_event.wait(self.POLL_INTERVAL)
                root._hint_event.clear()
        bt = ByteTree.from_bytes(blob)
        data = bt[0].data
        sig = bt[1].data
        ts = time.perf_counter()
        ok = root._pkeys[l].verify(_sign_payload(full, l, data), sig)
        root.verify_time += time.perf_counter() - ts
        if not ok:
            raise BoardError(f"bad signature from party {l} on {full!r}")
        self._account(
            0, len(data), time.monotonic() - t0 - net, network=net
        )
        return data

    def _gone(self, l: int, label: str, err) -> bool:
        """Has party l's process that served `label` ended?"""
        if isinstance(getattr(err, "reason", err), ConnectionRefusedError):
            return True
        if getattr(err, "code", None) != 404:
            return False
        full = urllib.parse.quote(f"{self.prefix}{label}", safe="")
        try:
            with urllib.request.urlopen(f"{self._root()._urls[l]}/{full}",
                                        timeout=10):
                return False
        except urllib.error.HTTPError as e:
            return e.code == 404
        except OSError:
            return False

    def close(self, tag: str, active=None) -> None:
        """The closing round of one operation, then stop serving.

        A party must keep serving until every peer has read what it
        published: `vmn_tpu`'s `vmn` stops when its own work ends, so a
        slower peer that has still to fetch its last messages waits for
        the timeout (fault F11).  Round 1: each party publishes `Done`
        after its last read and waits for every active peer's `Done`
        (`active[l]`, all parties when None); once it has them, every
        peer has read all it needed of the operation.  Round 2: it
        publishes `Exit` and waits for every active peer's `Exit`, or
        for the end of the process that published that peer's `Done` (a
        peer leaves only after round 2, so it has read this party's
        `Done`).  Both messages live in this process's memory only, so
        a later run of the same operation never reads them."""
        root = self._root()
        b = root.scope(f"close.{tag}")
        peers = [l for l in range(1, self.k + 1)
                 if l != self.j and (active is None or active[l])]
        b.publish("Done", b"", spool=False)
        for l in peers:
            b.wait_for(l, "Done")
        b.publish("Exit", b"", spool=False)
        for l in peers:
            b.wait_for(l, "Exit", gone_unless="Done")
        root.shutdown()

    def delete_scope(self, sid: str) -> None:
        """Remove OWN published messages under a session scope — the
        board half of `vmn -delete` (reference:
        MixNetElGamalSession.deleteState:136-150)."""
        self._root()._store.delete_scope(f"{self.prefix}{sid}")

    def scope(self, sid: str) -> "HTTPBulletinBoard":
        child = HTTPBulletinBoard.__new__(HTTPBulletinBoard)
        child.prot = self.prot
        child.j = self.j
        child.k = self.k
        child.prefix = f"{self.prefix}{sid}/"
        child.sent_bytes = 0
        child.received_bytes = 0
        child.waiting_time = 0.0
        child.network_time = 0.0
        child._parent = self
        return child

    def _account(self, sent, received, waited, network=0.0):
        self.sent_bytes += sent
        self.received_bytes += received
        self.waiting_time += waited
        self.network_time = getattr(self, "network_time", 0.0) + network
        if self._parent is not None:
            self._parent._account(sent, received, waited, network)

"""Port of `vmn_tpu.cli.vhttp`.

`vhttp` — standalone bulletin-board HTTP server.

Rebuild of the reference's SimpleHTTPServerTool (reference:
src/bin/vhttp.src:40-42 — serves a directory of published messages so a
mix-server behind NAT can host its board on a separate machine).

    vhttp [-port PORT] [-root DIR]

Serves GET <label> from files under DIR (label URL-quoted, one file per
message, written by the mix-server as it publishes).
"""

from __future__ import annotations

import argparse
import sys
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path


def make_server(port: int, root: Path) -> ThreadingHTTPServer:
    root = Path(root)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):  # noqa: N802
            label = urllib.parse.unquote(self.path.lstrip("/"))
            # one file per message; '/' in scoped labels maps to dirs
            path = (root / label).resolve()
            if not str(path).startswith(str(root.resolve())) \
                    or not path.is_file():
                self.send_response(404)
                self.end_headers()
                return
            blob = path.read_bytes()
            self.send_response(200)
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

    return ThreadingHTTPServer(("0.0.0.0", port), Handler)


def main(argv=None, device="cuda") -> int:
    """`device` is unused: the tool moves bytes only."""
    p = argparse.ArgumentParser(prog="vhttp", description=__doc__)
    p.add_argument("-port", type=int, default=8040)
    p.add_argument("-root", default="http_root")
    args = p.parse_args(argv)
    Path(args.root).mkdir(parents=True, exist_ok=True)
    server = make_server(args.port, Path(args.root))
    print(f"vhttp serving {args.root} on :{args.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())

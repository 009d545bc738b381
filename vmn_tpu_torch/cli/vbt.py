"""Port of `vmn_tpu.cli.vbt`.

`vbt` — dump byte-tree files as JSON-like text
(reference: VCR's vbt developer tool, referenced in SURVEY.md §2.2)."""

from __future__ import annotations

import argparse
import sys

from vmn_tpu_torch.eio.bytetree import ByteTree


def main(argv=None, device="cuda") -> int:
    """`device` is unused: the tool moves bytes only."""
    p = argparse.ArgumentParser(prog="vbt", description=__doc__)
    p.add_argument("file")
    p.add_argument("-hex", action="store_true",
                   help="input is a hex string file")
    args = p.parse_args(argv)
    if args.hex:
        with open(args.file) as f:
            bt = ByteTree.from_hex(f.read().strip())
    else:
        bt = ByteTree.read_file(args.file)
    print(bt.pretty())
    return 0


if __name__ == "__main__":
    sys.exit(main())

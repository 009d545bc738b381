"""Port of `vmn_tpu.cli.vre`.

`vre` — re-arrangement of keys / ciphertexts / plaintexts.

Rebuild of the reference re-arrangement tool (reference:
ProtocolElGamalRearTool.java:608-694 — split / concatenate / project
public keys, ciphertexts and plaintexts across widths, so sessions of
different widths can run against the same key).

Supported operations (on raw byte-tree files):

    vre -ciphs -cat a.bt b.bt ... out.bt      concatenate element-wise
    vre -ciphs -sub START END in.bt out.bt    slice the batch axis
    vre -ciphs -project IDX in.bt out.bt      project one width component
    vre -ciphs -widths W1,W2 in.bt o1.bt o2.bt  split width into parts
    (same flags with -pkeys / -plain)
"""

from __future__ import annotations

import argparse
import sys

from vmn_tpu_torch.eio.bytetree import ByteTree, node


def _cat(trees):
    """Element-wise concatenation of array byte trees of equal shape."""
    first = trees[0]
    if first.is_leaf or all(c.is_leaf for c in first.children):
        # array of scalars: concatenate children
        kids = []
        for t in trees:
            kids.extend(t.children)
        return node(*kids)
    return node(*[
        _cat([t.children[i] for t in trees])
        for i in range(len(first.children))
    ])


def _sub(tree, a, b):
    if all(c.is_leaf for c in tree.children):
        return node(*tree.children[a:b])
    return node(*[_sub(c, a, b) for c in tree.children])


def main(argv=None, device="cuda") -> int:
    """`device` is unused: the tool moves bytes only."""
    p = argparse.ArgumentParser(prog="vre", description=__doc__)
    kind = p.add_mutually_exclusive_group(required=True)
    kind.add_argument("-pkeys", action="store_true")
    kind.add_argument("-ciphs", action="store_true")
    kind.add_argument("-plain", action="store_true")
    op = p.add_mutually_exclusive_group(required=True)
    op.add_argument("-cat", action="store_true")
    op.add_argument("-sub", nargs=2, type=int, metavar=("START", "END"))
    op.add_argument("-project", type=int, metavar="IDX")
    op.add_argument("-widths", metavar="W1,W2,...")
    op.add_argument("-shallow", action="store_true",
                    help="split into width-1 parts (one output per "
                    "component; reference: ProtocolElGamalRearTool "
                    "-shallow)")
    op.add_argument("-deep", action="store_true",
                    help="inverse of -shallow: join width-1 parts "
                    "into one wide object")
    op.add_argument("-format", dest="fmt", metavar="FMT",
                    help="(i,j) position mini-language, e.g. "
                    "'(0,1)x(3,2):(0,0-2)' — sources x components, "
                    "':' separates outputs (reference: RearParser, "
                    "ProtocolElGamalRearTool.java:608-694)")
    op.add_argument("-inter", metavar="INTERVALS",
                    help="colon-separated 's-e' batch intervals, one "
                    "per output file")
    p.add_argument("-noin", action="store_true",
                   help="outputs only; infer structure without an "
                   "input template")
    p.add_argument("files", nargs="+")
    args = p.parse_args(argv)

    if args.shallow:
        # one output file per width component
        infile, *outs = args.files
        bt = ByteTree.read_file(infile)
        if args.ciphs:
            u, v = bt.children
            w = len(u.children) if not u.is_leaf else 1
            if len(outs) != w:
                raise SystemExit(f"need {w} output files")
            for i, out in enumerate(outs):
                node(u.children[i], v.children[i]).write_file(out)
        else:
            if len(outs) != len(bt.children):
                raise SystemExit(f"need {len(bt.children)} output files")
            for child, out in zip(bt.children, outs):
                child.write_file(out)
        print("ok")
        return 0
    if args.deep:
        *ins, out = args.files
        trees = [ByteTree.read_file(f) for f in ins]
        if args.ciphs:
            node(
                node(*[t.children[0] for t in trees]),
                node(*[t.children[1] for t in trees]),
            ).write_file(out)
        else:
            node(*trees).write_file(out)
        print("ok")
        return 0

    if args.fmt:
        from vmn_tpu_torch.protocol.rear import RearFormatError, apply_format

        n_out = len(args.fmt.split(":"))
        ins = args.files[: len(args.files) - n_out]
        outs = args.files[len(args.files) - n_out:]
        if not ins:
            raise SystemExit("need at least one input file")
        try:
            results = apply_format(
                args.fmt,
                [ByteTree.read_file(f) for f in ins],
                args.ciphs,
            )
        except RearFormatError as e:
            raise SystemExit(f"vre: {e}")
        for bt, out in zip(results, outs):
            bt.write_file(out)
        print("ok")
        return 0
    if args.inter:
        from vmn_tpu_torch.protocol.rear import (
            RearFormatError,
            parse_intervals,
        )

        try:
            intervals = parse_intervals(args.inter)
        except RearFormatError as e:
            raise SystemExit(f"vre: {e}")
        infile, *outs = args.files
        if len(outs) != len(intervals):
            raise SystemExit("need one output per interval")
        bt = ByteTree.read_file(infile)
        for (a, b), out in zip(intervals, outs):
            _sub(bt, a, b).write_file(out)
        print("ok")
        return 0

    if args.cat:
        *ins, out = args.files
        trees = [ByteTree.read_file(f) for f in ins]
        _cat(trees).write_file(out)
    elif args.sub:
        a, b = args.sub
        infile, out = args.files
        _sub(ByteTree.read_file(infile), a, b).write_file(out)
    elif args.project is not None:
        infile, out = args.files
        bt = ByteTree.read_file(infile)
        if args.ciphs:
            # ciphertext ((u...),(v...)): project component of each part
            u, v = bt.children
            node(u.children[args.project],
                 v.children[args.project]).write_file(out)
        else:
            bt.children[args.project].write_file(out)
    else:
        widths = [int(w) for w in args.widths.split(",")]
        infile, *outs = args.files
        if len(outs) != len(widths):
            raise SystemExit("need one output per width")
        bt = ByteTree.read_file(infile)
        off = 0
        for w, out in zip(widths, outs):
            if args.ciphs:
                u, v = bt.children
                uu = u.children[off:off + w]
                vv = v.children[off:off + w]
                part = node(
                    node(*uu) if w > 1 else uu[0],
                    node(*vv) if w > 1 else vv[0],
                )
            else:
                kids = bt.children[off:off + w]
                part = node(*kids) if w > 1 else kids[0]
            part.write_file(out)
            off += w
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())

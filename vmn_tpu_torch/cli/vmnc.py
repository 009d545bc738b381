"""Port of `vmn_tpu.cli.vmnc`.

`vmnc` — converter between external formats.

Rebuild of the reference converter CLI (reference:
ProtocolElGamalInterfaceTool.java:129-160 — `-pkey/-ciphs/-plain`
with `-ini`/`-outi` interface names).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None, device="cuda") -> int:
    p = argparse.ArgumentParser(prog="vmnc", description=__doc__)
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("-pkey", action="store_true")
    mode.add_argument("-ciphs", action="store_true")
    mode.add_argument("-plain", action="store_true")
    p.add_argument("infile")
    p.add_argument("outfile")
    p.add_argument("-ini", default="raw")
    p.add_argument("-outi", default="raw")
    p.add_argument("-pgroup", default="named:modp2048")
    p.add_argument("-width", type=int, default=1)
    args = p.parse_args(argv)

    from vmn_tpu_torch.arith.pgroup import ModPGroup
    from vmn_tpu_torch.eio.marshal import unmarshal_hex
    from vmn_tpu_torch.protocol import elgamal
    from vmn_tpu_torch.protocol.interfaces import get_interface

    if args.pgroup.startswith("named:"):
        group = ModPGroup.named(args.pgroup[len("named:"):], device)
    else:
        group = unmarshal_hex(args.pgroup, device)

    iface_in = get_interface(args.ini)
    iface_out = get_interface(args.outi)

    if args.pkey:
        pk = iface_in.read_public_key(group, args.infile)
        iface_out.write_public_key(pk, args.outfile)
    elif args.ciphs:
        cg = elgamal.ciph_group(group, args.width)
        ciphs = iface_in.read_ciphertexts(cg, args.infile)
        iface_out.write_ciphertexts(ciphs, args.outfile)
    else:
        pg = elgamal.plain_group(group, args.width)
        plain = iface_in.read_plaintexts(pg, args.infile)
        iface_out.write_plaintexts(plain, args.outfile)
    print(f"converted {args.infile} ({args.ini}) -> "
          f"{args.outfile} ({args.outi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

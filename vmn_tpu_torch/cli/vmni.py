"""Port of `vmn_tpu.cli.vmni`.

`vmni` — generate and merge protocol/private info files.

Rebuild of the reference info tool flow (reference:
demo/mixnet/info_files:57-199 — `vmni -prot` writes a stub,
`vmni -party` adds one party's block + private info,
`vmni -merge` merges per-party protocol infos).
"""

from __future__ import annotations

import argparse
import sys

from vmn_tpu_torch.protocol.info import PartyInfo, PrivateInfo, ProtocolInfo


def main(argv=None, device="cuda") -> int:
    p = argparse.ArgumentParser(prog="vmni", description=__doc__)
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("-prot", action="store_true",
                      help="generate protocol stub file")
    mode.add_argument("-party", action="store_true",
                      help="add party block + generate private info")
    mode.add_argument("-merge", nargs="+", metavar="PROTINFO",
                      help="merge per-party protocol infos")
    p.add_argument("-sid", default="SID")
    p.add_argument("-name", default="")
    p.add_argument("-nopart", type=int, default=1)
    p.add_argument("-thres", type=int, default=1)
    p.add_argument("-pgroup", default="named:modp2048",
                   help="named:<group> or marshalled hex")
    p.add_argument("-keywidth", type=int, default=1)
    p.add_argument("-width", type=int, default=1)
    p.add_argument("-maxciph", type=int, default=0)
    p.add_argument("-corr", default="noninteractive",
                   choices=["interactive", "noninteractive"])
    p.add_argument("-prg", default="SHA-256")
    p.add_argument("-rohash", default="SHA-256")
    p.add_argument("-stub", default="stub.xml")
    p.add_argument("-http", default="")
    p.add_argument("-hint", default="")
    p.add_argument("-pkey", default="")
    p.add_argument("-skey", default="")
    p.add_argument("-dir", default=".")
    p.add_argument("-rand", default="RandomDevice")
    p.add_argument("-seed", default="")
    p.add_argument("-arrays", default="ram")
    p.add_argument("-out", default=None,
                   help="output file (default per mode)")
    args = p.parse_args(argv)

    if args.prot:
        pi = ProtocolInfo(
            sid=args.sid, name=args.name, nopart=args.nopart,
            thres=args.thres, pgroup=args.pgroup, keywidth=args.keywidth,
            width=args.width, maxciph=args.maxciph, corr=args.corr,
            prg=args.prg, rohash=args.rohash,
        )
        out = args.out or args.stub
        pi.write(out)
        print(f"wrote {out}")
        return 0

    if args.party:
        pi = ProtocolInfo.read(args.stub)
        pkey, skey = args.pkey, args.skey
        if not pkey and not skey:
            # Generate the bulletin-board signature keypair like the
            # reference info tool does (reference: demo/mixnet/
            # info_files:57-199 — vmni -party emits fresh `pkey`/`skey`).
            from vmn_tpu_torch.crypto.provable import resolve_random_source
            from vmn_tpu_torch.crypto.signature import SignatureKeyPair

            rs = resolve_random_source(args.rand, directory=args.dir,
                                       device=device)
            kp = SignatureKeyPair.generate(rs)
            pkey, skey = kp.public.to_hex(), kp.to_hex()
        pi.parties.append(PartyInfo(
            name=args.name, pkey=pkey, http=args.http,
            hint=args.hint,
        ))
        out = args.out or "localProtInfo.xml"
        pi.write(out)
        priv = PrivateInfo(
            name=args.name, dir=args.dir, rand=args.rand,
            skey=skey, arrays=args.arrays, seed=args.seed,
        )
        priv.write("privInfo.xml")
        print(f"wrote {out} and privInfo.xml")
        return 0

    # merge
    infos = [ProtocolInfo.read(f) for f in args.merge]
    merged = infos[0]
    for other in infos[1:]:
        merged = merged.merge(other)
    if len(merged.parties) != merged.nopart:
        print(
            f"warning: {len(merged.parties)} parties != nopart"
            f" {merged.nopart}", file=sys.stderr,
        )
    out = args.out or "protInfo.xml"
    merged.write(out)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

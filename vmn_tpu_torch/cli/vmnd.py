"""Port of `vmn_tpu.cli.vmnd`: the same keys and ciphertexts for the
same seed, on `device`.  Messages are encoded as a batch
(`ModPGroup.encode_messages`: one native Jacobi pass decides every
message's QR branch), which gives `encode_message`'s elements.

`vmnd` — demo key and ciphertext generator.

Rebuild of the reference demo tool (reference:
ProtocolElGamalDemo.java:82-117 — `-pkey` makes a demo key pair,
`-ciphs` encrypts counter plaintexts for any interface).
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None, device="cuda") -> int:
    p = argparse.ArgumentParser(prog="vmnd", description=__doc__)
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("-pkey", action="store_true",
                      help="generate a demo public key")
    mode.add_argument("-ciphs", metavar="PUBLICKEY",
                      help="encrypt demo plaintexts under PUBLICKEY")
    p.add_argument("out")
    p.add_argument("-N", type=int, default=10, help="number of ciphertexts")
    p.add_argument("-width", type=int, default=1)
    p.add_argument("-pgroup", default="named:modp2048")
    p.add_argument("-i", default="raw", help="interface name")
    p.add_argument("-seed", default="demo", help="deterministic seed")
    args = p.parse_args(argv)

    from vmn_tpu_torch.arith.pgroup import ModPGroup
    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.eio.marshal import unmarshal_hex
    from vmn_tpu_torch.protocol import elgamal
    from vmn_tpu_torch.protocol.interfaces import get_interface

    if args.pgroup.startswith("named:"):
        group = ModPGroup.named(args.pgroup[len("named:"):], device)
    else:
        group = unmarshal_hex(args.pgroup, device)
    iface = get_interface(args.i)
    rs = SeededSource(args.seed.encode())

    if args.pkey:
        kp = elgamal.keygen(group, rs)
        iface.write_public_key(kp.pk, args.out)
        print(f"wrote demo public key to {args.out}")
        return 0

    pk = iface.read_public_key(group, args.ciphs)
    wide = pk.widen(args.width)
    plain = elgamal.plain_group(group, args.width)
    n = args.N
    msgs = [f"{i:08d}".encode() for i in range(n)]
    t0 = time.perf_counter()
    m = group.encode_messages(msgs)
    if args.width > 1:
        from vmn_tpu_torch.arith.pgroup import PPArray

        m = PPArray(plain, (m,) * args.width)
    encode_s = time.perf_counter() - t0
    r = plain.ring.random((n,), rs, 0)
    ciphs = elgamal.encrypt(wide, m, r)
    iface.write_ciphertexts(ciphs, args.out)
    print(f"wrote {n} demo ciphertexts to {args.out} "
          f"(encoding {encode_s:.3f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

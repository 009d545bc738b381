"""Port of `vmn_tpu.cli.vog`: the same `comment::hex` strings; a group
it generates is built on `device`.

`vog` — object generator.

Rebuild of VCR's GeneratorTool (`vog`), which turns template strings
into marshalled-hex object descriptions used in protocol-info files
(reference: the `vog` command referenced throughout `demo/mixnet/` and
SURVEY.md §2.2; objects are configured as marshalled hex strings
unmarshalled in ProtocolElGamal.java:362-434).

    vog -gen ModPGroup -name modp2048
    vog -gen ECqPGroup -name P-256
    vog -gen PRGHeuristic [-hash SHA-256]
    vog -gen PRGElGamal -name modp2048
    vog -gen HashfunctionHeuristic SHA-256
    vog -gen HashfunctionPedersen -name modp2048
    vog -gen HashfunctionMerkleDamgaard -name modp2048
    vog -gen RandomDevice [/dev/urandom]
    vog -gen SignatureKeyGenHeuristic [-name modp2048]
    vog -list                 (list generatable classes)

Output is `comment::hex`, directly pastable into info files.
"""

from __future__ import annotations

import argparse
import sys


def _modp(name, device):
    from vmn_tpu_torch.arith.pgroup import ModPGroup

    return ModPGroup.named(name, device)


def main(argv=None, device="cuda") -> int:
    p = argparse.ArgumentParser(prog="vog", description=__doc__)
    p.add_argument("-gen", default=None, metavar="CLASS",
                   help="class to generate an instance of")
    p.add_argument("-list", action="store_true",
                   help="list generatable classes")
    p.add_argument("-name", default="modp2048",
                   help="named group / curve parameter")
    p.add_argument("-hash", default="SHA-256", dest="hashname",
                   help="underlying hash algorithm")
    p.add_argument("-width", type=int, default=None,
                   help="width parameter for provable primitives")
    p.add_argument("-bitlen", type=int, default=None,
                   help="generate a FRESH safe-prime ModPGroup of this "
                        "bit length (Miller-Rabin; reference: vog "
                        "ModPGroup generation via gmpmee primality)")
    p.add_argument("args", nargs="*", help="positional template args")
    args = p.parse_args(argv)

    classes = [
        "ModPGroup", "ECqPGroup", "PRGHeuristic", "PRGElGamal",
        "HashfunctionHeuristic", "HashfunctionPedersen",
        "HashfunctionMerkleDamgaard", "RandomDevice",
        "SignatureKeyGenHeuristic",
    ]
    if args.list or args.gen is None:
        for c in classes:
            print(c)
        return 0

    from vmn_tpu_torch.eio.marshal import marshal_hex

    gen = args.gen
    if gen == "ModPGroup":
        if args.bitlen:
            from vmn_tpu_torch.crypto.primes import random_group
            from vmn_tpu_torch.crypto.randomsource import RandomDevice

            obj = random_group(args.bitlen, RandomDevice(), device=device)
            comment = f"ModPGroup(fresh {args.bitlen}-bit safe prime)"
        else:
            obj = _modp(args.name, device)
            comment = f"ModPGroup({args.name})"
    elif gen == "ECqPGroup":
        from vmn_tpu_torch.arith.ec import ECqPGroup

        name = args.args[0] if args.args else args.name
        obj = ECqPGroup.named(name, device)
        comment = f"ECqPGroup({name})"
    elif gen == "PRGHeuristic":
        from vmn_tpu_torch.crypto.hash import Hashfunction
        from vmn_tpu_torch.crypto.prg import PRGHeuristic

        obj = PRGHeuristic(Hashfunction(args.hashname))
        comment = f"PRGHeuristic({args.hashname})"
    elif gen == "PRGElGamal":
        from vmn_tpu_torch.crypto.provable import PRGElGamal

        kw = {"width": args.width} if args.width else {}
        obj = PRGElGamal(_modp(args.name, device), **kw)
        comment = f"PRGElGamal({args.name})"
    elif gen == "HashfunctionHeuristic":
        from vmn_tpu_torch.crypto.hash import Hashfunction

        name = args.args[0] if args.args else args.hashname
        obj = Hashfunction(name)
        comment = f"HashfunctionHeuristic({name})"
    elif gen == "HashfunctionPedersen":
        from vmn_tpu_torch.crypto.provable import HashfunctionPedersen

        kw = {"width": args.width} if args.width else {}
        obj = HashfunctionPedersen(_modp(args.name, device), **kw)
        comment = f"HashfunctionPedersen({args.name})"
    elif gen == "HashfunctionMerkleDamgaard":
        from vmn_tpu_torch.crypto.provable import (
            HashfunctionMerkleDamgaard,
            HashfunctionPedersen,
        )

        inner = HashfunctionPedersen(_modp(args.name, device))
        obj = HashfunctionMerkleDamgaard(inner)
        comment = f"HashfunctionMerkleDamgaard({args.name})"
    elif gen == "RandomDevice":
        from vmn_tpu_torch.crypto.randomsource import RandomDevice

        obj = RandomDevice()
        comment = "RandomDevice(/dev/urandom)"
    elif gen == "SignatureKeyGenHeuristic":
        from vmn_tpu_torch.crypto.randomsource import RandomDevice
        from vmn_tpu_torch.crypto.signature import SignatureKeyPair

        pair = SignatureKeyPair.generate(RandomDevice(), args.name)
        print("pub::" + pair.public.to_hex())
        print("priv::" + pair.to_hex())
        return 0
    else:
        print(f"unknown class: {gen}; known: {', '.join(classes)}",
              file=sys.stderr)
        return 1

    print(marshal_hex(obj, comment))
    return 0


if __name__ == "__main__":
    sys.exit(main())

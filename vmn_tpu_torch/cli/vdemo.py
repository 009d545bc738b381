"""Port of `vmn_tpu.cli.vdemo`: the same demo, its parties' arrays on
`device` (the card from the command line).

`vdemo` — simulated multi-party mix-net execution.

Rebuild of the reference demo harness (reference: Demo.java:168-300 —
per-party directories, signature keys, seeds and info files are
generated, all k parties run in one process as threads over localhost
HTTP bulletin boards, and cross-party postconditions are checked; the
protocol demos DemoMixNetElGamal.java:80-150 assert plaintext-multiset
preservation).

    vdemo [-k K] [-t T] [-n N] [-width W] [-group NAME]
          [-precomp] [-interactive] [-local] demoroot

By default the real signed localhost-HTTP bulletin board + UDP hint
stack is exercised; `-local` switches to the in-memory board.
"""

from __future__ import annotations

import argparse
import socket
import sys
import threading
from pathlib import Path


def _free_ports(n: int):
    """Reserve n distinct free TCP/UDP port numbers."""
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def main(argv=None, device="cuda") -> int:
    p = argparse.ArgumentParser(prog="vdemo", description=__doc__)
    p.add_argument("demoroot", nargs="?", default=None)
    p.add_argument("-protocol", default=None, metavar="NAME",
                   help="run a per-protocol demo (reference: the 12 "
                        "DEMO_CLASSNAMES tier, Makefile.am:83-95); "
                        "NAME='all' runs the dependency-ordered suite")
    p.add_argument("-k", type=int, default=3)
    p.add_argument("-t", type=int, default=2)
    p.add_argument("-n", type=int, default=10)
    p.add_argument("-width", type=int, default=1)
    p.add_argument("-group", default="test256")
    p.add_argument("-precomp", action="store_true",
                   help="run the offline/online split")
    p.add_argument("-interactive", action="store_true",
                   help="interactive proofs (no standalone verification)")
    p.add_argument("-local", action="store_true",
                   help="in-memory board instead of localhost HTTP")
    args = p.parse_args(argv)

    if args.protocol:
        from vmn_tpu_torch.cli.demos import run_demo

        run_demo(args.protocol, args.k, args.t, device)
        return 0
    if args.demoroot is None:
        p.error("demoroot required (or use -protocol NAME)")

    from vmn_tpu_torch.arith.pgroup import ModPGroup
    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.crypto.signature import SignatureKeyPair
    from vmn_tpu_torch.protocol import elgamal
    from vmn_tpu_torch.protocol.com.board import LocalBoardHub
    from vmn_tpu_torch.protocol.info import PartyInfo, PrivateInfo, ProtocolInfo
    from vmn_tpu_torch.protocol.mixnet.party import MixNetParty
    from vmn_tpu_torch.protocol.mixnet.verifier import FiatShamirVerifier

    k, t, n, width = args.k, args.t, args.n, args.width
    root = Path(args.demoroot)
    root.mkdir(parents=True, exist_ok=True)

    if args.group.startswith("P-"):
        from vmn_tpu_torch.arith.ec import ECqPGroup

        group = ECqPGroup.named(args.group, device)
    else:
        group = ModPGroup.named(args.group, device)

    # --- setup: info files + signature keys (reference: Demo.setup) ----
    prot = ProtocolInfo(
        sid="Demo", name="demo", nopart=k, thres=t,
        pgroup=f"named:{args.group}", width=width,
        corr="interactive" if args.interactive else "noninteractive",
    )
    ports = _free_ports(2 * k)
    skeys = []
    for j in range(1, k + 1):
        pdir = root / f"Party{j:02d}"
        pdir.mkdir(parents=True, exist_ok=True)
        rs = SeededSource(f"demo-sig-{j}".encode())
        kp = SignatureKeyPair.generate(rs)
        skeys.append(kp)
        prot.parties.append(PartyInfo(
            name=f"Party{j:02d}",
            pkey=kp.public.to_hex(),
            http=f"http://127.0.0.1:{ports[2 * (j - 1)]}",
            hint=f"127.0.0.1:{ports[2 * (j - 1) + 1]}",
        ))
    prot.write(root / "protInfo.xml")
    for j in range(1, k + 1):
        pdir = root / f"Party{j:02d}"
        PrivateInfo(
            name=f"Party{j:02d}", dir=str(pdir),
            skey=skeys[j - 1].to_hex(), seed="",
        ).write(pdir / "privInfo.xml")

    params = prot.to_params(device)

    # --- boards ---------------------------------------------------------
    if args.local:
        hub = LocalBoardHub(k)
        boards = {j: hub.board(j) for j in range(1, k + 1)}
    else:
        from vmn_tpu_torch.protocol.com.http import HTTPBulletinBoard

        priv_infos = {
            j: PrivateInfo.read(root / f"Party{j:02d}" / "privInfo.xml")
            for j in range(1, k + 1)
        }
        boards = {
            j: HTTPBulletinBoard(prot, priv_infos[j], j)
            for j in range(1, k + 1)
        }

    # --- execute (reference: Demo.execute — one thread per party) ------
    results = [None] * (k + 1)
    errors = []
    parties = {}

    def run_full(j):
        try:
            rs = SeededSource(f"demo-party-{j}".encode())
            from vmn_tpu_torch.protocol.log import Log

            # Per-party log files (reference: per-party log windows,
            # Demo.java:256; teed file-only to keep demo output clean).
            party = MixNetParty(
                params, boards[j], rs, str(root / f"Party{j:02d}"),
                log=Log.tee(root / f"Party{j:02d}" / "log",
                            stdout=False),
            )
            parties[j] = party
            pk = party.keygen()
            session = party.session("demo", width)
            if args.precomp:
                session.precomp(max(n, 1))
            results[j] = (pk, session)
        except Exception:  # noqa: BLE001
            import traceback

            errors.append(traceback.format_exc())

    threads = [threading.Thread(target=run_full, args=(j,), daemon=True)
               for j in range(1, k + 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    if errors:
        print(errors[0], file=sys.stderr)
        return 1

    pk = results[1][0]
    plain_grp = elgamal.plain_group(group, width)
    enc_rs = SeededSource(b"demo-ciphertexts")
    m = group.encode_messages([f"{i:08d}".encode() for i in range(n)])
    msgs = m.to_ints()
    if width > 1:
        from vmn_tpu_torch.arith.pgroup import PPArray

        m = PPArray(plain_grp, (m,) * width)
    r = plain_grp.ring.random((n,), enc_rs, 0)
    wide_pk = pk.widen(width)
    ciphs = elgamal.encrypt(wide_pk, m, r)

    outs = [None] * (k + 1)
    errors2 = []

    def mix(j):
        try:
            outs[j] = results[j][1].mix(ciphs)
        except Exception:  # noqa: BLE001
            import traceback

            errors2.append(traceback.format_exc())

    threads = [threading.Thread(target=mix, args=(j,), daemon=True)
               for j in range(1, k + 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    if errors2:
        print(errors2[0], file=sys.stderr)
        return 1

    # --- verify (reference: factory.verify cross-party invariants) -----
    out1 = outs[1]
    got = out1.project(0).to_ints() if width > 1 else out1.to_ints()
    ok = sorted(got) == sorted(msgs)
    for j in range(2, k + 1):
        ok = ok and outs[j].equals(out1)
    print(f"plaintext multiset preserved: {ok}")

    if not args.interactive:
        nizkp = root / "Party01" / "nizkp.demo"
        res = FiatShamirVerifier(params, nizkp).verify(
            expected_type="mixing"
        )
        print(f"standalone verification: {'ok' if res.ok else 'FAILED'}")
        ok = ok and res.ok

    for b in boards.values():
        if hasattr(b, "shutdown"):
            b.shutdown()
    print("demo complete" if ok else "DEMO FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

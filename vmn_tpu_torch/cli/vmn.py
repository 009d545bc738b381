"""Port of `vmn_tpu.cli.vmn`: the same modes, files and postlude.

The party's groups and arrays live on `device` (the card from the
command line).  With out-of-core arrays (`arrays=file` in the private
info) the large resident arrays spill to `<dir>/arrays`
(`arith/storage.py`).  A file that is not a private (or protocol) info
file is refused with its reason (fault F4 of `vmn_tpu`).

`vmn` — the mix-server tool.

Rebuild of the reference mix-server CLI (reference:
MixNetElGamalTool.java:318-539 usage forms):

    vmn -keygen  privInfo protInfo publicKey
    vmn -setpk   privInfo protInfo publicKey
    vmn -precomp privInfo protInfo
    vmn -mix     privInfo protInfo ciphertexts plaintexts
    vmn -shuffle privInfo protInfo ciphertexts ciphertextsOut
    vmn -decrypt privInfo protInfo ciphertexts plaintexts
    vmn -delete  privInfo protInfo
    vmn -lact / -sact <set>   (list / set active servers)

Single-party (k=1) runs complete in-process; multi-party runs use the
HTTP bulletin board configured in the info files.  Timing and
communication are reported like the reference `postlude`
(reference: MixNetElGamalTool.java:130-207).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from vmn_tpu_torch.protocol.info import InfoError, PrivateInfo, ProtocolInfo


def _party_index(prot, priv):
    for i, p in enumerate(prot.parties):
        if p.name == priv.name:
            return i + 1
    if prot.nopart == 1:
        return 1
    raise SystemExit(f"party {priv.name!r} not found in protocol info")


def _board(prot, priv, j):
    if prot.nopart == 1:
        from vmn_tpu_torch.protocol.com.board import LocalBoardHub

        return LocalBoardHub(1).board(1)
    from vmn_tpu_torch.protocol.com.http import HTTPBulletinBoard

    return HTTPBulletinBoard(prot, priv, j)


def _mk_party(prot, priv, device, silent=False, offline=False):
    from vmn_tpu_torch.crypto.provable import resolve_random_source
    from vmn_tpu_torch.crypto.randomsource import SeededSource, take_seed_file
    from vmn_tpu_torch.protocol.log import Log
    from vmn_tpu_torch.protocol.mixnet.party import MixNetParty

    j = _party_index(prot, priv)
    # Hierarchical log teed to <dir>/log (reference: setupLogFile,
    # MixNetElGamalTool.java:771-789); -s silences stdout.
    log = (
        Log.tee(Path(priv.dir) / "log", stdout=not silent)
        if priv.dir
        else Log.tee(stdout=not silent)
    )
    if priv.arrays == "file":
        # Out-of-core arrays: spill large cached arrays to disk (reference:
        # file-mapped LargeIntegerArray toggled by the `arrays`
        # private-info field, ProtocolElGamal.java:332-345).
        from vmn_tpu_torch.arith import storage

        storage.set_backend("file", Path(priv.dir) / "arrays")
    if priv.seed:
        # Each invocation reads the seed file and leaves its successor
        # there (fault F12: vmn_tpu restarts the same stream every time,
        # so a session's seed repeats the key's first bytes).
        rs = SeededSource(take_seed_file(priv.seed))
    else:
        rs = resolve_random_source(priv.rand, directory=priv.dir,
                                   device=device)
    if offline:
        # Active-set administration (-lact/-sact) touches only local
        # state; do not bind the board's HTTP/hint ports (reference:
        # MixNetElGamalTool starts servers only in the protocol prelude,
        # MixNetElGamalTool.java:118-122,676-699).
        from vmn_tpu_torch.protocol.com.board import LocalBoardHub

        board = LocalBoardHub(prot.nopart).board(j)
    else:
        board = _board(prot, priv, j)
    party = MixNetParty(
        prot.to_params(device), board, rs, priv.dir, log=log
    )
    return party


def main(argv=None, device="cuda") -> int:
    p = argparse.ArgumentParser(prog="vmn", description=__doc__)
    mode = p.add_mutually_exclusive_group(required=True)
    for m in ("keygen", "setpk", "precomp", "mix", "shuffle", "decrypt",
              "delete", "lact"):
        mode.add_argument(f"-{m}", action="store_true")
    mode.add_argument("-sact", metavar="SET",
                      help="comma-separated active party indices")
    p.add_argument("files", nargs="*")
    p.add_argument("-auxsid", default="default")
    p.add_argument("-width", type=int, default=0)
    p.add_argument("-maxciph", type=int, default=0)
    p.add_argument("-ini", default="raw", help="input interface")
    p.add_argument("-outi", default="raw", help="output interface")
    # Reference usage-form flags (MixNetElGamalTool.java:339-391).
    p.add_argument("-s", dest="silent", action="store_true",
                   help="silent mode: no stdout output")
    p.add_argument("-e", dest="etrace", action="store_true",
                   help="print exception trace upon error")
    p.add_argument("-cerr", action="store_true",
                   help="print errors as clean strings")
    p.add_argument("-f", dest="force", action="store_true",
                   help="assume affirmative answers to interactive "
                        "confirmations (e.g. -delete)")
    args = p.parse_args(argv)
    try:
        return _run(p, args, device)
    except SystemExit as e:
        if args.etrace:
            import traceback

            traceback.print_exc()
        if args.cerr and e.code not in (0, None):
            # clean error string on stderr, exit code 1
            print(str(e.code).replace("vmn: ", ""), file=sys.stderr)
            raise SystemExit(1)
        raise


def _run(p, args, device) -> int:
    if len(args.files) < 2:
        raise SystemExit("privInfo and protInfo files required")
    try:
        priv = PrivateInfo.read(args.files[0])
        prot = ProtocolInfo.read(args.files[1])
    except InfoError as e:
        raise SystemExit(f"vmn: {e}")
    width = args.width or prot.width

    from vmn_tpu_torch.protocol.interfaces import get_interface

    iface_in = get_interface(args.ini)
    iface_out = get_interface(args.outi)

    t0 = time.time()
    party = _mk_party(
        prot, priv, device, silent=args.silent,
        offline=bool(args.lact or args.sact),
    )

    if args.sact:
        active = [False] * (party.k + 1)
        for tok in args.sact.split(","):
            active[int(tok)] = True
        party.set_active(active)
        with open(Path(priv.dir) / ".active", "w") as f:
            f.write(args.sact)
        return 0
    # Load the persisted active set BEFORE any mode that reads it
    # (-lact included — reference: MixNetElGamalTool.java:676-699 reads
    # the stored set before listing).
    if Path(priv.dir, ".active").exists():
        toks = Path(priv.dir, ".active").read_text().split(",")
        active = [False] * (party.k + 1)
        for tok in toks:
            active[int(tok)] = True
        party.set_active(active)

    if args.lact:
        print(",".join(
            str(l) for l in range(1, party.k + 1) if party.active[l]
        ))
        return 0

    if args.delete:
        # Delete SESSION state (nizkp + cached precomp), keep keys —
        # reference: MixNetElGamalSession.deleteState:136-150 with the
        # documented warning that precomputed data is never reused
        # (MixNetElGamalTool.java:487-496).  Asks for confirmation
        # unless -f (reference: MixNetElGamalTool.java:843).
        import shutil

        if not args.force and sys.stdin.isatty():
            ans = input(
                f"Delete session state for auxsid {args.auxsid!r}? "
                "Precomputed data must NEVER be reused. [y/N] "
            )
            if ans.strip().lower() not in ("y", "yes"):
                print("aborted")
                return 0

        sub = Path(priv.dir) / f"nizkp.{args.auxsid}"
        if sub.exists():
            shutil.rmtree(sub)
        if party.state is not None:
            party.state.sub(f"session.{args.auxsid}").delete()
        # Prune the session's board spool too (reference:
        # MixNetElGamalSession.deleteState:136-150).
        if hasattr(party.board, "delete_scope"):
            party.board.delete_scope(f"session.{args.auxsid}")
        print(f"deleted session state for auxsid {args.auxsid!r}")
        return 0

    if args.keygen:
        pk = party.keygen()  # persists KeyAndPoly.bt / FullPublicKey.bt
        if len(args.files) >= 3:
            iface_out.write_public_key(pk, args.files[2])
        _finish(party, t0, "key generation", "keygen")
        return 0

    if args.setpk:
        if len(args.files) < 3:
            raise SystemExit("public key file required")
        pk = iface_in.read_public_key(party.ctx.key_group(), args.files[2])
        party.set_public_key(pk)  # persists ExternalPublicKey.bt
        _postlude(party, t0, "setting public key")
        return 0

    from vmn_tpu_torch.protocol.mixnet.party import ProtocolError

    try:
        party.load_keys()
    except ProtocolError as e:
        raise SystemExit(f"vmn: {e}")
    session = party.session(args.auxsid, width)
    ciph_group = party.ctx.session(args.auxsid).ciph_group(width)

    if args.precomp:
        maxciph = args.maxciph or prot.maxciph
        if maxciph <= 0:
            raise SystemExit("-maxciph (or protInfo maxciph) required")
        session.precomp(maxciph)
        _finish(party, t0, "pre-computation", f"precomp.{args.auxsid}")
        return 0

    if len(args.files) < 4:
        raise SystemExit("input and output files required")
    try:
        ciphs = iface_in.read_ciphertexts(ciph_group, args.files[2])
    except FileNotFoundError as e:
        raise SystemExit(f"vmn: cannot read ciphertexts: {e}")
    except Exception as e:  # malformed input file
        raise SystemExit(f"vmn: malformed ciphertexts: {e}")

    try:
        if args.mix:
            out = session.mix(ciphs)
            iface_out.write_plaintexts(out, args.files[3])
        elif args.shuffle:
            out = session.shuffle(ciphs)
            iface_out.write_ciphertexts(out, args.files[3])
        elif args.decrypt:
            out = session.decrypt(ciphs)
            iface_out.write_plaintexts(out, args.files[3])
    except ProtocolError as e:
        raise SystemExit(f"vmn: {e}")
    op = "mixing" if args.mix else (
        "shuffling" if args.shuffle else "decryption")
    _finish(party, t0, op, f"{op}.{args.auxsid}")
    return 0


def _finish(party, t0, operation, tag):
    """End a multi-party operation with the board's closing round (the
    HTTP board serves until every active peer has read its messages),
    then report."""
    if hasattr(party.board, "close"):
        party.board.close(tag, active=party.active)
    _postlude(party, t0, operation)


def _postlude(party, t0, operation="operation"):
    """Full timing/communication/proof-size report with the
    Execution/Network/Effective/Idle/Computation decomposition
    (reference: MixNetElGamalTool.postlude:130-207; proof size =
    recursive nizkp directory size, ProtocolElGamal.getNizkpBytes
    :591-602)."""
    from vmn_tpu_torch.protocol.log import postlude_report

    b = party.board
    total = time.time() - t0
    nizkp_bytes = 0
    if party.directory is not None:
        nizkp_bytes = sum(
            f.stat().st_size
            for d in Path(party.directory).glob("nizkp.*")
            for f in d.rglob("*")
            if f.is_file()
        )
    postlude_report(
        party.log,
        operation,
        total,
        getattr(b, "network_time", 0.0),
        getattr(b, "waiting_time", 0.0),
        getattr(b, "sent_bytes", 0),
        getattr(b, "received_bytes", 0),
        nizkp_bytes,
    )


if __name__ == "__main__":
    sys.exit(main())

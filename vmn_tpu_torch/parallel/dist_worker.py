"""One rank of a k=1 mix with its ciphertext axis split over ranks (port
of `tools/dist_worker.py`).

Every rank runs the same single-party mix on its block of the
ciphertexts (`parallel.mesh`), writes its own copy of the transcript from
host bytes that every rank holds alike, and prints

    DIST pid=<rank> ranks=<s> dist=<joined> rows=<block> ok=<multiset>
         digest=<sha256> mix_s=<seconds> launches=<json>

the digest taken over its nizkp directory, the launches those of the
kernel wrappers in its `session.mix` alone (zeroed just before it).  The
copies must agree with each other and with the unsharded mix of the same
seeds (one process without the triplet runs that one: dist=False).

Usage (one process a rank; the triplet of `parallel.dist`):

    VMN_DIST_COORD=localhost:PORT VMN_DIST_NPROC=2 VMN_DIST_PROCID=i \\
      python -m vmn_tpu_torch.parallel.dist_worker WORKDIR \\
      [--group test256|modp2048|P-256|...] [--n N] [--golden] \\
      [--device cpu|cuda]

`--golden` mixes the inputs of tools/make_golden.py (its seeds, sid
"Golden", n = 5 messages over a ModP group, 3 over a curve), so that rank
0's transcript is the committed tests/golden/nizkp_<group>_k1; otherwise
N messages are group elements of a seeded PRG (sid "Dist", seeds
"dist-*").  The ranks run on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path


def digest(nizkp: Path) -> str:
    """SHA-256 over the nizkp directory's files in path order (name,
    then bytes)."""
    h = hashlib.sha256()
    for f in sorted(nizkp.rglob("*")):
        if f.is_file():
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()


def group_of(name: str, device):
    if name.startswith("P-"):
        from vmn_tpu_torch.arith.ec import ECqPGroup

        return ECqPGroup.named(name, device=device)
    from vmn_tpu_torch.arith.pgroup import ModPGroup

    return ModPGroup.named(name, device=device)


def host_values(arr) -> list:
    """Plaintexts as sortable host values: ints or affine points."""
    return arr.to_affine() if hasattr(arr, "to_affine") else arr.to_ints()


def mix(group, n: int, workdir: Path, mesh, golden: bool = False,
        sid: str = "Dist", tag: str = "dist", source: str = "seeded"
        ) -> dict:
    """keygen -> N messages -> encryption -> `session.mix` on ciphertexts
    split over `mesh` (the draws and the encryption too: each rank keeps
    its rows of them); returns the rank's figures.  The party's source is
    a SeededSource, or with `source="device"` a DeviceSource (its session
    then draws on the device, each rank expanding its own rows)."""
    import torch

    from vmn_tpu_torch.crypto.hash import SHA256
    from vmn_tpu_torch.crypto.prg import PRGHeuristic
    from vmn_tpu_torch.crypto.randomsource import DeviceSource, SeededSource
    from vmn_tpu_torch.ops import ec_kernels as E
    from vmn_tpu_torch.ops import mont_kernels as K
    from vmn_tpu_torch.ops import prf_kernels as PK
    from vmn_tpu_torch.parallel.dist import shard_array_global
    from vmn_tpu_torch.parallel.mesh import rows_scope
    from vmn_tpu_torch.protocol import elgamal
    from vmn_tpu_torch.protocol.com.board import LocalBoardHub
    from vmn_tpu_torch.protocol.context import ProtocolParams
    from vmn_tpu_torch.protocol.mixnet.party import MixNetParty

    if golden:
        sid, tag = "Golden", "golden"
    params = ProtocolParams(sid=sid, k=1, threshold=1, pgroup=group)
    party_source = {"seeded": SeededSource, "device": DeviceSource}[source]
    party = MixNetParty(params, LocalBoardHub(1).board(1),
                        party_source(f"{tag}-party".encode()), str(workdir))
    pk = party.keygen()
    with rows_scope(mesh, n):
        if golden:
            msgs = [group.encode_message(f"{i:08d}".encode())
                    for i in range(n)]
            m = shard_array_global(group.from_affine(msgs) if hasattr(
                group, "from_affine") else group.from_ints(msgs), mesh)
        else:
            prg = PRGHeuristic(SHA256)
            prg.set_seed(SHA256.hash(f"{tag}-msgs".encode()))
            m = group.random_array(n, prg, params.rbitlen)
        r = group.ring.random((n,), SeededSource(f"{tag}-ciphs".encode()), 0)
        ciphs = elgamal.encrypt(pk, m, r)
    party.board = LocalBoardHub(1).board(1)
    session = party.session(sid.lower(), 1)
    sync = (torch.cuda.synchronize if group.device.type == "cuda"
            else lambda: None)
    sync()
    K.reset_launches()
    E.reset_launches()
    PK.reset_launches()
    t0 = time.perf_counter()
    plain = session.mix(ciphs)
    sync()
    mix_s = time.perf_counter() - t0
    launches = {**K.LAUNCHES, **E.LAUNCHES, **PK.LAUNCHES}
    a, b = mesh.block(n)
    return {"pid": mesh.rank, "ranks": mesh.size, "rows": b - a,
            "ok": sorted(host_values(plain)) == sorted(host_values(m)),
            "digest": digest(session.nizkp), "nizkp": str(session.nizkp),
            "mix_s": mix_s, "launches": launches}


def line(res: dict, joined: bool) -> str:
    return (f"DIST pid={res['pid']} ranks={res['ranks']} dist={joined} "
            f"rows={res['rows']} "
            f"ok={res['ok']} digest={res['digest']} "
            f"mix_s={res['mix_s']:.3f} launches="
            + json.dumps({k: v for k, v in res["launches"].items() if v},
                         separators=(",", ":")))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir", type=Path)
    ap.add_argument("--group", default="test256")
    ap.add_argument("--n", type=int, default=None,
                    help="ciphertexts (default: 5, or 3 over a curve, "
                         "with --golden; else 64)")
    ap.add_argument("--golden", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from vmn_tpu_torch.parallel import dist
    from vmn_tpu_torch.parallel.mesh import ciph_mesh

    joined = dist.init_from_env(device=args.device)
    mesh = ciph_mesh(device=None if dist.is_multiprocess() else args.device)
    n = args.n or ((3 if args.group.startswith("P-") else 5)
                   if args.golden else 64)
    workdir = args.workdir / f"proc{mesh.rank}"
    workdir.mkdir(parents=True, exist_ok=True)
    res = mix(group_of(args.group, mesh.device), n, workdir, mesh,
              golden=args.golden)
    print(line(res, joined), flush=True)
    dist.shutdown()
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""Multi-process start-up and the one cross-rank transport (port of
`vmn_tpu.parallel.dist`).

One party's device work may span several processes, one rank each: every
rank runs the same protocol code, the ciphertext axis N of its arrays is
split into one block a rank (`parallel.mesh`), and the tiny partials and
the few whole arrays that cross ranks go through `exchange`, the one
function that moves data between ranks.

Launch contract (environment):

    VMN_DIST_COORD=host:port   the rendezvous address (rank 0 listens)
    VMN_DIST_NPROC=<n>         number of ranks
    VMN_DIST_PROCID=<i>        this rank, in [0, n)

`init_from_env()` joins the process group before first device use (the
CLI's `main` calls it); after it, `parallel.mesh.ciph_mesh()` spans every
rank.  Each rank computes on `device()`: ``cuda:{rank % cards}`` unless
the caller asks for the CPU.

Transport: gloo on host copies of the exchanged tensors.  Two ranks may
share one card (NCCL refuses two ranks on one device), and what crosses
ranks is small: one (L,) partial a rank for a reduction or a scan, one
row for `get` and `shift_push`, and the whole array for `permute` and for
the reads to the host that feed the byte codec and the Fiat–Shamir
hashes.  A later transport (NCCL, with one card a rank) goes behind
`exchange` alone.

Run by hand (two ranks on the CPU; each prints a digest of its nizkp
directory, which must agree):

    for i in 0 1; do VMN_DIST_COORD=localhost:29512 VMN_DIST_NPROC=2 \\
      VMN_DIST_PROCID=$i python -m vmn_tpu_torch.parallel.dist_worker \\
      /tmp/dist --device cpu & done; wait
"""

from __future__ import annotations

import atexit
import datetime
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

# Every collective fails after this long instead of hanging (a rank that
# died or skipped a collective).
TIMEOUT_S = 600

_device: Optional[torch.device] = None


def _dist():
    import torch.distributed as tdist

    return tdist


def rank_device(rank: int, device=None) -> torch.device:
    """The device a rank computes on: ``cuda:{rank % cards}`` for "cuda"
    or None, the CPU only where the caller asks for it."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device for this rank: pass device='cpu' to run on "
            "the CPU")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_from_env(device=None) -> bool:
    """Join the process group when the VMN_DIST_* triplet is set.
    Returns True when running as a rank of several.  Idempotent."""
    global _device
    coord = os.environ.get("VMN_DIST_COORD")
    if not coord:
        return False
    tdist = _dist()
    if tdist.is_initialized():
        return True
    nproc = int(os.environ["VMN_DIST_NPROC"])
    procid = int(os.environ["VMN_DIST_PROCID"])
    dev = rank_device(procid, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tdist.init_process_group(
        "gloo", init_method=f"tcp://{coord}", world_size=nproc,
        rank=procid,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _device = dev
    # leave the group before the interpreter tears down its threads
    # (gloo aborts the process otherwise)
    atexit.register(_leave)
    return True


def _leave() -> None:
    tdist = _dist()
    if tdist.is_initialized():
        tdist.destroy_process_group()


def shutdown() -> None:
    """Wait for every rank, then leave the process group: the last call
    of a rank's program."""
    tdist = _dist()
    if tdist.is_initialized():
        tdist.barrier()
        tdist.destroy_process_group()


def world_size() -> int:
    tdist = _dist()
    return tdist.get_world_size() if tdist.is_initialized() else 1


def is_multiprocess() -> bool:
    return world_size() > 1


def process_index() -> int:
    tdist = _dist()
    return tdist.get_rank() if tdist.is_initialized() else 0


def device() -> Optional[torch.device]:
    """This rank's device (None before `init_from_env`)."""
    return _device


def exchange(local: torch.Tensor, counts: Sequence[int]
             ) -> List[torch.Tensor]:
    """Every rank's block, on every rank: rank r sends its (counts[r],
    ...) tensor `local` and receives the list of all of them, as host
    tensors.  The one transport of the package: gloo all-gather of
    blocks padded to the largest count."""
    host = local.detach().cpu()
    if len(counts) == 1:
        return [host]
    if host.shape[0] != counts[process_index()]:
        raise ValueError(f"block of {host.shape[0]} rows, expected "
                         f"{counts[process_index()]}")
    flag = host.dtype == torch.bool
    if flag:  # gloo has no bool reduction type; send bytes
        host = host.to(torch.uint8)
    top = max(counts)
    buf = torch.zeros((top,) + tuple(host.shape[1:]), dtype=host.dtype)
    buf[: host.shape[0]] = host
    bufs = [torch.empty_like(buf) for _ in counts]
    _dist().all_gather(bufs, buf)
    out = [b[:c] for b, c in zip(bufs, counts)]
    return [b.bool() for b in out] if flag else out


def make_global(full_np, mesh):
    """A sharded limb tensor from host rows that every rank holds (in the
    mix-net they come from the board's bytes or from seeded sources):
    each rank keeps its own block, on its mesh's device."""
    from vmn_tpu_torch.parallel.mesh import shard_limbs

    full = torch.from_numpy(np.ascontiguousarray(full_np))
    return shard_limbs(full.to(mesh.device), mesh)


def shard_array_global(arr, mesh):
    """`parallel.mesh.shard_array` over the ranks of the process group."""
    from vmn_tpu_torch.parallel.mesh import shard_array

    return shard_array(arr, mesh)


def gather_to_host(x) -> np.ndarray:
    """The whole value of a sharded or plain tensor as a host array, on
    every rank."""
    from vmn_tpu_torch.parallel.mesh import ShardedLimbs

    if isinstance(x, ShardedLimbs):
        return torch.cat(exchange(x.local, x.mesh.counts(x.n))).numpy()
    return x.detach().cpu().numpy()

"""The port's sharded group ops (`vmn_tpu_torch.parallel`) against
`vmn_tpu` on the CPU.

Four ranks, spawned with the VMN_DIST_* triplet and joined over gloo on
the CPU (`device="cpu"`), each under a time limit, run the ops of
tests/torch_shard_ops.py on test256 arrays split over them: at N = 16
(blocks of 4) and N = 10 (3, 3, 2, 2), the ops of tests/test_sharding.py
(mul, exp, the fixed-base exp, prod, exp_prod, prods, rec_lin, sum,
permute) and the row moves and draws the sharded mix reaches; at P-256
the scalar multiple, the point addition, the sum and exp_prod of N = 3
points (blocks of 1, 1, 1 and 0).  Each result, gathered, must equal
`vmn_tpu`'s on the same seeded inputs (its XLA path on the CPU), on
every rank; the port's DeviceSource draws (ChaCha20, not `vmn_tpu`'s
Threefry), each rank expanding its own rows, must equal the port's
unsharded draws, at N = 16, 10 and 3 (an empty block).  On a CUDA
device only: two ranks on the card against the port's plain versions.

Tolerance: exact equality (integer arithmetic).
"""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest

import torch_shard_ops as ops
from torch_port_util import cuda_device, join_ranks, spawn_ranks  # noqa: F401

RANKS = 4
RANK_TIMEOUT_S = 240
KEYS = ([f"{op}_{n}" for n in ops.SIZES for op in ops.MODP_OPS]
        + list(ops.EC_OPS))
DEVICE_KEYS = [f"{op}_{n}" for n in ops.DEVICE_SIZES
               for op in ops.DEVICE_OPS]


def run_ranks(out, nranks: int, device: str) -> dict:
    """Every rank's results (the same on each), as rank 0's."""
    out.mkdir(parents=True, exist_ok=True)
    procs = spawn_ranks(["tests/torch_shard_ops.py", str(out), "--device",
                         device], nranks)
    for rc, text in join_ranks(procs, RANK_TIMEOUT_S):
        assert rc == 0, text[-3000:]
    ranks = [dict(np.load(out / f"rank{i}.npz"))
             for i in range(nranks)]
    for other in ranks[1:]:
        assert other.keys() == ranks[0].keys()
        for k in ranks[0]:
            assert np.array_equal(other[k], ranks[0][k]), k
    return ranks[0]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("shard_ops"), RANKS, "cpu")


@pytest.fixture(scope="module")
def reference():
    """vmn_tpu's results of the same ops on the same inputs."""
    from vmn_tpu.arith.ec import ECqPGroup
    from vmn_tpu.arith.pgroup import ModPGroup, Permutation
    from vmn_tpu.crypto.hash import SHA256
    from vmn_tpu.crypto.prg import PRGHeuristic
    from vmn_tpu.crypto.randomsource import SeededSource

    def prg(seed):
        g = PRGHeuristic(SHA256)
        g.set_seed(SHA256.hash(seed))
        return g

    pkg = SimpleNamespace(Permutation=Permutation, SeededSource=SeededSource,
                          prg=prg, scope=lambda n: contextlib.nullcontext())
    res = ops.modp_ops(ModPGroup.named("test256"), lambda a: a, pkg)
    res.update(ops.ec_ops(ECqPGroup.named("P-256"), lambda a: a))
    return ops.flat(res, np.asarray)


def parts(results: dict, key: str) -> dict:
    return {k: v for k, v in results.items() if k.split(":")[0] == key}


def test_n_row_results_stay_sharded(sharded):
    """Every result of N rows is a block on each rank (the ops ran on
    the blocks), every one-element result a replicated tensor."""
    want = {k for k in KEYS + DEVICE_KEYS
            if k.rsplit("_", 1)[0] not in ops.SCALAR_OPS
            and k not in ops.SCALAR_OPS}
    assert set(sharded["__sharded__"].tolist()) == want


@pytest.mark.parametrize("key", KEYS)
def test_sharded_op_equals_vmn_tpu(sharded, reference, key):
    want = parts(reference, key)
    got = parts(sharded, key)
    assert want and got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def port_draws():
    """The port's DeviceSource draws of the same ops, unsharded."""
    from vmn_tpu_torch.arith.pgroup import ModPGroup

    res = ops.device_ops(ModPGroup.named("test256", device="cpu"),
                         ops.port_pkg())
    return ops.flat(res, lambda t: t.cpu().numpy())


@pytest.mark.parametrize("key", DEVICE_KEYS)
def test_sharded_device_draw_equals_unsharded(sharded, port_draws, key):
    """Each rank's rows of a device draw, expanded alone, are those rows
    of the unsharded draw (uneven and empty blocks included); a scalar
    draw is whole and equal on every rank (`run_ranks`)."""
    assert sharded[key].shape == port_draws[key].shape
    assert np.array_equal(sharded[key], port_draws[key])


def test_blocks_split_as_array_split():
    """Blocks of the mesh: the first N mod s ranks hold one row more, an
    empty block where N < s, and every row has one owner."""
    from vmn_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(4, 0, None)
    assert mesh.counts(10) == [3, 3, 2, 2]
    assert mesh.counts(3) == [1, 1, 1, 0]
    assert [mesh.block(10, r) for r in range(4)] == [
        (0, 3), (3, 6), (6, 8), (8, 10)]
    assert [mesh.owner(10, i) for i in range(10)] == [
        0, 0, 0, 1, 1, 1, 2, 2, 3, 3]


def test_unknown_op_on_sharded_limbs_raises():
    """An op the sharded type does not route raises and names itself;
    nothing gathers the array unasked."""
    import torch

    from vmn_tpu_torch.parallel.mesh import Mesh, ShardedLimbs

    t = ShardedLimbs(torch.zeros((2, 16), dtype=torch.int32), 5, 0,
                     Mesh(2, 0, torch.device("cpu")))
    assert tuple(t.shape) == (5, 16) and t.dim() == 2
    with pytest.raises(NotImplementedError, match="cat"):
        torch.cat([t, t])
    with pytest.raises(AttributeError, match="reshape"):
        t.reshape(-1)
    with pytest.raises(NotImplementedError, match="indexing"):
        t[0]


@pytest.mark.cuda
def test_sharded_ops_on_the_card_equal_plain(cuda_device, tmp_path):
    """Two ranks on the card (H1-H5, H8 and the ChaCha20 kernel on each
    block) against the port's plain versions, unsharded, on the CPU."""
    from vmn_tpu_torch.arith.ec import ECqPGroup
    from vmn_tpu_torch.arith.pgroup import ModPGroup
    from vmn_tpu_torch.ops import mont_kernels as K

    K.build_kernels()  # once, before the ranks load it
    got = run_ranks(tmp_path, 2, "cuda")
    res = ops.modp_ops(ModPGroup.named("test256", device="cpu"),
                       lambda a: a, ops.port_pkg())
    res.update(ops.device_ops(ModPGroup.named("test256", device="cpu"),
                              ops.port_pkg()))
    res.update(ops.ec_ops(ECqPGroup.named("P-256", device="cpu"),
                          lambda a: a))
    want = ops.flat(res, lambda t: t.cpu().numpy())
    assert got.keys() - {"__sharded__"} == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k

"""The sharded group ops of tests/test_torch_sharding.py: their seeded
inputs, the ops themselves (written once, run by both packages), and a
rank's main.

    VMN_DIST_COORD=localhost:PORT VMN_DIST_NPROC=4 VMN_DIST_PROCID=i \\
      python tests/torch_shard_ops.py OUT [--device cpu|cuda]

Each rank joins the process group, shards the inputs over the ranks
(`vmn_tpu_torch.parallel.mesh`), runs every op (the port's DeviceSource
draws among them), and writes the results
as whole arrays (gathered) to OUT/rank{i}.npz.  Inputs are made from a
seed with numpy; this module imports the port only, so that a rank never
loads JAX.
"""

import sys
from pathlib import Path

import numpy as np

SIZES = (16, 10)  # test256: one even split over 4 ranks, one uneven
EC_N = 3          # P-256 over 4 ranks: blocks of 1, 1, 1 and 0 points
MODP_OPS = ("random", "random_array", "random_bits_prg", "random_exp",
            "mul", "mul_mixed", "exp", "exp_scalar", "exp_fixed", "inv",
            "prod", "exp_prod", "exp_prod_128", "prods", "rec_lin",
            "rec_lin_last", "sum", "inner_product", "permute",
            "permute_ring", "shift_push", "get_first", "get_last")
EC_OPS = ("ec_exp", "ec_mul", "ec_prod", "ec_exp_prod")
# The port's device draws (DeviceSource: ChaCha20, whose bits differ from
# vmn_tpu's Threefry by design), held to the port's unsharded draws: N =
# 16, 10 and 3 rows over 4 ranks (blocks of 4; 3, 3, 2, 2; 1, 1, 1, 0).
DEVICE_SIZES = (16, 10, 3)
DEVICE_OPS = ("device_random", "device_bits", "device_scalar")
# The ops whose result is one element (replicated on every rank); every
# other result has N rows and stays sharded.
SCALAR_OPS = ("random_exp", "prod", "exp_prod", "exp_prod_128",
              "rec_lin_last", "sum", "inner_product", "get_first",
              "get_last", "ec_prod", "ec_exp_prod", "device_scalar")
TEST256_P = int(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff72ef", 16
)


def rand_ints(rng, n: int, bound: int) -> list:
    nbytes = (bound.bit_length() + 7) // 8 + 8
    return [int.from_bytes(rng.bytes(nbytes), "big") % bound
            for _ in range(n)]


def modp_inputs(n: int) -> dict:
    """Seeded inputs of the test256 ops at N = n."""
    p = TEST256_P
    q = (p - 1) // 2
    rng = np.random.default_rng(1000 + n)
    return {"a": [x + 1 for x in rand_ints(rng, n, p - 1)],
            "b": [x + 1 for x in rand_ints(rng, n, p - 1)],
            "e": rand_ints(rng, n, q), "f": rand_ints(rng, n, q),
            "s": rand_ints(rng, 1, q)[0], "perm": rng.permutation(n)}


def ec_inputs(n: int = EC_N) -> dict:
    """Seeded P-256 inputs: scalars for the points k·G and the exponents
    (one point the negation of another, so that a sum passes P + (-P))."""
    rng = np.random.default_rng(2000 + n)
    order = int("ffffffff00000000ffffffffffffffffbce6faada7179e84f3b9cac2"
                "fc632551", 16)
    ks = [k + 1 for k in rand_ints(rng, n, order - 1)]
    ks[-1] = order - ks[0]
    return {"k": ks, "m": [k + 1 for k in rand_ints(rng, n, order - 1)],
            "e": rand_ints(rng, n, order)}


def modp_ops(group, sh, pkg) -> dict:
    """name -> result of each test256 op, written against the GArray /
    FArray surface that both packages share; `sh` shards an array (the
    identity for the unsharded run); `pkg` holds the package's
    Permutation, SeededSource, `prg(seed)` and `scope(n)` (the port's
    `mesh.rows_scope` of n rows, where draws keep this rank's rows)."""
    out = {}
    for n in SIZES:
        x = modp_inputs(n)
        ring = group.ring
        A, B = group.from_ints(x["a"]), group.from_ints(x["b"])
        E, F = ring.from_ints(x["e"]), ring.from_ints(x["f"])
        As, Bs, Es, Fs = sh(A), sh(B), sh(E), sh(F)
        s = ring.from_int(x["s"])
        pi = pkg.Permutation(np.asarray(x["perm"], np.int64))
        with pkg.scope(n):
            R = ring.random((n,), pkg.SeededSource(b"shard-draw"), 50)
            G = group.random_array(n, pkg.prg(b"shard-gens"), 50)
            V = ring.random_bits_prg(n, 100, pkg.prg(b"shard-batch"))
        res = {
            "random": R, "random_array": G, "random_bits_prg": V,
            "random_exp": G.exp_prod(R.mul(V)),
            "mul": As.mul(Bs),
            "mul_mixed": As.mul(B),
            "exp": As.exp(Es),
            "exp_scalar": As.exp(s),
            "exp_fixed": group.g.exp(Es),
            "inv": As.inv(),
            "prod": As.prod(),
            "exp_prod": As.exp_prod(Es),
            "exp_prod_128": As.exp_prod(Es, 128),
            "prods": Es.prods(),
            "rec_lin": Fs.rec_lin(Es)[0],
            "rec_lin_last": Fs.rec_lin(Es)[1],
            "sum": Es.sum(),
            "inner_product": Es.inner_product(Fs),
            "permute": As.permute(pi),
            "permute_ring": Es.permute(pi),
            "shift_push": Es.shift_push(s),
            "get_first": As.get(0),
            "get_last": As.get(n - 1),
        }
        assert tuple(res) == MODP_OPS
        for name, v in res.items():
            out[f"{name}_{n}"] = v
    return out


def device_ops(group, pkg) -> dict:
    """name -> each DeviceSource draw of the port at the DEVICE_SIZES:
    the re-encryption exponents' draw (`random`, 306 bits: 20 limbs), a
    batch draw of 100 bits (7 limbs, an odd count) and a scalar, which
    stays whole on every rank; inside `pkg.scope(n)` each rank expands
    its own rows alone."""
    from vmn_tpu_torch.crypto.randomsource import DeviceSource

    out = {}
    ring = group.ring
    for n in DEVICE_SIZES:
        src = DeviceSource(b"shard-device-%d" % n)
        with pkg.scope(n):
            res = {"device_random": ring.random((n,), src, 50),
                   "device_bits": ring.random_bits(n, 100, src),
                   "device_scalar": ring.random((), src, 50)}
        assert tuple(res) == DEVICE_OPS
        for name, v in res.items():
            out[f"{name}_{n}"] = v
    return out


def ec_ops(grp, sh) -> dict:
    """name -> result of each P-256 op: scalar multiples (H5), point
    additions (H8) and the sum (a tree on each block, one of the
    partials), the points k·G made from scalars by the group itself."""
    x = ec_inputs()
    ring = grp.ring
    P = sh(grp.g.exp(ring.from_ints(x["k"])))
    Q = sh(grp.g.exp(ring.from_ints(x["m"])))
    E = sh(ring.from_ints(x["e"]))
    return {"ec_exp": P.exp(E), "ec_mul": P.mul(Q), "ec_prod": P.prod(),
            "ec_exp_prod": P.exp_prod(E)}


def flat(results: dict, to_np) -> dict:
    """name:part -> host array of each result: limbs as uint32, points
    as their x, y (Montgomery limbs) and inf; `to_np` reads a tensor."""
    out = {}
    for k, arr in results.items():
        if hasattr(arr, "inf"):
            out[f"{k}:x"] = np.asarray(to_np(arr.x)).astype(np.uint32)
            out[f"{k}:y"] = np.asarray(to_np(arr.y)).astype(np.uint32)
            out[f"{k}:inf"] = np.asarray(to_np(arr.inf)).astype(bool)
        else:
            out[k] = np.asarray(to_np(arr.limbs)).astype(np.uint32)
    return out


def port_pkg(mesh=None):
    """The port's classes for `modp_ops` (draws sharded over `mesh`)."""
    import contextlib
    from types import SimpleNamespace

    from vmn_tpu_torch.arith.pgroup import Permutation
    from vmn_tpu_torch.crypto.hash import SHA256
    from vmn_tpu_torch.crypto.prg import PRGHeuristic
    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.parallel.mesh import rows_scope

    def prg(seed):
        g = PRGHeuristic(SHA256)
        g.set_seed(SHA256.hash(seed))
        return g

    return SimpleNamespace(
        Permutation=Permutation, SeededSource=SeededSource, prg=prg,
        scope=((lambda n: rows_scope(mesh, n)) if mesh is not None
               else (lambda n: contextlib.nullcontext())))


def main(argv) -> int:
    out = Path(argv[0])
    device = argv[argv.index("--device") + 1] if "--device" in argv \
        else "cuda"
    from vmn_tpu_torch.arith.ec import ECqPGroup
    from vmn_tpu_torch.arith.pgroup import ModPGroup
    from vmn_tpu_torch.parallel import dist
    from vmn_tpu_torch.parallel.mesh import ciph_mesh, is_sharded, shard_array

    assert dist.init_from_env(device=device), "VMN_DIST_* triplet required"
    mesh = ciph_mesh()
    group = ModPGroup.named("test256", device=mesh.device)

    def sh(a):
        # host rows every rank holds (make_global) or a tensor's rows
        if hasattr(a, "field"):
            return type(a)(a.field, dist.make_global(a.limbs.cpu().numpy(),
                                                     mesh))
        return shard_array(a, mesh)

    res = modp_ops(group, sh, port_pkg(mesh))
    res.update(device_ops(group, port_pkg(mesh)))
    res.update(ec_ops(ECqPGroup.named("P-256", device=mesh.device),
                      lambda a: shard_array(a, mesh)))
    sharded = [k for k, a in res.items()
               if is_sharded(a.x if hasattr(a, "inf") else a.limbs)]
    np.savez(out / f"rank{mesh.rank}.npz", __sharded__=np.array(sharded),
             **flat(res, dist.gather_to_host))
    print(f"SHARD rank={mesh.rank} of {mesh.size} ops={len(res)}",
          flush=True)
    dist.shutdown()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    sys.exit(main(sys.argv[1:]))

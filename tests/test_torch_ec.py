"""The port's elliptic-curve layer against `vmn_tpu` on the CPU, at P-256.

* The plain versions of H5-H8 against the Pallas kernels K9-K12 they port,
  run in interpret mode as tests/test_kernels.py runs them: the exceptional
  cases of the addition (infinity, P == Q, P == -Q) and scalar 0 included.
  H5, H7 and H8: Jacobian limbs equal.  H6 with the position combine
  (`ec_multiexp`): its Jacobian partials depend on how the points are
  split into lanes, which differs from the TPU's tiles, so the affine
  result after `normalize` is compared, once against K10 and once
  against `exp_prod` on vmn_tpu's CPU route.  The combine's plain
  version also against Python EC arithmetic.
* `ECqPGroup` / `ECArray` against `vmn_tpu.arith.ec` (its XLA path on the
  CPU): affine Montgomery limbs, infinity masks and bytes equal.
* The device default of the entry points (the card, never a silent CPU).
* On a CUDA device only: H5-H8 and the combine against their plain
  versions, H5 and H8 at every TPI their wrappers can choose, at P-256
  and at P-384.

JAX is imported only by the fixtures of the JAX-comparing tests, so the
`cuda` tests also run where JAX is not installed:
    python -m pytest tests/test_torch_ec.py -m cuda --noconftest -o addopts=""

Inputs are Python ints from fixed scalars or a seeded numpy generator,
handed to both packages.  Tolerance: exact equality (integer arithmetic).
"""

import inspect
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401 (cuda_device: fixture)
    as_np, cuda_device, host_ec_add, host_ec_mul, limbs_np, vmn_tpu_exp_prod,
)
from vmn_tpu_torch import interop
from vmn_tpu_torch.arith import ec as TEC
from vmn_tpu_torch.arith.ec import ECqPGroup as TGroup
from vmn_tpu_torch.arith.mont import device_limbs
from vmn_tpu_torch.ops import ec_kernels as E

P256 = TEC._CURVES["P-256"]


@pytest.fixture(scope="module")
def tg():
    return TGroup.named("P-256", device="cpu")


@pytest.fixture(scope="module")
def jx():
    """The JAX side: jnp, vmn_tpu's EC group and kernel modules."""
    import jax.numpy as jnp
    from vmn_tpu.arith import ec as JEC
    from vmn_tpu.ops import ec_kernels as JK
    from vmn_tpu.ops import mont_kernels as JM

    return SimpleNamespace(jnp=jnp, JEC=JEC, JK=JK, JM=JM,
                           grp=JEC.ECqPGroup.named("P-256"))


@pytest.fixture
def interpret(jx, monkeypatch):
    """Pallas kernels through the basic interpreter (read at trace time)."""
    monkeypatch.setattr(jx.JM, "INTERPRET", True)


def _host(tg):
    return tg.p, tg.a, (tg.gx, tg.gy)


def _jacobian(tg, pts, lams):
    """Jacobian Montgomery limbs (X, Y, Z) of affine points scaled by
    lambda (X = x·λ², Y = y·λ³, Z = λ); None is (0, 0, 0)."""
    p = tg.p
    cols = [[], [], []]
    for pt, lam in zip(pts, lams):
        if pt is None:
            vals = (0, 0, 0)
        else:
            vals = (pt[0] * lam * lam % p, pt[1] * pow(lam, 3, p) % p, lam)
        for c, v in zip(cols, vals):
            c.append(v)
    X, Y, Z = (tg.ctx.encode(c) for c in cols)
    zero = torch.tensor([pt is None for pt in pts])
    return X, Y, torch.where(zero[:, None], torch.zeros_like(Z), Z)


def _affine(tg, jac):
    """Port Jacobian limbs -> list of affine points (None = infinity)."""
    return tg.to_affine(TEC.ECArray(tg, *tg.curve.normalize(*jac)))


def _jnp(jx, t):
    return jx.jnp.asarray(as_np(t))


def _assert_limbs_equal(got, want):
    for g, w in zip(got, want):
        assert np.array_equal(as_np(g), as_np(w))


# ------------------------------------------ plain versions vs Pallas K9-K12


def test_point_add_plain_matches_pallas(jx, tg, interpret):
    """H8's plain version against K12 `ec_point_add_pallas`, with every
    exceptional case, on Z = 1 and on scaled Jacobian inputs."""
    p, a, G = _host(tg)
    P2 = host_ec_add(p, a, G, G)
    P3 = host_ec_add(p, a, P2, G)
    negG = (G[0], p - G[1])
    cases = [(G, P2), (G, G), (G, negG), (None, P3), (P3, None),
             (None, None), (P2, P3), (P3, P3), (P2, P2), (P3, (P3[0],
                                                               p - P3[1]))]
    rng = np.random.default_rng(8)
    lam1 = [1] * 6 + [int(rng.integers(2, 1 << 62)) for _ in range(4)]
    lam2 = [1] * 6 + [int(rng.integers(2, 1 << 62)) for _ in range(4)]
    j1 = _jacobian(tg, [c[0] for c in cases], lam1)
    j2 = _jacobian(tg, [c[1] for c in cases], lam2)
    got = E.ec_point_add_plain(*j1, *j2, tg.ctx.mod)
    jc = jx.grp.ctx
    want = jx.JK.ec_point_add_pallas(*(_jnp(jx, t) for t in (*j1, *j2)),
                                     jc.m_limbs, jc.mprime)
    _assert_limbs_equal(got, want)
    assert _affine(tg, got) == [host_ec_add(p, a, u, v) for u, v in cases]


def test_scalar_mul_plain_matches_pallas(jx, tg, interpret):
    """H5's plain version against K9 `ec_scalar_mul_pallas` at 256 bits:
    scalars 0, 1, n-1 and others; one input point at infinity."""
    p, a, G = _host(tg)
    n = tg.n
    scalars = [0, 1, 2, 3, n - 1, n - 2, 12345, (1 << 255) + 99, n // 3, 7]
    pts = [host_ec_mul(p, a, G, i + 2) for i in range(len(scalars))]
    pts[5] = None
    x = tg.ctx.encode([0 if q is None else q[0] for q in pts])
    y = tg.ctx.encode([0 if q is None else q[1] for q in pts])
    inf = torch.tensor([q is None for q in pts])
    e = device_limbs(limbs_np(scalars, 16), "cpu")
    got = E.ec_scalar_mul_plain(x, y, inf, e, tg.ctx.mod, 256)
    jc = jx.grp.ctx
    want = jx.JK.ec_scalar_mul_pallas(
        _jnp(jx, x), _jnp(jx, y), jx.jnp.asarray(inf.numpy()), _jnp(jx, e),
        jc.m_limbs, jc.mprime, jc.one_mont, 256)
    _assert_limbs_equal(got, want)
    assert _affine(tg, got) == [
        None if q is None else host_ec_mul(p, a, q, k % n)
        for q, k in zip(pts, scalars)]


@pytest.mark.parametrize("N,super_chunk,blocks,route", [
    # three launches, none a whole chunk
    pytest.param(70, 32, E.MEXP_BLOCKS, "pallas", id="70-32-132"),
    # one block walks three chunks, the last short
    pytest.param(120, 1 << 20, 1, "xla", id="120-1048576-1"),
])
def test_multiexp_plain_matches_pallas(jx, tg, interpret, monkeypatch, N,
                                       super_chunk, blocks, route):
    """H6's plain version and the position combine (`ec_multiexp`)
    against vmn_tpu, compared after `normalize`: the three-launch case
    against K10 `ec_multiexp_pallas` (in interpret mode: the one pin on
    the Pallas kernel's fold, the other curves' cases take the cheaper
    route), the one-block case against `exp_prod` on vmn_tpu's CPU route
    (its XLA scalar multiples and product tree).  The batch holds a point
    at infinity, a pair P, -P, a repeated point and scalar 0; N is no
    multiple of H6's chunk.  A small EP_SUPER splits it into three
    launches; MEXP_BLOCKS = 1 makes one block fold every chunk."""
    monkeypatch.setattr(jx.JK, "_EP_JB", 4)  # small interpret-mode graphs
    monkeypatch.setattr(jx.JK, "TILE_N", 128)
    monkeypatch.setattr(E, "EP_SUPER", super_chunk)
    monkeypatch.setattr(E, "MEXP_BLOCKS", blocks)
    p, a, G = _host(tg)
    nbits = 32
    pts = [host_ec_mul(p, a, G, i + 2) for i in range(N)]
    pts[1] = None
    pts[3] = (pts[2][0], p - pts[2][1])
    pts[4] = pts[2]
    rng = np.random.default_rng(17)
    ks = [int(k) for k in rng.integers(0, 1 << nbits, N, dtype=np.uint64)]
    ks[0], ks[-1] = 0, (1 << nbits) - 1
    x = tg.ctx.encode([0 if q is None else q[0] for q in pts])
    y = tg.ctx.encode([0 if q is None else q[1] for q in pts])
    inf = torch.tensor([q is None for q in pts])
    e = device_limbs(limbs_np(ks, 2), "cpu")
    got = tg.curve.normalize(*(t[None] for t in E.ec_multiexp(
        x, y, inf, e, tg.ctx.mod, nbits)))
    if route == "pallas":
        want = jx.grp.curve.normalize(*jx.JK.ec_multiexp_pallas(
            jx.grp.curve, _jnp(jx, x), _jnp(jx, y),
            jx.jnp.asarray(inf.numpy()), _jnp(jx, e), nbits))
        _assert_limbs_equal([t[0] for t in got], want)
    else:
        want = vmn_tpu_exp_prod(jx.grp, x, y, inf, e, nbits)
        _assert_limbs_equal([t.reshape(-1) for t in got], want)
    acc = None
    for q, k in zip(pts, ks):
        acc = host_ec_add(p, a, acc, None if q is None
                          else host_ec_mul(p, a, q, k))
    assert tg.to_affine(TEC.ECArray(tg, *got)) == [acc]


def _kernel_order(n, blocks, subs, C):
    """The points each H6 fold thread adds, in its order, as the kernel's
    loops visit them (csrc/ec_kernels.cuh, ec_mexp_kernel), chunks of C
    points."""
    order = {}
    for b in range(blocks):
        for s in range(subs):
            order[b * subs + s] = [k * C + c
                                   for k in range(b, -(-n // C), blocks)
                                   for c in range(s, min(C, n - k * C), subs)]
    return order


@pytest.mark.parametrize("n,npos,w", [
    *(pytest.param(n, npos, 8, id=f"{n}-{npos}") for n, npos in (
        (1, 64), (63, 64), (64, 16), (4096, 64), (5000, 48), (9000, 16),
        (1 << 17, 64), (20000, 320), (300, 1))),
    # P-384 (W = 12, chunks of 40 points, 192 folders)
    *(pytest.param(n, npos, 12, id=f"w12-{n}-{npos}") for n, npos in (
        (1, 96), (39, 96), (41, 32), (5000, 96), (1 << 17, 96),
        (20000, 192)))])
def test_mexp_order_is_the_kernels(n, npos, w):
    """H6's launch shape at width W and the plain version's fold order
    against the kernel's loops: every point once in each position, at
    most EP_MAX_LANES partials a position, no block without a chunk."""
    chunk, folders = E.MEXP_SHAPES[w]
    blocks, subs = E.mexp_shape(n, npos, w)
    assert 1 <= blocks <= min(E.MEXP_BLOCKS, -(-n // chunk))
    assert npos * subs <= folders and blocks * subs <= E.EP_MAX_LANES
    order = E._mexp_order(n, blocks, subs, chunk, "cpu")
    want = _kernel_order(n, blocks, subs, chunk)
    assert order.shape[0] == blocks * subs
    for q, pts in want.items():
        row = order[q].tolist()
        assert row[: len(pts)] == pts and set(row[len(pts):]) <= {-1}
    assert sorted(i for pts in want.values() for i in pts) == list(range(n))
    if n == 1 << 17:
        assert (blocks, subs) == {8: (132, 5), 12: (132, 2)}[w]


def test_mexp_shape_refuses_too_many_positions():
    """The one-thread form folds at most a position a fold thread; the
    cooperative form (P-521's inner width) takes the items in rounds."""
    for w, (_, folders) in E.MEXP_SHAPES.items():
        if w in E.MEXP_TPI:
            assert E.mexp_shape(1000, folders + 16, w) == (63, 1)
            continue
        with pytest.raises(ValueError, match="digit positions"):
            E.mexp_shape(1000, folders + 16, w)


def test_multiexp_combine_plain_matches_python(tg):
    """The combine's plain version, sum_j 2^(4j)·S_j over 8 scaled
    Jacobian positions, against Python EC arithmetic: the top position
    and another at infinity, one equal to the running sum where it is
    added (the addition's doubling branch) and one its negative (P + -P
    gives infinity, and the chain goes on from there).  On the CPU the
    wrapper is the plain version."""
    p, a, G = _host(tg)
    npos = 8
    rng = np.random.default_rng(31)
    pts = [host_ec_mul(p, a, G, int(rng.integers(2, 1 << 62)))
           for _ in range(npos)]
    pts[7] = pts[2] = None
    acc = None
    for j in range(npos - 1, -1, -1):
        for _ in range(4):
            acc = host_ec_add(p, a, acc, acc)
        if j == 4:
            pts[j] = acc
        elif j == 3:
            pts[j] = (acc[0], p - acc[1])
        acc = host_ec_add(p, a, acc, pts[j])
    assert pts[4] is not None and pts[3] is not None
    lams = [int(rng.integers(2, 1 << 62)) for _ in range(npos)]
    P = _jacobian(tg, pts, lams)
    got = E.ec_multiexp_combine_plain(*P, tg.ctx.mod)
    assert all(t.shape == (tg.L,) for t in got)
    assert _affine(tg, tuple(t[None] for t in got)) == [acc]
    _assert_limbs_equal(E.ec_multiexp_combine(*P, tg.ctx.mod), got)


@pytest.mark.parametrize("kernel", ["ec_scalar_mul", "ec_multiexp_combine",
                                    "ec_point_add"])
def test_ec_coop_rule_covers_every_batch(kernel):
    """The TPI rule of H5, H8 and of the combine: every N >= 1 has a TPI that
    divides W = 8, fewer lanes as N grows, each TPI reached at its first
    N; every launch covers its points' lanes in whole warps of at most
    one block's threads.  The combine is one point (N = 1)."""
    K = E.K
    rule = K.COOP_TPI[kernel, 8]
    assert rule[-1][0] == 1
    assert [lo for lo, _ in rule] == sorted({lo for lo, _ in rule},
                                            reverse=True)
    if kernel == "ec_multiexp_combine":
        assert len(rule) == 1
    last = None
    ns = sorted({1, 2, 31, 4095, 4096, 4097, 1 << 17, 5 * 10**6,
                 *(lo + d for lo, _ in rule for d in (-1, 0, 1) if lo + d)})
    for n in ns:
        tpi, threads, blocks = K.coop_launch(kernel, 8, n)
        assert 8 % tpi == 0 and threads % 32 == 0 and threads % tpi == 0
        assert 0 < threads <= K.COOP_BLOCK
        assert (blocks - 1) * threads < n * tpi <= blocks * threads
        assert last is None or tpi <= last
        last = tpi
    for lo, tpi in rule:
        assert K.threads_per_element(kernel, 8, lo) == tpi



@pytest.mark.parametrize("kernel", ["ec_point_add", "ec_scalar_mul",
                                    "ec_multiexp_positions",
                                    "ec_multiexp_combine"])
def test_ec_wrapper_refuses_a_wrong_width(kernel):
    """Off the CPU a wrapper hands its operands to a kernel that reads and
    writes mod.L limbs a row, so operands of another width (here all of
    them 8 limbs against P-256's 16) raise before anything is built or
    launched.  The meta device stands in for the card."""
    mod = E.K.Modulus.of(P256[0], 16, "meta")
    bad = torch.zeros((5, 8), dtype=torch.int32, device="meta")
    inf = torch.zeros(5, dtype=torch.bool, device="meta")
    call = {
        "ec_point_add": lambda: E.ec_point_add(*[bad] * 6, mod),
        "ec_scalar_mul": lambda: E.ec_scalar_mul(bad, bad, inf, bad, mod,
                                                 128),
        "ec_multiexp_positions": lambda: E.ec_multiexp_positions(
            bad, bad, inf, bad, mod, 128),
        "ec_multiexp_combine": lambda: E.ec_multiexp_combine(bad, bad, bad,
                                                             mod),
    }[kernel]
    with pytest.raises(ValueError, match=r"expected int32 \(N=5, 16\)"):
        call()


def test_ec_launch_sizes_count_by_batch():
    E.reset_launches()
    for name, n in [("ec_point_add", 1), ("ec_point_add", 64),
                    ("ec_point_add", 4096), ("ec_scalar_mul", 1 << 17),
                    ("ec_multiexp_combine", 1)]:
        E._launched(name, n)
    assert E.LAUNCH_SIZES == {
        "ec_point_add": {"1": 1, "2-127": 1, ">=128": 1},
        "ec_scalar_mul": {"1": 0, "2-127": 0, ">=128": 1}}
    assert E.LAUNCHES["ec_multiexp_combine"] == 1
    E.reset_launches()
    assert not any(E.LAUNCHES.values())
    assert not any(v for d in E.LAUNCH_SIZES.values() for v in d.values())


def test_fb_exp_plain_matches_pallas(jx, tg, interpret, monkeypatch):
    """The port's fixed-base table of g holds d·2^(4j)·g, and H7's plain
    version equals K11 `ec_fb_exp_pallas` on it (scalar 0 included).
    (vmn_tpu's own table builder is one XLA program whose CPU compile
    takes minutes; its rows are the same affine points.)"""
    monkeypatch.setattr(jx.JK, "TILE_N", 128)
    p, a, G = _host(tg)
    ndig = 16
    tbx, tby = TEC._ec_fb_table(tg.curve, *tg.g._jac(), ndig)
    for j in range(ndig):
        rows = tg.to_affine(TEC.ECArray(tg, tbx[j, 1:], tby[j, 1:],
                                        torch.zeros(15, dtype=torch.bool)))
        assert rows == [host_ec_mul(p, a, G, d << (4 * j))
                        for d in range(1, 16)]
    assert not tbx[:, 0].any() and not tby[:, 0].any()
    scalars = [0, 1, 2, (1 << 64) - 1, 12345, (1 << 63) + 99, 7]
    e = device_limbs(limbs_np(scalars, 4), "cpu")
    got = E.ec_fb_exp_plain(tbx, tby, e, tg.ctx.mod)
    jc = jx.grp.ctx
    want = jx.JK.ec_fb_exp_pallas(_jnp(jx, tbx), _jnp(jx, tby), _jnp(jx, e),
                                  jc.m_limbs, jc.mprime, jc.one_mont)
    _assert_limbs_equal(got, want)
    assert _affine(tg, got) == [host_ec_mul(p, a, G, k) for k in scalars]


# ------------------------------------ ECqPGroup / ECArray against vmn_tpu


@pytest.fixture(scope="module")
def arrays(jx, tg):
    """The same six points in both packages (g^k, k = 0 gives infinity),
    and a 32-bit exponent array; the port's points come through interop."""
    ks = [0, 1, 2, 3, tg.n - 1, 12345]
    jp = jx.grp.g.exp(jx.grp.ring.from_ints(ks))
    tp = tg.g.exp(tg.ring.from_ints(ks))
    es = [5, 0, (1 << 32) - 1, 77, 1 << 31, 3]
    return SimpleNamespace(
        ks=ks, jp=jp, tp=tp, es=es, je=jx.grp.ring.from_ints(es),
        te=tg.ring.from_ints(es),
        tp_interop=interop.ecarray_from_numpy(
            tg, np.asarray(jp.x), np.asarray(jp.y), np.asarray(jp.inf)))


def _same(tarr, jarr):
    assert np.array_equal(as_np(tarr.x), as_np(jarr.x))
    assert np.array_equal(as_np(tarr.y), as_np(jarr.y))
    assert np.array_equal(tarr.inf.numpy(), np.asarray(jarr.inf))


def test_ecarray_exp_matches(arrays):
    _same(arrays.tp, arrays.jp)
    assert arrays.tp.equals(arrays.tp_interop)
    assert bool(arrays.tp.inf[0]) and not bool(arrays.tp.inf[1:].any())


def test_ecarray_exp_bits_matches(arrays):
    _same(arrays.tp.exp_bits(arrays.te, 32),
          arrays.jp.exp_bits(arrays.je, 32))


def test_ecarray_mul_inv_matches(arrays):
    tp, jp = arrays.tp, arrays.jp
    _same(tp.mul(tp), jp.mul(jp))  # P + P and infinity + infinity
    _same(tp.inv(), jp.inv())
    _same(tp.mul(tp.inv()), jp.mul(jp.inv()))  # P + (-P)
    _same(tp.div(tp.shift_push(tp.get(0))), jp.div(jp.shift_push(jp.get(0))))


def test_ecarray_prod_matches(arrays):
    _same(arrays.tp.prod(), arrays.jp.prod())


@pytest.mark.parametrize("route", ["exp_bits+prod", "multiexp"])
def test_ecarray_exp_prod_matches(arrays, route, monkeypatch):
    """Both routes of `exp_prod`: below MULTIEXP_MIN (2^17, vmn_tpu's
    threshold) the scalar multiples and an addition tree, from it H6 + the
    H8 combine.  The threshold is lowered here so that the CPU run stays
    small; vmn_tpu's own route on the CPU is always the former."""
    if route == "multiexp":
        monkeypatch.setattr(TEC, "MULTIEXP_MIN", 2)
    _same(arrays.tp.exp_prod(arrays.te, 32), arrays.jp.exp_prod(arrays.je, 32))


def test_random_array_matches_and_keeps_stream_position(jx, tg):
    """Batched point derivation in a product group: the same points as
    vmn_tpu, and the PRG left where the sequential derivation leaves it."""
    from vmn_tpu.arith.pgroup import PPGroup as JPP
    from vmn_tpu.crypto.hash import SHA256 as JSHA
    from vmn_tpu.crypto.prg import PRGHeuristic as JPRG
    from vmn_tpu_torch.arith.pgroup import PPGroup as TPP
    from vmn_tpu_torch.crypto.hash import SHA256 as TSHA
    from vmn_tpu_torch.crypto.prg import PRGHeuristic as TPRG

    jprg, tprg = JPRG(JSHA), TPRG(TSHA)
    jprg.set_seed(JSHA.hash(b"pp-ec"))
    tprg.set_seed(TSHA.hash(b"pp-ec"))
    jarr = JPP(jx.grp, 2).random_array(6, jprg, 8)
    tarr = TPP(tg, 2).random_array(6, tprg, 8)
    for i in range(2):
        _same(tarr.project(i), jarr.project(i))
    assert tprg.read_bytes(64) == jprg.read_bytes(64)


def test_bytetree_round_trip_with_infinity(arrays, tg):
    from vmn_tpu_torch.eio.bytetree import lazy_from_bytes

    tp, jp = arrays.tp, arrays.jp
    raw = tp.to_bytetree().to_bytes()
    assert raw == jp.to_bytetree().to_bytes()
    back = tg.elem_from_bytetree(lazy_from_bytes(raw), tp.size)
    assert back.equals(tp) and bool(back.inf[0])
    one = tp.get(1)
    one_raw = one.to_bytetree().to_bytes()
    assert one_raw == jp.get(1).to_bytetree().to_bytes()
    assert tg.elem_from_bytetree(lazy_from_bytes(one_raw)).equals(one)
    bad = bytearray(raw)
    bad[-1] ^= 0x01  # the last point's y: off the curve
    with pytest.raises(Exception, match="not on curve"):
        tg.elem_from_bytetree(lazy_from_bytes(bytes(bad)), tp.size)


@pytest.mark.parametrize("name", ["P-224", "P-384", "P-521"])
def test_other_curves_on_the_cpu(jx, name):
    """The other NIST curves run through the plain versions on the CPU,
    P-521's odd L = 33 included (on the card P-384's kernels are held in
    tests/test_torch_p384.py, P-521's at the inner width W' = 20 in
    tests/test_torch_p521_kernels.py; P-224's inner width,
    test_p224_on_the_card_raises_by_width): addition, doubling and
    P + (-P) against Python ints; the message codec and the byte tree
    against vmn_tpu."""
    tg = TGroup.named(name, device="cpu")
    jg = jx.JEC.ECqPGroup.named(name)
    p, a, G = _host(tg)
    G2 = host_ec_add(p, a, G, G)
    got = tg.from_affine([G, G2, G2]).mul(
        tg.from_affine([G2, G2, (G2[0], p - G2[1])]))
    assert got.to_affine() == [host_ec_add(p, a, G, G2),
                               host_ec_add(p, a, G2, G2), None]
    pt = tg.encode_message(b"vmn")
    assert pt == jg.encode_message(b"vmn")
    assert tg.decode_message(pt) == b"vmn"
    assert (tg.from_affine([pt, G]).to_bytetree().to_bytes()
            == jg.from_affine([pt, G]).to_bytetree().to_bytes())


def test_p224_on_the_card_raises_by_width():
    """P-224 (L = 14 limbs, whose 7 words have no kernel) maps to the
    inner width W' = 8 of the P-256 instantiations, with the boundary
    conversion: c_in = R'^2/R, c_out = R mod p, the kernel's one R' mod p
    (R = 2^224, R' = 2^256).  Every Montgomery wrapper converts there
    (`CONVERTS`); on a tensor that is not on the CPU H7 alone, off every
    path, raises a ValueError naming that inner width, before any build
    or launch and with no plain fallback.  An 8192-bit ModP group (L =
    512) maps to W = 256, built on demand, an 8224-bit one (L = 514) to
    W' = 288, converting; one past the kernels' cap of 512 words (16416
    bits: L = 1026) gets no modulus off the CPU: `Modulus.of` raises
    naming the cap, before any build; a 1024-bit one
    (`vog -bitlen 1024`) maps to W = 32, built on demand.
    P-521 maps to its inner width W' = 20 and P-384 to W = 12.  (A
    tensor on the "meta" device stands in for the card's: the wrappers
    take the plain versions for CPU tensors alone.)"""
    from vmn_tpu_torch.arith.ec import _CURVES

    p = _CURVES["P-224"][0]
    R, Rp = 1 << 224, 1 << 256
    mod = E.K.Modulus.of(p, 14, "cpu")
    val = lambda t: sum(int(v) << (16 * i) for i, v in enumerate(t))  # noqa
    assert (mod.L, mod.W, mod.conv) == (14, 8, True)
    assert val(mod.c_in) == Rp * Rp * pow(R, -1, p) % p
    assert val(mod.c_out) == R % p and val(mod.kernel_one) == Rp % p
    assert mod.kernel_limbs.shape == (16,) and val(mod.kernel_limbs) == p
    assert set(E.K.KERNELS) <= E.K.CONVERTS
    assert set(E.EC_KERNELS) - E.K.CONVERTS == {"ec_fb_exp"}
    meta = torch.device("meta")
    mod = E.K.Modulus.of(p, 14, meta)
    x = torch.empty((4, 14), dtype=torch.int32, device=meta)
    tbl = torch.empty((56, 16, 14), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match=r"ec_fb_exp: no kernel for "
                       r"L=14 at its inner width W=8"):
        E.ec_fb_exp(tbl, tbl, x, mod)
    m8192 = (1 << 8191) + 1155  # odd, 8192 bits
    wide = E.K.Modulus.of(m8192, 512, meta)
    assert (wide.L, wide.W, wide.conv) == (512, 256, False)
    m8224 = (1 << 8223) + 1155  # odd, 8224 bits
    wide = E.K.Modulus.of(m8224, 514, meta)
    assert (wide.L, wide.W, wide.conv) == (514, 288, True)
    m16416 = (1 << 16415) + 1155  # odd, 16416 bits
    with pytest.raises(ValueError, match=r"no kernel for L=1026 limbs: 544 "
                       r"words pass the cap of 512 words \(16384 bits\)"):
        E.K.Modulus.of(m16416, 1026, meta)
    m1024 = (1 << 1023) + 1155
    wide = E.K.Modulus.of(m1024, 64, meta)
    assert (wide.L, wide.W, wide.conv) == (64, 32, False)
    assert E.K.Modulus.of(_CURVES["P-521"][0], 33, "cpu").W == 20
    assert E.K.Modulus.of(_CURVES["P-384"][0], 24, "cpu").W == 12


def test_encode_decode_message_matches(jx, tg):
    for msg in [b"", b"00000001", b"x" * (tg.p.bit_length() // 8 - 4)]:
        pt = tg.encode_message(msg)
        assert pt == jx.grp.encode_message(msg)
        assert tg.decode_message(pt) == msg
    assert tg.decode_message(None) == b""


# ------------------------------------------------- the device default


def test_entry_points_default_to_the_card():
    """Without `device`, the port's entry points build on the card; where
    there is none they raise instead of running on the CPU."""
    from vmn_tpu_torch.arith.mont import MontCtx
    from vmn_tpu_torch.arith.pgroup import ModPGroup, PField

    for fn in (MontCtx.__init__, PField.__init__, ModPGroup.__init__,
               ModPGroup.named, ModPGroup.from_bytetree, TGroup.__init__,
               TGroup.named, TGroup.from_bytetree):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    builds = [lambda: MontCtx(P256[0]).m_limbs,
              lambda: ModPGroup.named("test256").ctx.m_limbs,
              lambda: TGroup.named("P-256").ctx.m_limbs]
    for build in builds:
        if torch.cuda.is_available():
            assert build().device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                build()


# ----------------------------------------------- on the card (skipped here)

_N_CUDA = 300


def _cuda_case(kernel, device, curve="P-256"):
    """(kernel output, plain output) at `curve` on the card, with
    infinity, P == Q, P == -Q and scalars 0 and n - 1 among random
    inputs."""
    tg = TGroup.named(curve, device=device)
    mod, bits = tg.ctx.mod, tg.ring.nbits
    rng = np.random.default_rng(256)
    ks = [0, 1, tg.n - 1] + [
        int.from_bytes(rng.bytes(bits // 8 + 8), "big") % tg.n
        for _ in range(_N_CUDA)]
    pts = tg.g.exp(tg.ring.from_ints(ks))  # row 0: infinity
    e = tg.ring.from_ints(ks[::-1]).limbs
    if kernel == "ec_scalar_mul":
        args = (pts.x, pts.y, pts.inf, e, mod, bits)
        return E.ec_scalar_mul(*args), E.ec_scalar_mul_plain(*args)
    if kernel == "ec_multiexp_positions":
        args = (pts.x, pts.y, pts.inf, e, mod, bits)
        return (E.ec_multiexp_positions(*args),
                E.ec_multiexp_positions_plain(*args))
    if kernel == "ec_fb_exp":
        tbx, tby = TEC._ec_fb_table(tg.curve, *tg.g._jac(), bits // 4)
        return (E.ec_fb_exp(tbx, tby, e, mod),
                E.ec_fb_exp_plain(tbx, tby, e, mod))
    if kernel == "ec_multiexp_combine":
        # a scalar's positions with Z != 1 from H5, row 0 at infinity
        P = [t[:bits // 4] for t in E.ec_scalar_mul(pts.x, pts.y, pts.inf,
                                                    e, mod, bits)]
        return (E.ec_multiexp_combine(*P, mod),
                E.ec_multiexp_combine_plain(*P, mod))
    # rows 0-2 add a point to itself (row 0: infinity + infinity), row 3
    # adds its negative, the rest pair the batch with its reverse (the
    # last row: P + infinity)
    j1 = pts._jac()
    idx = torch.arange(len(ks) - 1, -1, -1, device=device)
    idx[:4] = torch.arange(4, device=device)
    j2 = [t[idx] for t in j1]
    j2[1][3] = tg.ctx.neg(j1[1][3])
    return (E.ec_point_add(*j1, *j2, mod),
            E.ec_point_add_plain(*j1, *j2, mod))


@pytest.mark.cuda
@pytest.mark.parametrize("curve", ["P-256", "P-384"])
@pytest.mark.parametrize("kernel", E.EC_KERNELS)
def test_cuda_ec_kernel_matches_plain(kernel, curve, cuda_device):
    got, want = _cuda_case(kernel, cuda_device, curve)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _first_n(kernel, tpi, w=8):
    return min(lo for lo, t in E.K.COOP_TPI[kernel, w] if t == tpi)


# (curve, TPI) of each H5 or H8 instantiation its rule can choose
def _curve_tpis(kernel):
    return [(c, t) for c, w in (("P-256", 8), ("P-384", 12))
            for t in sorted({t for _, t in E.K.COOP_TPI[kernel, w]})]


def _smul_batch(tg, n, device):
    """n points and scalars of tg's curve: infinity, scalars 0, 1 and
    n - 1 among random ones (points g^k from a few distinct k)."""
    rng = np.random.default_rng(n)
    nb = tg.ring.nbits // 8 + 8
    base = [0] + [int.from_bytes(rng.bytes(nb), "big") % tg.n
                  for _ in range(63)]
    pts = tg.g.exp(tg.ring.from_ints(base))  # row 0: infinity
    idx = torch.arange(n, device=device) % 64
    ks = [0, 1, tg.n - 1] + [int.from_bytes(rng.bytes(nb), "big") % tg.n
                             for _ in range(n - 3)]
    e = tg.ring.from_ints(ks[:n]).limbs
    return pts.x[idx], pts.y[idx], pts.inf[idx], e


@pytest.mark.cuda
@pytest.mark.parametrize("curve,tpi", _curve_tpis("ec_scalar_mul"))
def test_cuda_smul_every_tpi(curve, tpi, cuda_device):
    """H5 at each TPI its wrapper picks, reached through N: 37 points past
    the fewest for which it picks it, so that N is no multiple of a
    block's points."""
    tg = TGroup.named(curve, device=cuda_device)
    w = tg.L // 2
    n = _first_n("ec_scalar_mul", tpi, w) + 37
    assert E.K.threads_per_element("ec_scalar_mul", w, n) == tpi
    args = (*_smul_batch(tg, n, cuda_device), tg.ctx.mod, tg.ring.nbits)
    E.reset_launches()
    got = E.ec_scalar_mul(*args)
    assert E.LAUNCHES["ec_scalar_mul"] == 1
    want = E.ec_scalar_mul_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("npos", [16, 64])
def test_cuda_multiexp_combine_matches_plain(npos, cuda_device):
    """The combine in one launch, on positions with Z != 1 and some at
    infinity, and inside `ec_multiexp`: one combine launch and no
    single-point H8 launch."""
    tg = TGroup.named("P-256", device=cuda_device)
    mod = tg.ctx.mod
    x, y, inf, e = _smul_batch(tg, npos, cuda_device)
    P = E.ec_scalar_mul(x, y, inf, e, mod, 256)
    E.reset_launches()
    got = E.ec_multiexp_combine(*P, mod)
    assert E.LAUNCHES["ec_multiexp_combine"] == 1
    want = E.ec_multiexp_combine_plain(*P, mod)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    nbits = 4 * npos  # npos digit positions
    e = e[:, : nbits // 16].contiguous()
    E.reset_launches()
    got = E.ec_multiexp(x, y, inf, e, mod, nbits)
    assert E.LAUNCHES["ec_multiexp_combine"] == 1
    assert E.LAUNCH_SIZES["ec_point_add"]["1"] == 0
    want = E.ec_multiexp_combine_plain(
        *E.ec_multiexp_positions_plain(x, y, inf, e, mod, nbits), mod)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n,super_chunk,blocks", [
    (1000, 1 << 20, 132),  # 17 whole chunks and one of 48 points
    (1000, 640, 3),        # two launches; blocks walk several chunks
])
def test_cuda_multiexp_positions_edges(n, super_chunk, blocks, cuda_device,
                                       monkeypatch):
    """H6 against its plain version (the same Jacobian partials, so equal
    limbs) with a point at infinity, P and -P, a repeated point and scalar
    0, on a batch that is no multiple of the chunk; then split into two
    EP_SUPER launches with blocks that fold several chunks each."""
    monkeypatch.setattr(E, "EP_SUPER", super_chunk)
    monkeypatch.setattr(E, "MEXP_BLOCKS", blocks)
    tg = TGroup.named("P-256", device=cuda_device)
    mod = tg.ctx.mod
    x, y, inf, e = _smul_batch(tg, n, cuda_device)  # row 0: infinity
    x, y, inf = x.clone(), y.clone(), inf.clone()
    y[5] = tg.ctx.neg(y[4])  # -P beside P
    x[6], y[6] = x[4], y[4]  # a repeated point
    args = (x, y, inf, e, mod, 256)
    E.reset_launches()
    got = E.ec_multiexp_positions(*args)
    assert E.LAUNCHES["ec_multiexp_positions"] == -(-n // super_chunk)
    want = E.ec_multiexp_positions_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 128, 4096])
@pytest.mark.parametrize("curve,tpi", _curve_tpis("ec_point_add"))
def test_cuda_point_add_every_tpi(curve, tpi, n, cuda_device, monkeypatch):
    """H8 at each TPI its rule picks, forced through the rule: infinity
    on either side and on both, P + P (its doubling branch), P + (-P),
    the rest random pairs with Z != 1; against the plain version and
    Python EC arithmetic."""
    tg = TGroup.named(curve, device=cuda_device)
    monkeypatch.setitem(E.K.COOP_TPI, ("ec_point_add", tg.L // 2),
                        ((1, tpi),))
    mod = tg.ctx.mod
    p, a, _ = _host(tg)
    x, y, inf, e = _smul_batch(tg, max(n, 8), cuda_device)
    inf[1] = True  # row 1: infinity (row 0 already is)
    P = [t[:n] for t in E.ec_scalar_mul(x, y, inf, e, mod, tg.ring.nbits)]
    idx = torch.arange(n - 1, -1, -1, device=cuda_device)
    if n >= 8:
        idx[:6] = torch.tensor([0, 2, 1, 3, 4, 5], device=cuda_device)
    Q = [t[idx] for t in P]
    if n >= 8:
        Q[1][3] = tg.ctx.neg(P[1][3])  # P + (-P)
    # rows: 0 inf + inf, 1 inf + P, 2 P + inf, 3 P + (-P), 4-5 P + P
    E.reset_launches()
    got = E.ec_point_add(*P, *Q, mod)
    assert E.LAUNCHES["ec_point_add"] == 1
    want = E.ec_point_add_plain(*P, *Q, mod)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    aff_p, aff_q, aff_r = (_affine(tg, t) for t in (P, Q, got))
    rows = sorted({0, 1, 2, 3, 4, 5, n - 1} & set(range(n)))
    assert [aff_r[i] for i in rows] == [host_ec_add(p, a, aff_p[i], aff_q[i])
                                        for i in rows]

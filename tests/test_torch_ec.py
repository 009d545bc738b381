"""The port's elliptic-curve layer against `vmn_tpu` on the CPU, at P-256.

* The plain versions of H5-H8 against the Pallas kernels K9-K12 they port,
  run in interpret mode as tests/test_kernels.py runs them: the exceptional
  cases of the addition (infinity, P == Q, P == -Q) and scalar 0 included.
  H5, H7 and H8: Jacobian limbs equal.  H6: its Jacobian partials depend on
  how the points are split into lanes, which differs from the TPU's tiles,
  so the affine result after `normalize` is compared.
* `ECqPGroup` / `ECArray` against `vmn_tpu.arith.ec` (its XLA path on the
  CPU): affine Montgomery limbs, infinity masks and bytes equal.
* The device default of the entry points (the card, never a silent CPU).
* On a CUDA device only: H5-H8 against their plain versions.

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
    as_np, cuda_device, host_ec_add, host_ec_mul, limbs_np,
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


def test_multiexp_plain_matches_pallas(jx, tg, interpret, monkeypatch):
    """H6's plain version and the position combine (`ec_multiexp`)
    against K10 `ec_multiexp_pallas`, compared after `normalize`.  The
    batch holds a point at infinity, a pair P, -P, a repeated point and
    scalar 0; a small EP_SUPER splits it into three super-chunks."""
    monkeypatch.setattr(jx.JK, "_EP_JB", 4)  # small interpret-mode graphs
    monkeypatch.setattr(jx.JK, "TILE_N", 128)
    monkeypatch.setattr(E, "EP_SUPER", 32)
    p, a, G = _host(tg)
    N, nbits = 70, 32
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
    want = jx.grp.curve.normalize(*jx.JK.ec_multiexp_pallas(
        jx.grp.curve, _jnp(jx, x), _jnp(jx, y), jx.jnp.asarray(inf.numpy()),
        _jnp(jx, e), nbits))
    _assert_limbs_equal([t[0] for t in got], want)
    acc = None
    for q, k in zip(pts, ks):
        acc = host_ec_add(p, a, acc, None if q is None
                          else host_ec_mul(p, a, q, k))
    assert tg.to_affine(TEC.ECArray(tg, *got)) == [acc]


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
    P-521's odd L = 33 included (on the card their widths have no kernel
    yet): addition, doubling and P + (-P) against Python ints; the
    message codec and the byte tree against vmn_tpu."""
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


def _cuda_case(kernel, device):
    """(kernel output, plain output) at P-256 on the card, with infinity,
    P == Q, P == -Q and scalars 0 and n - 1 among random inputs."""
    tg = TGroup.named("P-256", device=device)
    mod = tg.ctx.mod
    rng = np.random.default_rng(256)
    ks = [0, 1, tg.n - 1] + [int.from_bytes(rng.bytes(40), "big") % tg.n
                             for _ in range(_N_CUDA)]
    pts = tg.g.exp(tg.ring.from_ints(ks))  # row 0: infinity
    e = tg.ring.from_ints(ks[::-1]).limbs
    if kernel == "ec_scalar_mul":
        args = (pts.x, pts.y, pts.inf, e, mod, 256)
        return E.ec_scalar_mul(*args), E.ec_scalar_mul_plain(*args)
    if kernel == "ec_multiexp_positions":
        args = (pts.x, pts.y, pts.inf, e, mod, 256)
        return (E.ec_multiexp_positions(*args),
                E.ec_multiexp_positions_plain(*args))
    if kernel == "ec_fb_exp":
        tbx, tby = TEC._ec_fb_table(tg.curve, *tg.g._jac(), 64)
        return (E.ec_fb_exp(tbx, tby, e, mod),
                E.ec_fb_exp_plain(tbx, tby, e, mod))
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
@pytest.mark.parametrize("kernel", E.EC_KERNELS)
def test_cuda_ec_kernel_matches_plain(kernel, cuda_device):
    got, want = _cuda_case(kernel, cuda_device)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)

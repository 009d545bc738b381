"""The port's kernels at the padded NIST curves against `vmn_tpu` and
Python ints on the CPU: P-521 (field and ring of L = 33 limbs, an odd
count, computed by the kernels at the inner width W' = 20 words) and
P-224 (L = 14 limbs, whose 7 words have no kernel, computed by the P-256
kernels at W' = 8).  Every test but H6's launch order runs at both
curves (the `curve` parameter).

* The kernel boundary (`Modulus`): a torch-op emulation of what a kernel
  does at a padded modulus -- pad the L limbs to 2·W', pack limb pairs
  into 32-bit words and back, take each Montgomery operand to the
  kernel's radix R' = 2^(32·W') with one product by c_in, run the plain
  version at R' (a modulus of 2·W' limbs), take each result back with
  one product by c_out -- gives the limbs of the plain version at L,
  R = 2^(16·L): H1, H2, H5, H6 with the combine, H8, on the field and
  the ring, on the edge values (0, 1, m - 1, R mod m) and seeded ones,
  and against Python ints.
* The plain version of each kernel on the path against `vmn_tpu` at L
  on small batches: H1 and H2 (K2, K3) on the field and on the scalar
  ring, H8 (K12) and H5 (K9) against the Pallas kernels they port in
  interpret mode, as tests/test_kernels.py runs them, and H6 with the
  position combine (K10) against `exp_prod` on vmn_tpu's CPU route
  (its XLA scalar multiples and product tree), after `normalize`.
* The carry-across of the curve's state from `vmn_tpu` (`interop`).
* On a CUDA device only (skipped here): every kernel of the path at
  W' against its plain version at every TPI of its rule.

Inputs are Python ints from fixed scalars or a seeded numpy generator,
handed to both packages.  Tolerance: exact equality of limbs (integer
arithmetic).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401 (cuda_device: fixture)
    as_np, cuda_device, edge_values, host_ec_add, host_ec_mul, limbs_np,
    rand_ints, vmn_tpu_exp_prod,
)
from vmn_tpu_torch import interop
from vmn_tpu_torch.arith import ec as TEC
from vmn_tpu_torch.arith.ec import ECqPGroup as TGroup
from vmn_tpu_torch.arith.mont import device_limbs
from vmn_tpu_torch.ops import ec_kernels as E
from vmn_tpu_torch.ops import mont_kernels as K

# Per padded curve: its limbs L, the kernels' words W', the scalars' bits
# and a scalar's digit positions (ndig_pad).
# H6's (blocks, subs) on 18 points at 32-bit scalars (16 positions):
# P-224's one-thread form folds them in one block, P-521's groups in two.
# k9: the reference H5's plain version meets, the Pallas kernel K9 in
# interpret mode or vmn_tpu's CPU route (its XLA ladder), whichever costs
# less at that curve (about 37 s against 15 at P-224 on one CPU).
CURVES = {"P-224": SimpleNamespace(L=14, W=8, bits=224, positions=64,
                                   mexp18=(1, 20), k9="xla"),
          "P-521": SimpleNamespace(L=33, W=20, bits=521, positions=144,
                                   mexp18=(2, 5), k9="pallas")}


@pytest.fixture(scope="module", params=sorted(CURVES))
def curve(request):
    return request.param


@pytest.fixture(scope="module")
def tg(curve):
    return TGroup.named(curve, device="cpu")


@pytest.fixture(scope="module")
def cv(curve):
    return CURVES[curve]


@pytest.fixture(scope="module")
def jx(curve):
    """The JAX side: jnp, vmn_tpu's group and kernel modules."""
    import jax.numpy as jnp
    from vmn_tpu.arith import ec as JEC
    from vmn_tpu.ops import ec_kernels as JK
    from vmn_tpu.ops import mont_kernels as JM

    return SimpleNamespace(jnp=jnp, JEC=JEC, JK=JK, JM=JM,
                           grp=JEC.ECqPGroup.named(curve))


@pytest.fixture
def interpret(jx, monkeypatch):
    """Pallas kernels through the basic interpreter (read at trace time)."""
    monkeypatch.setattr(jx.JM, "INTERPRET", True)


def _ctx(tg, modulus):
    return tg.ctx if modulus == "field" else tg.ring.ctx


def _jnp(jx, t):
    return jx.jnp.asarray(as_np(t))


def _assert_limbs_equal(got, want):
    for g, w in zip(got, want):
        assert np.array_equal(as_np(g), as_np(w))


def _affine(tg, jac):
    return tg.to_affine(TEC.ECArray(tg, *tg.curve.normalize(*jac)))


def _points(tg, pts):
    """Affine points (None: infinity) as port limbs and infinity mask."""
    x = tg.ctx.encode([0 if q is None else q[0] for q in pts])
    y = tg.ctx.encode([0 if q is None else q[1] for q in pts])
    return x, y, torch.tensor([q is None for q in pts], device=x.device)


def _jacobian(tg, pts, lams):
    """Jacobian Montgomery limbs of affine points scaled by lambda (X =
    x·λ², Y = y·λ³, Z = λ); None is (0, 0, 0)."""
    p = tg.p
    cols = [[], [], []]
    for pt, lam in zip(pts, lams):
        vals = (0, 0, 0) if pt is None else (
            pt[0] * lam * lam % p, pt[1] * pow(lam, 3, p) % p, lam)
        for c, v in zip(cols, vals):
            c.append(v)
    X, Y, Z = (tg.ctx.encode(c) for c in cols)
    zero = torch.tensor([pt is None for pt in pts], device=Z.device)
    return X, Y, torch.where(zero[:, None], torch.zeros_like(Z), Z)


def _batch(tg, n, seed):
    """n points g^(i+2) with a point at infinity, a pair P, -P and a
    repeated point, and scalars below the order with 0, 1 and n - 1."""
    p, a, G = tg.p, tg.a, (tg.gx, tg.gy)
    pts = [host_ec_mul(p, a, G, i + 2) for i in range(n)]
    pts[1] = None
    pts[3] = (pts[2][0], p - pts[2][1])
    pts[4] = pts[2]
    ks = rand_ints(np.random.default_rng(seed), n, tg.n)
    ks[0], ks[2], ks[5] = 0, 1, tg.n - 1
    x, y, inf = _points(tg, pts)
    return x, y, inf, tg.ring.from_ints(ks).limbs, pts, ks


# ------------------------------------------------- the kernel boundary


class Emulated:
    """What a kernel computes at a padded modulus, in torch ops: operands
    padded to 2W limbs and taken to R' = 2^(32·W) by c_in, the plain
    version at R' (the modulus of 2W limbs), results taken back by c_out
    and cut to L limbs."""

    def __init__(self, mod):
        assert mod.conv and mod.W == K.INNER_WORDS[mod.L]
        self.mod = mod
        self.inner = K.Modulus.of(mod.m, 2 * mod.W, "cpu")
        assert torch.equal(self.inner.limbs, mod.kernel_limbs)
        assert torch.equal(self.inner.one_mont, mod.kernel_one)
        assert self.inner.mprime32 == mod.mprime32

    def pad(self, x):
        return K._padded(x, self.mod)

    def into(self, x):
        x = self.pad(x)
        return K.mont_mul_plain(x, self.mod.c_in.expand_as(x), self.inner)

    def back(self, x):
        out = K.mont_mul_plain(x, self.mod.c_out.expand_as(x), self.inner)
        assert not out[:, self.mod.L:].any()  # below R: the top limbs are 0
        return K._unpadded(out, self.mod)

    def mont_mul(self, a, b):
        # the kernel's one extra product: a·b·R'^-1 times c_in
        ab = K.mont_mul_plain(self.pad(a), self.pad(b), self.inner)
        return K._unpadded(K.mont_mul_plain(
            ab, self.mod.c_in.expand_as(ab), self.inner), self.mod)

    def mont_exp(self, base, e, nbits):
        return self.back(K.mont_exp_plain(self.into(base), e, self.inner,
                                          nbits))

    def point_add(self, *coords):
        return tuple(self.back(t) for t in E.ec_point_add_plain(
            *map(self.into, coords), self.inner))

    def scalar_mul(self, x, y, inf, e, nbits):
        return tuple(self.back(t) for t in E.ec_scalar_mul_plain(
            self.into(x), self.into(y), inf, e, self.inner, nbits))

    def multiexp_positions(self, x, y, inf, e, nbits):
        return tuple(self.back(t) for t in E.ec_multiexp_positions_plain(
            self.into(x), self.into(y), inf, e, self.inner, nbits))

    def combine(self, *P):
        return tuple(self.back(t[None])[0]
                     for t in E.ec_multiexp_combine_plain(
                         *map(self.into, P), self.inner))


def _words(limbs):
    """(n, 2W) limbs -> (n, W) uint32 words as the kernels pack them
    (load_slice: word k = limb 2k | limb 2k+1 << 16)."""
    t = limbs.to(torch.int64)
    return t[:, 0::2] | (t[:, 1::2] << 16)


def _limbs(words):
    """The inverse of _words (store_slice)."""
    return torch.stack([words & 0xFFFF, words >> 16], dim=-1).reshape(
        words.shape[0], -1).to(torch.int32)


@pytest.mark.parametrize("modulus", ["field", "ring"])
def test_inner_width_constants(tg, cv, modulus):
    """The curve's moduli: L limbs and R = 2^(16·L) outside the kernels
    (P-521: 33, 2^528; P-224: 14, 2^224), W' words inside (20; 8, the
    P-256 instantiations); c_in = R'^2/R, c_out = R and the kernel's one
    R' mod m, as 2·W' limbs; m' mod 2^32 the same at both radixes."""
    c = _ctx(tg, modulus)
    mod = c.mod
    m, R, Rp = c.m, 1 << (16 * cv.L), 1 << (32 * cv.W)
    assert (mod.L, mod.W, mod.conv, c.R) == (cv.L, cv.W, True, R)
    val = lambda t: sum(int(v) << (16 * i) for i, v in enumerate(t))  # noqa
    assert mod.kernel_limbs.shape == (2 * cv.W,)
    assert val(mod.kernel_limbs) == m
    assert val(mod.c_in) == Rp * Rp * pow(R, -1, m) % m
    assert val(mod.c_out) == R % m == val(mod.one_mont)
    assert val(mod.kernel_one) == Rp % m
    assert mod.mprime32 == (-pow(m, -1, Rp)) % (1 << 32)


@pytest.mark.parametrize("modulus", ["field", "ring"])
def test_padding_and_packing_round_trip(tg, cv, modulus):
    """L limbs padded to 2·W' with zero high limbs, packed into W' words
    as the kernels load them and unpacked as they store them: the same
    limbs; the words above the modulus's are zero, and the packed value
    is the number."""
    c = _ctx(tg, modulus)
    vals = edge_values(c.m) + rand_ints(np.random.default_rng(33), 8, c.m)
    x = c.encode(vals)
    padded = K._padded(x, c.mod)
    assert padded.shape == (len(vals), 2 * cv.W)
    words = _words(padded)
    assert not words[:, -(-c.m.bit_length() // 32):].any()
    assert torch.equal(K._unpadded(_limbs(words), c.mod), x)
    assert [sum(int(w) << (32 * k) for k, w in enumerate(row))
            for row in words] == [v * c.R % c.m for v in vals]


@pytest.mark.parametrize("modulus", ["field", "ring"])
def test_padded_product_and_power_equal_the_plain_versions(tg, cv, modulus):
    """H1 and H2 as the kernels compute them at the padded width equal the
    plain versions at L and Python ints: the edge values 0, 1, m - 1 and
    R mod m, and seeded ones; exponents 0, all ones, m - 2."""
    c = _ctx(tg, modulus)
    m, bits = c.m, cv.bits
    em = Emulated(c.mod)
    rng = np.random.default_rng(521)
    xs = [0, 1, m - 1, c.R % m] + rand_ints(rng, 6, m)
    ys = xs[::-1]
    a, b = c.encode(xs), c.encode(ys)
    got = em.mont_mul(a, b)
    assert torch.equal(got, K.mont_mul_plain(a, b, c.mod))
    assert c.decode(got) == [x * y % m for x, y in zip(xs, ys)]
    es = [0, (1 << bits) - 1, m - 2] + rand_ints(rng, 7, 1 << bits)
    e = device_limbs(limbs_np(es, cv.L), "cpu")
    got = em.mont_exp(a, e, bits)
    assert torch.equal(got, K.mont_exp_plain(a, e, c.mod, bits))
    assert c.decode(got) == [pow(x, k, m) for x, k in zip(xs, es)]


def test_padded_point_kernels_equal_the_plain_versions(tg, cv):
    """H8, H5, H6 and the combine as the kernels compute them at the
    padded width equal the plain versions at L, limb for limb, with
    infinity, P + P and P + (-P) among the inputs."""
    mod = tg.ctx.mod
    em = Emulated(mod)
    x, y, inf, e, pts, ks = _batch(tg, 20, 20)
    j1 = _jacobian(tg, pts, [1 + i % 7 for i in range(20)])
    j2 = [t.flip(0).contiguous() for t in j1]
    for t, u in zip(j2, j1):
        t[6] = u[6]  # P + P
    j2[1][7] = tg.ctx.neg(j1[1][7])
    j2[0][7], j2[2][7] = j1[0][7], j1[2][7]  # P + (-P)
    _assert_limbs_equal(em.point_add(*j1, *j2),
                        E.ec_point_add_plain(*j1, *j2, mod))
    sl = slice(0, 6)
    got = em.scalar_mul(x[sl], y[sl], inf[sl], e[sl], cv.bits)
    _assert_limbs_equal(got, E.ec_scalar_mul_plain(
        x[sl], y[sl], inf[sl], e[sl], mod, cv.bits))
    p, a = tg.p, tg.a
    assert _affine(tg, got) == [None if q is None else host_ec_mul(p, a, q, k)
                                for q, k in zip(pts[sl], ks[sl])]
    P = em.multiexp_positions(x, y, inf, e, cv.bits)
    _assert_limbs_equal(P, E.ec_multiexp_positions_plain(x, y, inf, e, mod,
                                                         cv.bits))
    assert P[0].shape == (cv.positions, cv.L)
    _assert_limbs_equal(em.combine(*P), E.ec_multiexp_combine_plain(*P, mod))


# ----------------------------------- plain versions vs Pallas K2-K3, K9-K12


@pytest.mark.parametrize("modulus", ["field", "ring"])
def test_mont_plain_matches_pallas_at_l33(jx, tg, cv, modulus):
    """H1 and H2's plain versions against K2 `mont_mul_pallas` and K3
    `mont_exp_pallas` on the curve's field and on its scalar ring, both
    of L limbs (33 at P-521, 14 at P-224): the edge values, and exponents
    of the curve's bits with m - 2 (the batch-1 inversion), 0 and all
    ones among them; H2 also against Python pow."""
    from jax.experimental.pallas import tpu as pltpu
    from vmn_tpu.arith.mont import MontCtx as JCtx

    tc = _ctx(tg, modulus)
    jc = JCtx(tc.m)
    m = tc.m
    bits = cv.bits
    xs = edge_values(m) + [tc.R % m]
    ys = xs[::-1]
    es = [0, 1, 2, m - 2, (1 << bits) - 1, 65537, m // 3, 3, m - 1]
    a, b = (jc.to_mont(np.asarray(limbs_np(v, tc.L))) for v in (xs, ys))
    e = limbs_np(es, tc.L)
    ta, tb = (device_limbs(np.asarray(v), "cpu") for v in (a, b))
    te = device_limbs(e, "cpu")
    with pltpu.force_tpu_interpret_mode():
        want_mul = jx.JM.mont_mul_pallas(a, b, jc.m_limbs, jc.mprime)
        want_exp = jx.JM.mont_exp_pallas(a, jx.jnp.asarray(e), jc.m_limbs,
                                         jc.mprime, jc.one_mont, bits)
    assert np.array_equal(as_np(K.mont_mul_plain(ta, tb, tc.mod)),
                          as_np(want_mul))
    got = K.mont_exp_plain(ta, te, tc.mod, bits)
    assert np.array_equal(as_np(got), as_np(want_exp))
    assert tc.decode(got) == [pow(x, k, m) for x, k in zip(xs, es)]


def test_point_add_plain_matches_pallas(jx, tg, interpret):
    """H8's plain version against K12 `ec_point_add_pallas`, with every
    exceptional case, on Z = 1 and on scaled Jacobian inputs."""
    p, a, G = tg.p, tg.a, (tg.gx, tg.gy)
    P2 = host_ec_add(p, a, G, G)
    P3 = host_ec_add(p, a, P2, G)
    cases = [(G, P2), (G, G), (G, (G[0], p - G[1])), (None, P3), (P3, None),
             (None, None), (P2, P3), (P3, P3), (P3, (P3[0], p - P3[1]))]
    rng = np.random.default_rng(521)
    lam1 = [1] * 6 + [int(rng.integers(2, 1 << 62)) for _ in range(3)]
    lam2 = [1] * 6 + [int(rng.integers(2, 1 << 62)) for _ in range(3)]
    j1 = _jacobian(tg, [c[0] for c in cases], lam1)
    j2 = _jacobian(tg, [c[1] for c in cases], lam2)
    got = E.ec_point_add_plain(*j1, *j2, tg.ctx.mod)
    jc = jx.grp.ctx
    want = jx.JK.ec_point_add_pallas(*(_jnp(jx, t) for t in (*j1, *j2)),
                                     jc.m_limbs, jc.mprime)
    _assert_limbs_equal(got, want)
    assert _affine(tg, got) == [host_ec_add(p, a, u, v) for u, v in cases]


def test_scalar_mul_plain_matches_pallas(jx, tg, cv, interpret):
    """H5's plain version against vmn_tpu at the curve's scalar bits:
    against K9 `ec_scalar_mul_pallas` in interpret mode (Jacobian limbs;
    P-521), or against `ECArray.exp` on vmn_tpu's CPU route (its XLA
    ladder; P-224), after `normalize`; scalars 0, 1, n - 1 and others,
    one input point at infinity; and against Python EC arithmetic."""
    p, a, G = tg.p, tg.a, (tg.gx, tg.gy)
    n = tg.n
    scalars = [0, 1, n - 1, (1 << (cv.bits - 1)) + 99, n // 3]
    pts = [host_ec_mul(p, a, G, i + 2) for i in range(len(scalars))]
    pts[4] = None
    x, y, inf = _points(tg, pts)
    e = device_limbs(limbs_np(scalars, cv.L), "cpu")
    got = E.ec_scalar_mul_plain(x, y, inf, e, tg.ctx.mod, cv.bits)
    if cv.k9 == "pallas":
        jc = jx.grp.ctx
        want = jx.JK.ec_scalar_mul_pallas(
            _jnp(jx, x), _jnp(jx, y), jx.jnp.asarray(inf.numpy()),
            _jnp(jx, e), jc.m_limbs, jc.mprime, jc.one_mont, cv.bits)
        _assert_limbs_equal(got, want)
    else:
        jp = jx.JEC.ECArray(jx.grp, _jnp(jx, x), _jnp(jx, y),
                            jx.jnp.asarray(inf.numpy())).exp(
            jx.grp.ring.from_ints(scalars))
        _assert_limbs_equal(tg.curve.normalize(*got), (jp.x, jp.y, jp.inf))
    assert _affine(tg, got) == [
        None if q is None else host_ec_mul(p, a, q, k % n)
        for q, k in zip(pts, scalars)]


def test_multiexp_plain_matches_pallas(jx, tg, cv, monkeypatch):
    """H6's plain version in the kernel's order at W' (P-521: chunks of
    16 points, the cooperative form's items, subs = 5 folders a position,
    each launch's last chunk short; P-224: the one-thread form's chunk of
    56 and 20 folders a position) and the position combine
    (`ec_multiexp`) against `exp_prod` on vmn_tpu's CPU route (its XLA
    scalar multiples and product tree; K10's fold is pinned in interpret
    mode at P-256, tests/test_torch_ec.py), after `normalize`, on 28
    points split into two launches by a small EP_SUPER, at 32-bit
    scalars."""
    monkeypatch.setattr(E, "EP_SUPER", 18)
    p, a, G = tg.p, tg.a, (tg.gx, tg.gy)
    pts = [host_ec_mul(p, a, G, i + 2) for i in range(28)]
    pts[1] = None
    pts[3] = (pts[2][0], p - pts[2][1])
    ks = [int(k) for k in np.random.default_rng(28).integers(
        0, 1 << 32, 28, dtype=np.uint64)]
    ks[0], ks[-1] = 0, (1 << 32) - 1
    x, y, inf = _points(tg, pts)
    e = device_limbs(limbs_np(ks, 2), "cpu")
    assert E.mexp_shape(18, 16, cv.W) == cv.mexp18
    got = tg.curve.normalize(*(t[None] for t in E.ec_multiexp(
        x, y, inf, e, tg.ctx.mod, 32)))
    _assert_limbs_equal([t.reshape(-1) for t in got],
                        vmn_tpu_exp_prod(jx.grp, x, y, inf, e, 32))
    acc = None
    for q, k in zip(pts, ks):
        acc = host_ec_add(p, a, acc, None if q is None
                          else host_ec_mul(p, a, q, k))
    assert tg.to_affine(TEC.ECArray(tg, *got)) == [acc]


def test_mexp_order_walks_items_past_the_groups():
    """H6's cooperative launch at 521-bit scalars: 144 positions on 80
    fold groups, two rounds of items, each block several chunks at the
    path's 2^17 points; the plain version's order gives every point of a
    block's chunks to one partial a position, in chunk order."""
    assert E.MEXP_TPI[20] == 4 and E.MEXP_SHAPES[20] == (16, 80)
    assert E.mexp_shape(1 << 17, 144, 20) == (132, 1)
    assert E.mexp_shape(300, 144, 20) == (19, 1)
    order = E._mexp_order(300, 19, 1, 16, "cpu")
    assert order.shape == (19, 16)
    assert sorted(order[order >= 0].tolist()) == list(range(300))
    assert order[18].tolist() == list(range(288, 300)) + [-1] * 4
    with pytest.raises(ValueError, match="at most"):
        E.mexp_shape(1000, 400, 12)  # the one-thread form: an item a folder


# ---------------------------------------------------------------- interop


def test_interop_carries_p521_state(jx, tg):
    """vmn_tpu's points of the curve (Montgomery-form limbs at R =
    2^(16·L): 2^528 at P-521, 2^224 at P-224; infinity mask) and ring
    elements (standard form) become the port's, and back to the same
    numpy limbs."""
    ks = [0, 1, 2, tg.n - 1, 12345]
    jp = jx.grp.g.exp(jx.grp.ring.from_ints(ks))
    tp = interop.ecarray_from_numpy(tg, np.asarray(jp.x), np.asarray(jp.y),
                                    np.asarray(jp.inf))
    assert tp.equals(tg.g.exp(tg.ring.from_ints(ks)))
    assert tp.to_affine() == jx.grp.to_affine(jp)
    assert np.array_equal(interop.limbs_to_numpy(tp.x), np.asarray(jp.x))
    je = jx.grp.ring.from_ints(ks)
    te = interop.farray_from_numpy(tg.ring, np.asarray(je.limbs))
    assert te.to_ints() == ks
    assert np.array_equal(interop.limbs_to_numpy(te.limbs),
                          np.asarray(je.limbs))


# ----------------------------------------------- on the card (skipped here)


def _tpis(kernel, w):
    return sorted({t for _, t in K.COOP_TPI[kernel, w]})


def _first_n(kernel, tpi, w):
    return min(lo for lo, t in K.COOP_TPI[kernel, w] if t == tpi) + 37


@pytest.mark.cuda
@pytest.mark.parametrize("modulus", ["field", "ring"])
@pytest.mark.parametrize("curve,kernel,tpi", [
    (c, k, t) for c in sorted(CURVES) for k in ("mont_mul", "mont_exp")
    for t in _tpis(k, CURVES[c].W)])
def test_cuda_w20_mont_every_tpi(curve, kernel, tpi, modulus, cuda_device):
    """H1 and H2 at the curve's W' (20 at P-521, 8 at P-224) at each TPI
    of their rules, reached through N, on the field and the ring: against
    the plain version at L."""
    cv = CURVES[curve]
    tc = _ctx(TGroup.named(curve, device=cuda_device), modulus)
    n = _first_n(kernel, tpi, cv.W)
    assert K.threads_per_element(kernel, cv.W, n) == tpi
    vals = edge_values(tc.m) + rand_ints(np.random.default_rng(n), n, tc.m)
    a, b = tc.encode(vals[:n]), tc.encode(vals[::-1][:n])
    if kernel == "mont_mul":
        got, want = K.mont_mul(a, b, tc.mod), K.mont_mul_plain(a, b, tc.mod)
    else:
        e = device_limbs(limbs_np([v % (1 << cv.bits)
                                   for v in vals[1:n + 1]], cv.L),
                         cuda_device)
        got = K.mont_exp(a, e, tc.mod, cv.bits)
        want = K.mont_exp_plain(a, e, tc.mod, cv.bits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("curve,kernel,tpi", [
    (c, k, t) for c in sorted(CURVES)
    for k in ("ec_scalar_mul", "ec_point_add", "ec_multiexp_combine")
    for t in _tpis(k, CURVES[c].W)])
def test_cuda_w20_ec_every_tpi(curve, kernel, tpi, cuda_device):
    """H5, H8 and the combine at the curve's W' at each TPI of their rules
    (H5 and H8 reached through N), against their plain versions at L,
    with infinity and scalar 0 among the inputs."""
    cv = CURVES[curve]
    tg = TGroup.named(curve, device=cuda_device)
    mod = tg.ctx.mod
    n = (_first_n(kernel, tpi, cv.W) if kernel != "ec_multiexp_combine"
         else cv.positions)
    x, y, inf, e, _, _ = _batch(tg, 8, n)
    reps = -(-n // 8)
    x, y, e = (t.repeat(reps, 1)[:n].contiguous() for t in (x, y, e))
    inf = inf.repeat(reps)[:n].contiguous()
    jac = E.ec_scalar_mul_plain(x[:8], y[:8], inf[:8], e[:8], mod, cv.bits)
    if kernel == "ec_scalar_mul":
        got = E.ec_scalar_mul(x, y, inf, e, mod, cv.bits)
        want = E.ec_scalar_mul_plain(x, y, inf, e, mod, cv.bits)
    elif kernel == "ec_point_add":
        j1 = [t.repeat(reps, 1)[:n].contiguous() for t in jac]
        j2 = [t.flip(0).contiguous() for t in j1]
        got = E.ec_point_add(*j1, *j2, mod)
        want = E.ec_point_add_plain(*j1, *j2, mod)
    else:
        P = [t.repeat(reps, 1)[:n].contiguous() for t in jac]
        got = E.ec_multiexp_combine(*P, mod)
        want = E.ec_multiexp_combine_plain(*P, mod)
    torch.cuda.synchronize()
    _assert_limbs_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("curve,n,bits", [
    (c, n, b) for c in sorted(CURVES)
    for n, b in ((300, CURVES[c].bits), (5000, CURVES[c].bits), (300, 64))])
def test_cuda_w20_multiexp_positions(curve, n, bits, cuda_device):
    """H6 at the curve's W' against its plain version (P-521 the
    cooperative form, P-224 the one-thread form with the boundary
    conversion): one chunk a block (300 points), several (5000), and
    more folders a position (64-bit scalars)."""
    tg = TGroup.named(curve, device=cuda_device)
    x, y, inf, e, _, _ = _batch(tg, 8, n)
    reps = -(-n // 8)
    x, y, e = (t.repeat(reps, 1)[:n].contiguous() for t in (x, y, e))
    inf = inf.repeat(reps)[:n].contiguous()
    e = e[:, : -(-bits // 16)].contiguous()
    if bits < CURVES[curve].bits:
        e[:, -1] &= (1 << (bits % 16 or 16)) - 1
    ins = (x, y, inf, e, tg.ctx.mod, bits)
    got = E.ec_multiexp_positions(*ins)
    want = E.ec_multiexp_positions_plain(*ins)
    torch.cuda.synchronize()
    _assert_limbs_equal(got, want)

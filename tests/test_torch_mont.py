"""The port's `MontCtx` against `vmn_tpu.arith.mont.MontCtx` (its XLA path
on the CPU) and Python `int`, at test256 and modp2048 widths; the plain
product also at modp3072 and modp4096.

Inputs are seeded numpy bytes handed to both packages.  At 2048 bits
the exponents are short (<= 64 bits) except for `inv`, to keep the run
fast.  Tolerance: exact equality of limbs (integer arithmetic).
"""

import numpy as np
import pytest

from torch_port_util import as_np, edge_values, limbs_np, modulus, rand_ints

import jax.numpy as jnp
from vmn_tpu.arith.mont import MontCtx as JCtx
from vmn_tpu_torch.arith.mont import MontCtx as TCtx, device_limbs
from vmn_tpu_torch.ops import mont_kernels as K

WIDTHS = ["test256", "modp2048"]


@pytest.fixture(scope="module", params=WIDTHS)
def ctxs(request):
    m = modulus(request.param)
    return JCtx(m), TCtx(m, device="cpu")


def _inputs(jc, tc, seed, n=12):
    """Edge values plus seeded randoms, as (ints, jax Montgomery limbs,
    port Montgomery limbs)."""
    m = tc.m
    xs = (edge_values(m) + rand_ints(np.random.default_rng(seed), n, m))[:n]
    arr = limbs_np(xs, tc.L)
    return xs, jc.to_mont(jnp.asarray(arr)), tc.to_mont(device_limbs(arr, "cpu"))


def _exps(tc, seed, n, nbits):
    rng = np.random.default_rng(seed)
    es = [0, (1 << nbits) - 1] + [
        int.from_bytes(rng.bytes(8 + nbits // 8), "big") % (1 << nbits)
        for _ in range(n - 2)
    ]
    arr = limbs_np(es, max(1, -(-nbits // 16)))
    return es, jnp.asarray(arr), device_limbs(arr, "cpu")


def _ebits(tc):
    return 64 if tc.nbits > 512 else tc.nbits


def test_mul_and_conversions(ctxs):
    jc, tc = ctxs
    xs, ja, ta = _inputs(jc, tc, 1)
    ys, jb, tb = _inputs(jc, tc, 2)
    assert np.array_equal(as_np(ta), as_np(ja))  # to_mont
    out_t = tc.mul(ta, tb)
    assert np.array_equal(as_np(out_t), as_np(jc.mul(ja, jb)))
    assert tc.decode(out_t) == [x * y % tc.m for x, y in zip(xs, ys)]
    assert np.array_equal(as_np(tc.from_mont(ta)), limbs_np(xs, tc.L))
    # scalar operand broadcasts
    out_s = tc.mul(ta, tb[3])
    assert np.array_equal(as_np(out_s), as_np(jc.mul(ja, jb[3])))


@pytest.mark.parametrize("name", ["modp3072", "modp4096"])
def test_mul_plain_at_the_wide_named_groups(name):
    """H1's plain version at L = 192 and L = 256 against Python ints.  At
    L = 256 the lazy limbs of q could pass 2^63, so T's low half is
    resolved first; edge values m - 1, m - 2 give T its largest limbs."""
    from vmn_tpu_torch.arith.pgroup import _NAMED_GROUPS

    m = _NAMED_GROUPS[name][0]
    tc = TCtx(m, device="cpu")
    xs = (edge_values(m) + rand_ints(np.random.default_rng(5), 4, m))
    ys = xs[::-1]
    a = device_limbs(limbs_np(xs, tc.L), "cpu")
    b = device_limbs(limbs_np(ys, tc.L), "cpu")
    r_inv = pow(1 << (16 * tc.L), -1, m)
    got = K.mont_mul_plain(a, b, tc.mod)
    assert np.array_equal(as_np(got),
                          limbs_np([x * y * r_inv % m for x, y in zip(xs, ys)],
                                   tc.L))


def test_add_sub_neg(ctxs):
    jc, tc = ctxs
    m = tc.m
    xs = edge_values(m) + edge_values(m)[::-1]
    ys = edge_values(m)[::-1] + edge_values(m)
    a, b = limbs_np(xs, tc.L), limbs_np(ys, tc.L)
    ta, tb = device_limbs(a, "cpu"), device_limbs(b, "cpu")
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for top, jop, f in ((tc.add, jc.add, lambda x, y: x + y),
                        (tc.sub, jc.sub, lambda x, y: x - y)):
        got = top(ta, tb)
        assert np.array_equal(as_np(got), as_np(jop(ja, jb)))
        assert tc.decode_std(got) == [f(x, y) % m for x, y in zip(xs, ys)]
    assert np.array_equal(as_np(tc.neg(ta)), as_np(jc.neg(ja)))


def test_exp(ctxs):
    jc, tc = ctxs
    nbits = _ebits(tc)
    xs, ja, ta = _inputs(jc, tc, 3)
    es, je, te = _exps(tc, 4, len(xs), nbits)
    got = tc.exp(ta, te, nbits)
    assert np.array_equal(as_np(got), as_np(jc.exp(ja, je, nbits)))
    assert tc.decode(got) == [pow(x, e, tc.m) for x, e in zip(xs, es)]


@pytest.mark.parametrize("window", [4, 8])
def test_exp_fixed(ctxs, window):
    jc, tc = ctxs
    nbits = _ebits(tc)
    base = 4
    es, je, te = _exps(tc, 5, 9, nbits)
    table = tc.fixed_base_table(base, nbits, window)
    got = K.mont_fb_exp(table, te, tc.mod)
    want = jc.fixed_base_exp(base, je, nbits, window)
    assert np.array_equal(as_np(got), as_np(want))
    assert tc.decode(got) == [pow(base, e, tc.m) for e in es]
    # the routed entry point (window by exponent bits) agrees
    assert np.array_equal(as_np(tc.exp_fixed(base, te, nbits)), as_np(got))


def test_expprod_and_prod(ctxs):
    jc, tc = ctxs
    nbits = _ebits(tc)
    xs, ja, ta = _inputs(jc, tc, 6, n=20)
    xs, ja, ta = xs[1:], ja[1:], ta[1:]  # drop the zero base
    es, je, te = _exps(tc, 7, len(xs), nbits)
    got = tc.expprod(ta, te, nbits)
    assert np.array_equal(as_np(got), as_np(jc.expprod(ja, je, nbits)))
    want = 1
    for x, e in zip(xs, es):
        want = want * pow(x, e, tc.m) % tc.m
    assert tc.decode(got[None]) == [want]
    assert np.array_equal(as_np(tc.prod(ta)), as_np(jc.prod(ja)))


def test_scans_and_sum(ctxs):
    jc, tc = ctxs
    xs, ja, ta = _inputs(jc, tc, 8, n=11)
    ys, jb, tb = _inputs(jc, tc, 9, n=11)
    assert np.array_equal(as_np(tc.prods_scan(ta)), as_np(jc.prods_scan(ja)))
    std = tc.from_mont(tb)
    got = tc.rec_lin(ta, std)
    assert np.array_equal(as_np(got), as_np(jc.rec_lin(ja, jc.from_mont(jb))))
    acc, want = 0, []
    for x, y in zip(xs, ys):
        acc = (acc * x + y) % tc.m
        want.append(acc)
    assert tc.decode_std(got) == want
    assert np.array_equal(as_np(tc.sum(std)), as_np(jc.sum(jc.from_mont(jb))))


def test_reduce_std_and_inv(ctxs):
    jc, tc = ctxs
    rng = np.random.default_rng(10)
    wide_ints = [int.from_bytes(rng.bytes(2 * tc.L * 2 + 3), "big")
                 for _ in range(5)]
    wide = limbs_np(wide_ints, 2 * tc.L + 2)
    got = tc.reduce_std(device_limbs(wide, "cpu"))
    assert np.array_equal(as_np(got), as_np(jc.reduce_std(jnp.asarray(wide))))
    assert tc.decode_std(got) == [x % tc.m for x in wide_ints]
    xs, ja, ta = _inputs(jc, tc, 11, n=3)
    xs, ja, ta = xs[1:], ja[1:], ta[1:]  # 1 and 2: nonzero
    got = tc.inv(ta)
    assert np.array_equal(as_np(got), as_np(jc.inv(ja)))
    assert tc.decode(got) == [pow(x, -1, tc.m) for x in xs]

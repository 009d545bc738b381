"""Each kernel's plain PyTorch version against the JAX Pallas kernel it
ports (run in interpret mode, as tests/test_kernels.py runs them), the
interop conversions, and — on a CUDA device only — each Hopper kernel
against its plain version at modp2048 width.

JAX is imported only by the fixtures of the JAX-comparing tests, so the
`cuda` tests also run where JAX is not installed:
    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -o addopts=""

Inputs are seeded numpy arrays handed to both sides.  Tolerance: exact
equality of limbs (integer arithmetic).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401 (cuda_device: fixture)
    TEST256_P, as_np, cuda_device, edge_values, limbs_np, modp2048_p,
    rand_ints,
)
from vmn_tpu_torch import interop
from vmn_tpu_torch.arith.mont import MontCtx as TCtx, device_limbs
from vmn_tpu_torch.ops import mont_kernels as K


@pytest.fixture(scope="module")
def jx():
    """The JAX side: jnp, the Pallas interpret switch, vmn_tpu's kernels."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from vmn_tpu.ops import mont_kernels as JK

    return SimpleNamespace(jnp=jnp, interpret=pltpu.force_tpu_interpret_mode,
                           JK=JK)


@pytest.fixture(scope="module")
def ctxs(jx):
    from vmn_tpu.arith.mont import MontCtx as JCtx

    return JCtx(TEST256_P), TCtx(TEST256_P, device="cpu")


def _mont(jc, tc, xs):
    arr = jc.to_mont(np.asarray(limbs_np(xs, tc.L)))
    return arr, device_limbs(np.asarray(arr), "cpu")


def _exps(jx, es, L):
    arr = limbs_np(es, L)
    return jx.jnp.asarray(arr), device_limbs(arr, "cpu")


def test_mont_mul_plain_matches_pallas(jx, ctxs):
    jc, tc = ctxs
    vals = edge_values(tc.m)
    ja, ta = _mont(jc, tc, vals + vals[::-1])
    jb, tb = _mont(jc, tc, vals[::-1] + vals)
    with jx.interpret():
        want = jx.JK.mont_mul_pallas(ja, jb, jc.m_limbs, jc.mprime)
    assert np.array_equal(as_np(K.mont_mul_plain(ta, tb, tc.mod)),
                          as_np(want))


def test_mont_exp_plain_matches_pallas(jx, ctxs):
    jc, tc = ctxs
    m = tc.m
    ja, ta = _mont(jc, tc, [2, 1, m - 1, 3, 12345, m - 2, 7, 1 << 60])
    je, te = _exps(jx, [0, 1, 2, m - 2, (1 << 255) - 1, 65537, 50, 3], tc.L)
    with jx.interpret():
        want = jx.JK.mont_exp_pallas(ja, je, jc.m_limbs, jc.mprime,
                                     jc.one_mont, 256)
    assert np.array_equal(as_np(K.mont_exp_plain(ta, te, tc.mod, 256)),
                          as_np(want))


@pytest.mark.parametrize("window", [4, 8])
def test_mont_fb_exp_plain_matches_pallas(jx, ctxs, window):
    jc, tc = ctxs
    m = tc.m
    je, te = _exps(jx, [0, 1, 2, m - 2, (1 << 255) - 1, 65537, 50, 3], tc.L)
    if window == 4:
        jt = jc.fb_table_pallas(4, 256)
        kernel = jx.JK.mont_fb_exp_pallas
    else:
        jt = jc.fixed_base_table(4, 256, 8)
        kernel = jx.JK.mont_fb8_exp_pallas
    tt = tc.fixed_base_table(4, 256, window)
    assert np.array_equal(as_np(tt), as_np(jt))
    with jx.interpret():
        want = kernel(jt, je, jc.m_limbs, jc.mprime, jc.one_mont)
    assert np.array_equal(as_np(K.mont_fb_exp_plain(tt, te, tc.mod)),
                          as_np(want))


@pytest.mark.parametrize("n,nbits", [(5, 256), (300, 100)])
def test_mont_expprod_plain_matches_pallas(jx, ctxs, n, nbits):
    jc, tc = ctxs
    rng = np.random.default_rng(n)
    jb, tb = _mont(jc, tc, rand_ints(rng, n, tc.m))
    es = rand_ints(rng, n, 1 << nbits)
    es[0], es[-1] = 0, (1 << nbits) - 1
    je, te = _exps(jx, es, tc.L)
    consts = (jc.m_limbs, jc.mprime, jc.one_mont, nbits)
    with jx.interpret():
        want_pos = jx.JK.mont_expprod_positions(jb, je, *consts)
    got_pos = K.mont_expprod_positions_plain(tb, te, tc.mod, nbits)
    assert np.array_equal(as_np(got_pos), as_np(want_pos))
    # K7 (mont_expprod_pallas) is K6 plus a combine of its positions:
    # check the combine against Python ints instead of interpreting K6
    # a second time.
    want = 1
    for x, k in zip(tc.decode(tb), es):
        want = want * pow(x, k, tc.m) % tc.m
    assert tc.decode(K.mont_expprod(tb, te, tc.mod, nbits)[None]) == [want]


def test_interop_round_trips(ctxs):
    from vmn_tpu.arith.pgroup import ModPGroup as JG
    from vmn_tpu_torch.arith.pgroup import ModPGroup as TG, PPGroup

    jg, tg = JG.named("test256"), TG.named("test256", device="cpu")
    rng = np.random.default_rng(12)
    xs = rand_ints(rng, 6, tg.p)
    j_elems = jg.from_ints(xs)
    raw = np.asarray(j_elems.limbs)
    assert np.array_equal(interop.limbs_to_numpy(
        interop.limbs_from_numpy(raw)), raw)
    ga = interop.garray_from_numpy(tg, raw)
    assert ga.to_ints() == [x % tg.p for x in xs]
    std = interop.garray_from_numpy(tg, limbs_np(xs, tg.L), mont=False)
    assert std.equals(ga)
    fa = interop.farray_from_numpy(tg.ring, limbs_np(xs, tg.L))
    assert fa.to_ints() == xs
    pp = interop.pparray_from_numpy(PPGroup(tg, 2), (raw, raw))
    assert pp.to_bytetree().to_bytes() == _jax_pair_bytes(jg, j_elems)


def _jax_pair_bytes(jg, elems):
    from vmn_tpu.arith.pgroup import PPArray, PPGroup

    return PPArray(PPGroup(jg, 2), (elems, elems)).to_bytetree().to_bytes()


# ----------------------------------------------- on the card (skipped here)

_N_CUDA = 300


def _cuda_case(kernel, device):
    """(kernel output, plain output) at modp2048 width on the card."""
    tc = TCtx(modp2048_p(), device)
    rng = np.random.default_rng(21)
    xs = edge_values(tc.m)[1:] + rand_ints(rng, _N_CUDA, tc.m)
    base = tc.encode(xs)
    n = base.shape[0]
    nbits = 2047
    e = device_limbs(limbs_np(rand_ints(rng, n, 1 << nbits), tc.L), device)
    if kernel == "mont_mul":
        other = tc.encode(rand_ints(rng, n, tc.m))
        return (K.mont_mul(base, other, tc.mod),
                K.mont_mul_plain(base, other, tc.mod))
    if kernel == "mont_exp":
        return (K.mont_exp(base, e, tc.mod, nbits),
                K.mont_exp_plain(base, e, tc.mod, nbits))
    if kernel.startswith("mont_fb_exp"):
        table = tc.fixed_base_table(4, nbits, int(kernel[-1]))
        return (K.mont_fb_exp(table, e, tc.mod),
                K.mont_fb_exp_plain(table, e, tc.mod))
    return (K.mont_expprod_positions(base, e, tc.mod, nbits),
            K.mont_expprod_positions_plain(base, e, tc.mod, nbits))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["mont_mul", "mont_exp", "mont_fb_exp4",
                                    "mont_fb_exp8", "mont_expprod_positions"])
def test_cuda_kernel_matches_plain(kernel, cuda_device):
    got, want = _cuda_case(kernel, cuda_device)
    torch.cuda.synchronize()
    assert torch.equal(got, want)

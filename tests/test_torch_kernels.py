"""Each kernel's plain PyTorch version against the JAX Pallas kernel it
ports (run in interpret mode, as tests/test_kernels.py runs them), K7's
combine against Python integers, the cooperative kernels' launch shape,
the interop conversions, and — on a CUDA device only — each Hopper kernel
against its plain version (H1, H2 and the combine over batch sizes, widths
and every TPI they are built for).

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
    TEST256_P, WIDTH_GROUP, as_np, cuda_device, edge_values, limbs_np,
    modp2048_p, modulus, rand_ints,
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


@pytest.mark.parametrize("group,npos", [("modp2048", 16), ("test256", 64)])
def test_expprod_combine_plain_matches_python(group, npos):
    """prod_j P_j^(2^(4j)) of K7's combine, against Python ints."""
    tc = TCtx(modulus(group), device="cpu")
    rng = np.random.default_rng(npos)
    xs = rand_ints(rng, npos, tc.m)
    xs[0], xs[-1] = tc.m - 1, 1
    P = tc.encode(xs)
    want = 1
    for x in reversed(xs):
        want = pow(want, 16, tc.m) * x % tc.m
    got = K.mont_expprod_combine_plain(P, tc.mod)
    assert tc.decode(got[None]) == [want]
    assert torch.equal(K.mont_expprod_combine(P, tc.mod), got)


_LAUNCH_NS = sorted({*range(1, 300), 10000, 131072, 5 * 10**6,
                     *((1 << k) + d for k in range(8, 23) for d in (-1, 0, 1))})


def _first_n(kernel, w, tpi):
    """The fewest elements for which H1 or H2 runs at this TPI."""
    return min(lo for lo, t in K.coop_rule(kernel, w) if t == tpi)


@pytest.mark.parametrize("w", K._WIDTHS)
def test_coop_launch_covers_every_element(w):
    """The TPI the wrappers pick divides W, is built, and is reached by
    some N; the launch's threads cover every element's lanes in whole
    warps, with no block left idle (H4's launch, `ep_launch`, takes the
    TPI of its rule and whole warps of at most `block_cap(w)` threads).  At
    W = 12 (P-384) and W' = 20 (P-521) H4 has no measured rule: it takes
    that of the nearest width at or above with one (`coop_rule`), its
    TPIs taken down to those dividing W."""
    for kernel in ("mont_mul", "mont_exp", "mont_expprod_positions"):
        assert ((kernel, w) in K.COOP_TPI) == (
            w not in (12, 20) or kernel != "mont_expprod_positions")
        rule = K.coop_rule(kernel, w)
        tpis = {t for _, t in rule}
        assert rule[-1][0] == 1  # every N >= 1 has a TPI
        assert [lo for lo, _ in rule] == sorted(
            {lo for lo, _ in rule}, reverse=True)
        ns = sorted({*_LAUNCH_NS, *(lo + d for lo, _ in rule
                                    for d in (-1, 0, 1) if lo + d >= 1)})
        last, seen = None, set()
        for n in ns:
            if kernel == "mont_expprod_positions":
                sh = K.ep_launch(w, n, 64, 132)
                tpi, threads = sh.tpi, sh.threads
                assert 0 < threads <= K.block_cap(w)
            else:
                tpi, threads, blocks = K.coop_launch(kernel, w, n)
                assert 0 < threads <= K.COOP_BLOCK
                assert (blocks - 1) * threads < n * tpi <= blocks * threads
            assert tpi == K.threads_per_element(kernel, w, n) in tpis
            assert w % tpi == 0 and 32 % tpi == 0
            assert threads % 32 == 0 and threads % tpi == 0
            assert last is None or tpi <= last  # fewer lanes as N grows
            last = tpi
            seen.add(tpi)
        assert seen == {t for _, t in rule}
        for _, tpi in rule:
            n = _first_n(kernel, w, tpi)
            assert K.threads_per_element(kernel, w, n) == tpi


# (W, window) of H3's instantiations: both windows at W = 64, 96, 128
# and 32 (built on demand), window 4 at W = 8
_FB_SHAPES = [(w, window, t) for w, window in ((64, 8), (64, 4), (8, 4),
                                               (96, 8), (128, 8), (96, 4),
                                               (128, 4), (32, 8), (32, 4))
              for t in sorted({t for _, t in K.COOP_TPI["mont_fb_exp", w]})]


@pytest.mark.parametrize("w,window,tpi", _FB_SHAPES)
def test_fb_pack_gives_each_lane_its_slice(w, window, tpi):
    """H3's packed table read as its kernel reads it: lane r of a group
    takes vector kk of entry d at d·W + kk·TPI·V + r·V, which must hold
    words r·S + kk·V .. + V - 1 of entry d (S = W/TPI, V the widest of
    4, 2, 1 dividing S)."""
    rng = np.random.default_rng(w + window + tpi)
    ndig, entries, L = 3, 1 << window, 2 * w
    table = torch.from_numpy(rng.integers(0, 1 << 16, (ndig, entries, L),
                                          dtype=np.int64).astype(np.int32))
    packed = K.fb_pack(table, tpi).reshape(ndig, -1).numpy().view(np.uint32)
    words = (table[..., 0::2].numpy().astype(np.uint32)
             | (table[..., 1::2].numpy().astype(np.uint32) << 16))
    S = w // tpi
    V = 4 if S % 4 == 0 else 2 if S % 2 == 0 else 1
    assert V == K.slice_vec(S)
    for j in range(ndig):
        for d in (0, 1, entries - 1):
            for r in range(tpi):
                got = [packed[j, d * w + kk * tpi * V + r * V + v]
                       for kk in range(S // V) for v in range(V)]
                assert got == list(words[j, d, r * S : (r + 1) * S])


@pytest.mark.parametrize("w", K._WIDTHS)
def test_fb_launch_fills_the_card(w):
    """H3's launch shape on 132 SMs: whole warps of at most FB_BLOCK
    threads cover every element's lanes; up to 132·FB_BLOCK lanes the
    blocks fill every SM once (N = 10000 at W = 64: 132 blocks) and from
    32 elements an SM no fewer than 90 % of the SMs get a block.  At
    W = 12 (P-384) and W' = 20 (P-521) H3 has no measured rule and takes
    the nearest wider one's (`coop_rule`)."""
    assert (("mont_fb_exp", w) in K.COOP_TPI) == (w not in (12, 20))
    rule = K.coop_rule("mont_fb_exp", w)
    assert rule[-1][0] == 1
    for n in sorted({1, 2, 5, 31, 33, 131, 132, 133, 4224, 5000, 10000,
                     65536, 1 << 20, *(lo + d for lo, _ in rule
                                       for d in (-1, 0, 1) if lo + d)}):
        tpi, threads, blocks = K.fb_launch(w, n, 132)
        assert tpi == K.threads_per_element("mont_fb_exp", w, n)
        assert w % tpi == 0 and 32 % tpi == 0
        assert threads % 32 == 0 and 0 < threads <= K.FB_BLOCK
        assert (blocks - 1) * threads < n * tpi <= blocks * threads
        if -(-n // 132) * tpi <= K.FB_BLOCK:
            assert blocks <= 132
        if n >= 32 * 132:
            assert blocks >= 0.9 * 132
    if w == 64:
        assert K.fb_launch(64, 10000, 132)[2] == 132


def _ep_visits(w, n, npos, sh):
    """(n, npos) counts of the (element, position) pairs that H4's fold
    multiplies in, and the partial each lands in, walking the launch as
    mont_expprod_kernel does: blocks (element block b, position block),
    chunks, rounds of items over G groups (clamped items do not count),
    steps of each share; also checks the build's four levels on each
    chunk (every entry 2..15 made once, from entries made before it)."""
    G = sh.threads // sh.tpi
    items = sh.jb * sh.subs
    count = np.zeros((n, npos), dtype=np.int64)
    part = np.full((n, npos), -1, dtype=np.int64)
    for b in range(sh.eblocks):
        e0, e1 = b * sh.per_block, min(n, (b + 1) * sh.per_block)
        assert e0 < e1  # no block without elements
        for pb in range(sh.pblocks):
            j0 = pb * sh.jb
            for c0 in range(e0, e1, sh.chunk):
                cnt = min(sh.chunk, e1 - c0)
                made = {0, 1}
                for h in (1, 2, 4, 8):
                    per = min(2 * h, 15) - h
                    work = cnt * per
                    w_ = np.arange(0, work, G)[:, None] + np.arange(G)
                    live = w_ < work
                    k = 1 + w_[live] % per
                    assert {h} | set(k.tolist()) <= made
                    assert np.array_equal(np.sort(w_[live]), np.arange(work))
                    made |= set((h + k).tolist())
                assert made == set(range(16))
                it = (np.arange(0, items, G)[:, None] + np.arange(G)).ravel()
                it = it[it < items]
                assert np.array_equal(np.sort(it), np.arange(items))
                s, p = it // sh.jb, it % sh.jb
                steps = -(-cnt // sh.subs)
                c = s[:, None] + sh.subs * np.arange(steps)[None, :]
                pos = np.broadcast_to((j0 + p)[:, None], c.shape)
                q = np.broadcast_to((b * sh.subs + s)[:, None], c.shape)
                m = c < cnt
                np.add.at(count, (c0 + c[m], pos[m]), 1)
                part[c0 + c[m], pos[m]] = q[m]
    return count, part


# (W, the TPI its COOP_TPI rule gives at every N, where it has one): W = 96
# and 128 are the widths of modp3072 and modp4096.
@pytest.mark.parametrize("w,tpi", [(8, None), (64, None), (96, 16),
                                   (128, 16)])
def test_ep_launch_covers_every_pair(w, tpi):
    """H4's launch shape at each width: whole warps of at most `block_cap(w)`
    threads, position blocks that tile the positions, the chunk's tables
    and the accumulators within the shared memory a block may use, at
    most EP_ACC_BYTES of accumulators; every (element, position) pair
    folded exactly once into a partial below `parts`; with few elements
    and many positions, the positions spread over the SMs."""
    cases = [(1, 512), (6, 512), (16, 512), (37, 112), (300, 64),
             (1000, 512), (10000, 32), (10000, 64), (10000, 112),
             (10000, 160), (1 << 17, 16)]
    if w >= 96:
        cases += [(1, 1024), (1000, 1024), (10000, 768)]
    for n, npos in cases:
        sh = K.ep_launch(w, n, npos, 132)
        assert tpi is None or sh.tpi == tpi
        assert w % sh.tpi == 0 and sh.threads % 32 == 0
        assert 0 < sh.threads <= K.block_cap(w) and sh.threads % sh.tpi == 0
        assert sh.jb % K.EP_JB == 0 and sh.jb * sh.pblocks == npos
        assert sh.pblocks <= 65535 and sh.chunk >= 1
        assert 4 * w * sh.jb * sh.subs <= K.EP_ACC_BYTES
        assert sh.shared_bytes(w) <= K.EP_SHARED
        assert (sh.eblocks - 1) * sh.per_block < n <= sh.eblocks * sh.per_block
        if n * npos <= 1 << 21:
            count, part = _ep_visits(w, n, npos, sh)
            assert (count == 1).all()
            assert part.min() >= 0 and part.max() < sh.parts
        if n < 132:
            assert sh.pblocks * sh.eblocks >= min(132, npos // K.EP_JB)


def test_launch_sizes_count_by_batch():
    K.reset_launches()
    for name, n in [("mont_mul", 1), ("mont_mul", 2), ("mont_mul", 127),
                    ("mont_mul", 128), ("mont_exp", 1), ("mont_exp", 10000),
                    ("mont_fb_exp", 10000), ("mont_expprod_combine", 512)]:
        K._launched(name, n)
    assert K.LAUNCH_SIZES == {"mont_mul": {"1": 1, "2-127": 2, ">=128": 1},
                              "mont_exp": {"1": 1, "2-127": 0, ">=128": 1},
                              "mont_fb_exp": {"1": 0, "2-127": 0, ">=128": 1}}
    assert K.LAUNCHES["mont_expprod_combine"] == 1
    K.reset_launches()
    assert not any(K.LAUNCHES.values())
    assert not any(v for d in K.LAUNCH_SIZES.values() for v in d.values())



@pytest.mark.parametrize("kernel", ["mont_mul", "mont_exp",
                                    "mont_expprod_positions",
                                    "mont_expprod_combine"])
def test_wrapper_refuses_a_wrong_width(kernel):
    """Off the CPU a wrapper hands its operands to a kernel that reads and
    writes mod.L limbs a row, so operands of another width (here 8 limbs
    against test256's 16) raise before anything is built or launched.
    The meta device stands in for the card."""
    mod = K.Modulus.of(TEST256_P, 16, "meta")
    bad = torch.zeros((5, 8), dtype=torch.int32, device="meta")
    call = {
        "mont_mul": lambda: K.mont_mul(bad, bad, mod),
        "mont_exp": lambda: K.mont_exp(bad, bad, mod, 128),
        "mont_expprod_positions": lambda: K.mont_expprod_positions(
            bad, bad, mod, 128),
        "mont_expprod_combine": lambda: K.mont_expprod_combine(bad, mod),
    }[kernel]
    with pytest.raises(ValueError, match=r"expected int32 \(N=5, 16\)"):
        call()


def test_interop_round_trips(ctxs):
    from vmn_tpu.arith.pgroup import ModPGroup as JG
    from vmn_tpu_torch.arith.pgroup import ModPGroup as TG, PPGroup

    jg, tg = JG.named("test256"), TG.named("test256", device="cpu")
    rng = np.random.default_rng(12)
    xs = rand_ints(rng, 6, tg.p)
    j_elems = jg.from_ints(xs)
    raw = np.asarray(j_elems.limbs)
    assert np.array_equal(interop.limbs_to_numpy(
        interop.limbs_from_numpy(raw, device="cpu")), raw)
    ga = interop.garray_from_numpy(tg, raw)
    assert ga.to_ints() == [x % tg.p for x in xs]
    std = interop.garray_from_numpy(tg, limbs_np(xs, tg.L), mont=False)
    assert std.equals(ga)
    fa = interop.farray_from_numpy(tg.ring, limbs_np(xs, tg.L))
    assert fa.to_ints() == xs
    pp = interop.pparray_from_numpy(PPGroup(tg, 2), (raw, raw))
    assert pp.to_bytetree().to_bytes() == _jax_pair_bytes(jg, j_elems)


def test_interop_limbs_default_to_the_card():
    """`limbs_from_numpy`, the state carrier of the other helpers, puts
    limbs on the card unless the caller names a device; without a card it
    raises instead of running on the CPU."""
    import inspect

    fn = interop.limbs_from_numpy
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    raw = np.arange(8, dtype=np.uint32).reshape(2, 4)
    if torch.cuda.is_available():
        assert fn(raw).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            fn(raw)
    assert fn(raw, device="cpu").device.type == "cpu"


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


_COOP_NS = [1, 2, 31, 33, 129, 4096]


def _coop_case(kernel, group, n, device):
    """(kernel output, plain output) of H1 or H2 on n elements."""
    tc = TCtx(modulus(group), device)
    rng = np.random.default_rng(n)
    xs = (edge_values(tc.m)[1:] + rand_ints(rng, n, tc.m))[:n]
    base = tc.encode(xs)
    if kernel == "mont_mul":
        other = tc.encode(rand_ints(rng, n, tc.m)[::-1])
        return (K.mont_mul(base, other, tc.mod),
                K.mont_mul_plain(base, other, tc.mod))
    # full-width exponents where the plain version stays quick
    nbits = tc.nbits - 1 if n <= 129 else 256
    es = rand_ints(rng, n, 1 << nbits)
    es[0] = 0
    e = device_limbs(limbs_np(es, -(-nbits // 16)), device)
    return (K.mont_exp(base, e, tc.mod, nbits),
            K.mont_exp_plain(base, e, tc.mod, nbits))


@pytest.mark.cuda
@pytest.mark.parametrize("group", ["test256", "modp2048"])  # W = 8, 64
@pytest.mark.parametrize("n", _COOP_NS)
@pytest.mark.parametrize("kernel", ["mont_mul", "mont_exp"])
def test_cuda_coop_matches_plain(kernel, n, group, cuda_device):
    got, want = _coop_case(kernel, group, n, cuda_device)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,group,tpi", [
    (k, g, t) for k in ("mont_mul", "mont_exp")
    for g, w in (("test256", 8), ("modp2048", 64))
    for _, t in K.COOP_TPI[k, w]])
def test_cuda_coop_every_tpi(kernel, group, tpi, cuda_device):
    """Each TPI the wrapper picks, reached through N: at the fewest
    elements for which it picks it."""
    w = 8 if group == "test256" else 64
    got, want = _coop_case(kernel, group, _first_n(kernel, w, tpi),
                           cuda_device)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("group,nbits", [
    ("modp2048", 64), ("modp2048", 256), ("modp2048", 2047),
    ("test256", 256)])
def test_cuda_combine_matches_plain(group, nbits, cuda_device):
    """K7's combine in one launch, alone and inside mont_expprod."""
    tc = TCtx(modulus(group), cuda_device)
    rng = np.random.default_rng(nbits)
    npos = K._ndig_pad(nbits)
    P = tc.encode(rand_ints(rng, npos, tc.m))
    got = K.mont_expprod_combine(P, tc.mod)
    assert torch.equal(got, K.mont_expprod_combine_plain(P, tc.mod))
    bases = tc.encode(rand_ints(rng, 40, tc.m))
    e = device_limbs(limbs_np(rand_ints(rng, 40, 1 << nbits),
                              -(-nbits // 16)), cuda_device)
    K.reset_launches()
    got = K.mont_expprod(bases, e, tc.mod, nbits)
    assert K.LAUNCHES["mont_expprod_combine"] == 1
    want = K.mont_expprod_combine_plain(
        K.mont_expprod_positions_plain(bases, e, tc.mod, nbits), tc.mod)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 1000])
@pytest.mark.parametrize("w,window,tpi", _FB_SHAPES)
def test_cuda_fb_exp_every_tpi(w, window, tpi, n, cuda_device, monkeypatch):
    """H3 at each (W, window, TPI) it is built for, the TPI forced through
    its rule: one element, and batches that are no multiple of a block;
    exponents all ones and 0 among random ones.  A width the main
    library lacks (W = 32) has its library built before the rule is
    forced, so that it holds every TPI of the rule."""
    if w not in K._WIDTHS:
        K.width_library(w)
    monkeypatch.setitem(K.COOP_TPI, ("mont_fb_exp", w), ((1, tpi),))
    tc = TCtx(modulus(WIDTH_GROUP[w]), cuda_device)
    nbits = tc.nbits - 1 if window == 8 else 256
    table = tc.fixed_base_table(5, nbits, window)
    rng = np.random.default_rng(n + tpi)
    es = [(1 << nbits) - 1, 0] + rand_ints(rng, n, 1 << nbits)
    e = device_limbs(limbs_np(es[:n], -(-nbits // 16)), cuda_device)
    K.reset_launches()
    got = K.mont_fb_exp(table, e, tc.mod)
    assert K.LAUNCHES["mont_fb_exp"] == 1
    want = K.mont_fb_exp_plain(table, e, tc.mod)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert tc.decode(got[:2]) == [pow(5, x, tc.m) for x in es[:min(n, 2)]]



# W = 8 and 64 here; W = 96 and 128 in tests/test_torch_wide.py, on fewer
# elements (the plain version's lane tree over 10000 elements at 2047
# bits grows with L²)
_EP_PAIRS = [(w, t) for w in (8, 64)
             for t in sorted({t for _, t in K.COOP_TPI[
                 "mont_expprod_positions", w]})]


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [100, 256, 2047])
@pytest.mark.parametrize("n", [1, 6, 37, 1000, 10000])
@pytest.mark.parametrize("w,tpi", _EP_PAIRS)
def test_cuda_expprod_every_tpi(w, tpi, n, nbits, cuda_device, monkeypatch):
    """H4 at each (W, TPI) it is built for, the TPI forced through its
    rule: batches that are no multiple of a chunk or of a block's
    elements, exponents all ones and 0 among random ones; against the
    plain version's positions and, combined, Python pow."""
    monkeypatch.setitem(K.COOP_TPI, ("mont_expprod_positions", w),
                        ((1, tpi),))
    tc = TCtx(modulus(WIDTH_GROUP[w]), cuda_device)
    nbits = min(nbits, tc.nbits - 1)
    rng = np.random.default_rng(n + tpi + nbits)
    xs = rand_ints(rng, n, tc.m)
    es = ([(1 << nbits) - 1, 0] + rand_ints(rng, n, 1 << nbits))[:n]
    bases = tc.encode(xs)
    e = device_limbs(limbs_np(es, -(-nbits // 16)), cuda_device)
    K.reset_launches()
    got = K.mont_expprod_positions(bases, e, tc.mod, nbits)
    assert K.LAUNCHES["mont_expprod_positions"] == 1
    want = K.mont_expprod_positions_plain(bases, e, tc.mod, nbits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if n <= 37:
        prod = 1
        for x, k in zip(xs, es):
            prod = prod * pow(x, k, tc.m) % tc.m
        combined = K.mont_expprod_combine(got, tc.mod)
        assert tc.decode(combined[None]) == [prod]

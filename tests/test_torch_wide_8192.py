"""The port at RFC 3526's groups past 4096 bits, modp6144 (W = 192 words,
L = 384 limbs) and modp8192 (W = 256, L = 512), the kernels' widths
built on demand.

On the CPU, against `vmn_tpu` and Python integers:

* each plain version of a kernel on these widths' paths against
  `vmn_tpu.arith.mont.MontCtx` (its XLA path on the CPU) on the same
  group: H1 `mont_mul`, H2 `mont_exp` (64-bit exponents), H3
  `mont_fb_exp` at window 8 (eight digits), H4 `mont_expprod_positions`
  with K7's combine through `MontCtx.expprod` (seven elements);
* `kernel_words` / `Modulus.of` at 6144, 8192 and 8224 bits (the last
  maps to W' = 288, converting; 16416 bits pass the cap of 512 words
  and raise, naming it);
* the launch rules: each `COOP_TPI` rule at W = 192 and 256 and the TPI
  masks its width library is built with (csrc/mont_kernels.cu, VMN_W);
  H3's pieces (`fb_pieces`, quarters of a window-8 digit at W = 256) and
  its packed table read piece by piece as the kernel reads it; H4's
  launch shape over N in {1, 16, 10000} at the paths' position counts.

On a CUDA device only (skipped here): each kernel at W = 192 and 256
against its plain version at every TPI of its rule, K7's combine over a
full-width exponent's positions, and the port's verifier on `vmn_tpu`'s
modp8192 golden transcript (on the CPU it takes minutes;
tests/test_torch_wide_6144.py runs modp6144's there).

Inputs are seeded numpy bytes handed to both packages.  Tolerance: exact
equality of limbs and bytes (integer arithmetic).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_kernels import _ep_visits
from test_torch_wide import _wide_case, verify_wide_golden
from torch_port_util import (  # noqa: F401 (cuda_device: fixture)
    as_np, cuda_device, edge_values, limbs_np, modulus, rand_ints,
)
from vmn_tpu_torch.arith.mont import MontCtx as TCtx, device_limbs
from vmn_tpu_torch.ops import mont_kernels as K

RFC = {"modp6144": 192, "modp8192": 256}
CSRC = Path(K.__file__).resolve().parent.parent / "csrc" / "mont_kernels.cu"
KERNELS = ("mont_mul", "mont_exp", "mont_fb_exp", "mont_expprod_positions")


@pytest.fixture(scope="module", params=list(RFC))
def ctxs(request):
    from vmn_tpu.arith.mont import MontCtx as JCtx

    m = modulus(request.param)
    return JCtx(m), TCtx(m, device="cpu")


def _mont(jc, tc, xs):
    """Python ints -> (vmn_tpu, port) Montgomery-form limbs."""
    import jax.numpy as jnp

    arr = limbs_np(xs, tc.L)
    return jc.to_mont(jnp.asarray(arr)), tc.to_mont(device_limbs(arr, "cpu"))


def _exps(es, le):
    import jax.numpy as jnp

    arr = limbs_np(es, le)
    return jnp.asarray(arr), device_limbs(arr, "cpu")


# ------------------------------------------------------ the plain versions


def test_mont_mul_plain_matches_vmn_tpu(ctxs):
    jc, tc = ctxs
    assert tc.L in (384, 512)
    rng = np.random.default_rng(tc.L)
    xs = edge_values(tc.m)[:5] + rand_ints(rng, 2, tc.m)
    ys = xs[::-1]
    ja, ta = _mont(jc, tc, xs)
    jb, tb = _mont(jc, tc, ys)
    assert np.array_equal(as_np(ta), as_np(ja))
    got = K.mont_mul_plain(ta, tb, tc.mod)
    assert np.array_equal(as_np(got), as_np(jc.mul(ja, jb)))
    assert tc.decode(got) == [x * y % tc.m for x, y in zip(xs, ys)]


def test_mont_exp_plain_matches_vmn_tpu(ctxs):
    """64-bit exponents (0 and all ones among them) on five elements."""
    jc, tc = ctxs
    rng = np.random.default_rng(tc.L + 1)
    xs = [2, tc.m - 1] + rand_ints(rng, 3, tc.m)
    es = [0, (1 << 64) - 1] + rand_ints(rng, 3, 1 << 64)
    ja, ta = _mont(jc, tc, xs)
    je, te = _exps(es, 4)
    got = K.mont_exp_plain(ta, te, tc.mod, 64)
    assert np.array_equal(as_np(got), as_np(jc.exp(ja, je, 64)))
    assert tc.decode(got) == [pow(x, e, tc.m) for x, e in zip(xs, es)]


def test_mont_fb_exp_plain_matches_vmn_tpu(ctxs):
    """H3 at window 8 (these widths' fixed-base powers) over eight
    digits: the port's table equals vmn_tpu's, and so do the powers."""
    jc, tc = ctxs
    rng = np.random.default_rng(tc.L + 2)
    es = [0, (1 << 64) - 1] + rand_ints(rng, 3, 1 << 64)
    je, te = _exps(es, 4)
    table = tc.fixed_base_table(4, 64, 8)
    assert table.shape == (8, 256, tc.L)
    assert np.array_equal(as_np(table), as_np(jc.fixed_base_table(4, 64, 8)))
    got = K.mont_fb_exp_plain(table, te, tc.mod)
    assert np.array_equal(as_np(got),
                          as_np(jc.fixed_base_exp(4, je, 64, 8)))
    assert tc.decode(got) == [pow(4, e, tc.m) for e in es]


def test_expprod_plain_matches_vmn_tpu(ctxs):
    """H4's positions and K7's combine (MontCtx.expprod) on seven bases
    with 64-bit exponents (16 positions)."""
    jc, tc = ctxs
    rng = np.random.default_rng(tc.L + 3)
    xs = [1, tc.m - 1] + rand_ints(rng, 5, tc.m)
    es = [(1 << 64) - 1, 0] + rand_ints(rng, 5, 1 << 64)
    ja, ta = _mont(jc, tc, xs)
    je, te = _exps(es, 4)
    P = K.mont_expprod_positions_plain(ta, te, tc.mod, 64)
    assert P.shape == (K._ndig_pad(64), tc.L)
    got = tc.expprod(ta, te, 64)
    assert np.array_equal(as_np(got),
                          as_np(K.mont_expprod_combine_plain(P, tc.mod)))
    assert np.array_equal(as_np(got), as_np(jc.expprod(ja, je, 64)))
    want = 1
    for x, e in zip(xs, es):
        want = want * pow(x, e, tc.m) % tc.m
    assert tc.decode(got[None]) == [want]


# ------------------------------------------------------------ the widths


@pytest.mark.parametrize("name", list(RFC))
def test_modulus_at_rfc_widths(name):
    """6144 and 8192 bits: L/2 words, no boundary conversion, off the CPU
    too (a meta device stands in for the card)."""
    m, w = modulus(name), RFC[name]
    L = 2 * w
    assert K.kernel_words(L) == w
    mod = K.Modulus.of(m, L, torch.device("meta"))
    assert mod.W == w and not mod.conv and mod.c_in is None
    assert K.Modulus.of(m, L, "cpu").W == w


def test_modulus_cap_of_256_words():
    """The cap moved from 256 to 512 words: 8224 bits (L = 514), past the
    old cap, map to W' = 288 with the boundary conversion; above 512
    words no kernel is built: 16416 bits (L = 1026) raise off the CPU,
    naming the cap, and the plain versions on the CPU take them; the
    widths above 128 words round to 32 (TPI 32, 16 words a lane at
    most)."""
    m = (1 << 8223) + 1
    mod = K.Modulus.of(m, 514, torch.device("meta"))
    assert (mod.W, mod.conv) == (288, True)
    m = (1 << 16415) + 1
    with pytest.raises(ValueError, match="cap of 512 words"):
        K.Modulus.of(m, 1026, torch.device("meta"))
    with pytest.raises(ValueError, match="cap of 512 words"):
        K.kernel_words(1026)
    assert K.Modulus.of(m, 1026, "cpu").W == 513
    assert [K.kernel_words(L) for L in (258, 320, 322, 450, 512, 514, 960,
                                        1024)] == [
        160, 160, 192, 256, 256, 288, 480, 512]


# ------------------------------------------------------- the launch rules


@pytest.mark.parametrize("w", sorted(RFC.values()))
@pytest.mark.parametrize("kernel", KERNELS)
def test_coop_rule_rows_and_tpi_masks(kernel, w):
    """Each rule at W = 192 and 256 is measured (a row of COOP_TPI), names
    TPIs that divide W, fit a warp and leave a lane at most 8 words (16
    for H1 and H2, whose blocks are 128 threads); the width's library is
    built with exactly those TPIs (bit t of the kernel's mask), which the
    .cu's at_tpi launches where t divides VMN_W."""
    assert w not in K._WIDTHS  # built on demand
    rule = K.COOP_TPI[kernel, w]
    assert rule == K.coop_rule(kernel, w) and rule[-1][0] == 1
    most = 16 if kernel in ("mont_mul", "mont_exp") else 8
    tpis = {t for _, t in rule}
    for t in tpis:
        assert t & (t - 1) == 0 and t <= 32 and w % t == 0
        assert w // t <= most
    assert set(K.width_tpis(w)[kernel]) == tpis
    flags = K._width_flags(w, K.width_tpis(w))
    mask = K.COOP_MONT[kernel]
    assert f"-D{mask}={sum(tpis)}" in flags and f"-DVMN_W={w}" in flags
    src = CSRC.read_text()
    assert f"at_tpi<{mask}>" in src
    assert "(kMask & T) != 0 && VMN_W % T == 0" in src


def test_fb_pieces_mirrors_the_kernel():
    """H3's pieces: the smallest power of two whose two buffers fit the
    227 KB a block may use; window 8 whole to W = 96, halves at 128 and
    192 (96 KB each), quarters at 256 (64 KB each); window 4 whole."""
    src = CSRC.read_text()
    assert "2 * (4 << WB) * W / P <= kFbShared" in src
    assert "constexpr int kFbShared = 232448;" in src
    assert K.FB_SHARED == 232448
    want = {64: 1, 96: 1, 128: 2, 192: 2, 256: 4}
    for w, pieces in want.items():
        assert K.fb_pieces(w, 8) == pieces and K.fb_pieces(w, 4) == 1
        stage = 2 * 4 * 256 * w // pieces
        assert stage <= K.FB_SHARED
        assert pieces == 1 or 2 * stage > K.FB_SHARED  # the smallest
    assert 2 * 4 * 128 * 192 == 196608 <= K.FB_SHARED  # W = 192's halves


@pytest.mark.parametrize("tpi", [16, 32])
def test_fb_pack_read_piece_by_piece(tpi):
    """H3's packed table at W = 256, window 8, read as its kernel reads a
    quarter digit: piece u = j·4 + p is words u·64·W .. of the packed
    table, and lane r takes vector kk of its entry d at d·W + kk·TPI·V +
    r·V in the piece, which must hold words r·S + kk·V .. of entry
    p·64 + d of digit j."""
    w, window = 256, 8
    pieces = K.fb_pieces(w, window)
    per = (1 << window) // pieces
    rng = np.random.default_rng(tpi)
    ndig = 2
    table = torch.from_numpy(rng.integers(0, 1 << 16, (ndig, 1 << window,
                                                       2 * w),
                                          dtype=np.int64).astype(np.int32))
    packed = K.fb_pack(table, tpi).numpy().view(np.uint32).reshape(
        ndig * pieces, per * w)
    words = (table[..., 0::2].numpy().astype(np.uint32)
             | (table[..., 1::2].numpy().astype(np.uint32) << 16))
    S = w // tpi
    V = K.slice_vec(S)
    for u in range(ndig * pieces):
        j, p = divmod(u, pieces)
        for d in (0, 1, per - 1):
            for r in (0, 1, tpi - 1):
                got = [packed[u, d * w + kk * tpi * V + r * V + v]
                       for kk in range(S // V) for v in range(V)]
                assert got == list(words[j, p * per + d, r * S:(r + 1) * S])


@pytest.mark.parametrize("w", sorted(RFC.values()))
def test_ep_launch_at_rfc_widths(w):
    """H4's launch at W = 192 and 256 over N in {1, 16, 10000} at the
    paths' position counts (exponents of 100, 256, 400, 612 bits and |q|):
    at least one element a chunk, the tables and accumulators within a
    block's shared memory, whole warps of at most `block_cap(w)` threads; every
    (element, position) pair folded once where the walk is small."""
    full = 32 * w - 1
    for n in (1, 16, 10000):
        for bits in (100, 256, 400, 612, full):
            npos = K._ndig_pad(bits)
            sh = K.ep_launch(w, n, npos, 132)
            assert sh.chunk >= 1
            assert sh.shared_bytes(w) <= K.EP_SHARED
            assert 4 * w * sh.jb * sh.subs <= K.EP_ACC_BYTES
            assert sh.threads % 32 == 0 and 0 < sh.threads <= K.block_cap(w)
            assert sh.jb * sh.pblocks == npos and sh.jb % K.EP_JB == 0
            assert (sh.eblocks - 1) * sh.per_block < n <= (
                sh.eblocks * sh.per_block)
            if n * npos <= 1 << 17:
                count, part = _ep_visits(w, n, npos, sh)
                assert (count == 1).all()
                assert part.min() >= 0 and part.max() < sh.parts


# ---------------------------------------------- on the card (skipped here)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 300])
@pytest.mark.parametrize("kernel,window,name,tpi", [
    (k, wb, g, t) for k in KERNELS
    for wb in ((8, 4) if k == "mont_fb_exp" else (8,))
    for g, w in RFC.items() for t in sorted({t for _, t in K.COOP_TPI[k, w]})])
def test_cuda_rfc_kernel_matches_plain(kernel, window, name, tpi, n,
                                       cuda_device, monkeypatch):
    """Each kernel at W = 192 and 256 at each TPI of its rule (forced
    through the rule), H3 at both windows, against its plain version.
    The width's library is built (at its first use) before the rule is
    forced, so that it holds every TPI of the rule."""
    K.width_library(RFC[name])
    monkeypatch.setitem(K.COOP_TPI, (kernel, RFC[name]), ((1, tpi),))
    run, plain = _wide_case(kernel, name, n, cuda_device, window)
    K.reset_launches()
    got = run()
    assert K.LAUNCHES[kernel] == 1
    want = plain()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(RFC))
def test_cuda_rfc_combine_matches_plain(name, cuda_device):
    """K7's combine over a full-width exponent's positions (1536, 2048)."""
    tc = TCtx(modulus(name), cuda_device)
    npos = K._ndig_pad(tc.nbits - 1)
    assert npos == 8 * RFC[name]
    P = tc.encode(rand_ints(np.random.default_rng(npos), npos, tc.m))
    got = K.mont_expprod_combine(P, tc.mod)
    assert torch.equal(got, K.mont_expprod_combine_plain(P, tc.mod))


@pytest.mark.cuda
def test_cuda_port_verifier_accepts_vmn_tpu_modp8192_golden(tmp_path,
                                                           cuda_device):
    """The port's verifier on the card accepts vmn_tpu's modp8192 golden
    with its test vectors and rejects the g = 4 -> 9 tamper."""
    verify_wide_golden("modp8192", tmp_path, device=cuda_device)

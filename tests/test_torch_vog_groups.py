"""The port at fresh ModP groups, as `vog -gen ModPGroup -bitlen n`
makes them, against `vmn_tpu` on the CPU.

* The fixtures (tests/torch_make_wide_golden.py): vmn_tpu's
  `random_group` of 1024 bits (L = 64 limbs, the kernels' W = 32) and of
  1000 bits (L = 63, an odd count: W' = 32 with the boundary conversion)
  from SeededSource(b"golden-group-1024") / (b"golden-group-1000"),
  each with the k=1 golden mix of tools/make_golden.py.  The port
  rewrites both transcripts byte for byte and preserves the plaintext
  multiset, its verifier accepts vmn_tpu's transcript with vmn_tpu's
  test vectors, and vmn_tpu's verifier accepts the port's.  Each
  group file holds a safe prime of the stated length; the port's
  `random_group` equals vmn_tpu's (at 128 bits: the 1024-bit search is
  too slow here).
* F14: a group whose co-order (p - 1)/q passes 64 bits (a 256-bit p, a
  128-bit q) draws `random_array` as Python powers of the same PRG
  integers in the port; vmn_tpu's raises (its exponent holds 64 bits);
  a safe prime's limbs are the same in both.
* `Modulus.of`, the one map from a limb count to the kernels' words:
  every earlier width kept, W = 32 at L = 64, W' = 32 converting at
  L = 63, the cap of 256 words off the CPU; a failed on-demand build
  raises with nvcc's log, and an entry point the main library lacks
  goes to the width's library (stand-in libraries, no card).
* The plain versions of H1-H4 and K7's combine at L = 64 and 63, and H3
  at window 4 at W = 96, against vmn_tpu's MontCtx (its CPU route).
* On a CUDA device only (skipped here): each kernel built on demand (W =
  32 at both limb counts, H3 and H4 at W = 12 and W' = 20, H3 at window
  4 at W = 96 and 128) against its plain version.

Inputs are seeded numpy bytes and integers handed to both packages.
Tolerance: exact equality of limbs and bytes (integer arithmetic).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401 (cuda_device: fixture)
    TV_NAMES, as_np, assert_same_transcript, cuda_device, edge_values,
    group_file, group_pqg as vog_pqg, limbs_np, modulus, rand_ints,
)
from vmn_tpu_torch.arith.mont import MontCtx as TCtx, device_limbs
from vmn_tpu_torch.ops import mont_kernels as K

GOLDEN = Path(__file__).parent / "golden"
VOG = {"vog1024": 1024, "vog1000": 1000}


def _port_group(name: str):
    from vmn_tpu_torch.arith.pgroup import ModPGroup

    return ModPGroup(*vog_pqg(name), device="cpu")


def _params(group):
    from vmn_tpu_torch.protocol.context import ProtocolParams

    return ProtocolParams(sid="Golden", k=1, threshold=1, pgroup=group)


# --------------------------------------------------------- the goldens


@pytest.fixture(scope="module", params=list(VOG))
def port_mix(request, tmp_path_factory):
    """The golden mix of tools/make_golden.py (five messages) by the port
    on the CPU over a fresh group: (name, nizkp dir, messages,
    plaintexts)."""
    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.protocol import elgamal
    from vmn_tpu_torch.protocol.com.board import LocalBoardHub
    from vmn_tpu_torch.protocol.mixnet.party import MixNetParty

    name = request.param
    group = _port_group(name)
    out = tmp_path_factory.mktemp(f"port_golden_{name}")
    party = MixNetParty(_params(group), LocalBoardHub(1).board(1),
                        SeededSource(b"golden-party"), str(out))
    pk = party.keygen()
    msgs = [group.encode_message(f"{i:08d}".encode()) for i in range(5)]
    r = group.ring.random((5,), SeededSource(b"golden-ciphs"), 0)
    ciphs = elgamal.encrypt(pk, group.from_ints(msgs), r)
    party.board = LocalBoardHub(1).board(1)
    plain = party.session("golden", 1).mix(ciphs)
    return name, out / "nizkp.golden", msgs, plain.to_ints()


def test_port_rewrites_vog_golden(port_mix):
    name, nizkp, msgs, plain = port_mix
    assert sorted(plain) == sorted(msgs)
    assert_same_transcript(nizkp, GOLDEN / f"nizkp_{name}_k1")


def test_port_verifier_accepts_vmn_tpu_vog_golden(port_mix):
    from vmn_tpu_torch.protocol.mixnet.verifier import FiatShamirVerifier

    name = port_mix[0]
    v = FiatShamirVerifier(_params(_port_group(name)),
                           GOLDEN / f"nizkp_{name}_k1",
                           test_vectors=TV_NAMES)
    res = v.verify(expected_type="mixing")
    assert res.ok and res.shuffle_ok and res.decrypt_ok
    assert v.tv == json.loads(
        (GOLDEN / f"test_vectors_{name}.json").read_text())


def test_vmn_tpu_verifier_accepts_port_vog_transcript(port_mix):
    from vmn_tpu.arith.pgroup import ModPGroup as JG
    from vmn_tpu.protocol.context import ProtocolParams as JParams
    from vmn_tpu.protocol.mixnet.verifier import FiatShamirVerifier as JV

    name, nizkp = port_mix[:2]
    params = JParams(sid="Golden", k=1, threshold=1,
                     pgroup=JG(*vog_pqg(name)))
    assert JV(params, nizkp).verify(expected_type="mixing").ok


@pytest.mark.parametrize("name", list(VOG))
def test_group_file_holds_a_safe_prime(name):
    from vmn_tpu_torch.crypto.primes import miller_rabin
    from vmn_tpu_torch.crypto.randomsource import SeededSource

    f = group_file(name)
    p, q, g = vog_pqg(name)
    assert f["bits"] == VOG[name] == p.bit_length()
    assert f["seed"] == f"golden-group-{VOG[name]}"
    assert q == (p - 1) // 2
    rs = SeededSource(b"test-vog-safe-prime")
    assert miller_rabin(p, rs, 20) and miller_rabin(q, rs, 20)
    assert g not in (0, 1) and pow(g, q, p) == 1
    assert _port_group(name).L == -(-VOG[name] // 16)


def test_random_group_matches_vmn_tpu():
    from vmn_tpu.crypto.primes import random_group as j_random_group
    from vmn_tpu.crypto.randomsource import SeededSource as JSource
    from vmn_tpu_torch.crypto.primes import random_group
    from vmn_tpu_torch.crypto.randomsource import SeededSource

    got = random_group(128, SeededSource(b"vog-128"), device="cpu")
    want = j_random_group(128, JSource(b"vog-128"))
    assert (got.p, got.q, got.g_int) == (want.p, want.q, want.g_int)
    assert got.p.bit_length() == 128


# --------------------------------------------------------------- F14


def _short_q_group(seed: int) -> tuple:
    """(p, q, g): a 256-bit prime p = k·q + 1 over a 128-bit prime q
    (co-order k of about 128 bits), g of order q, from numpy's seeded
    bytes and Python integers."""
    from vmn_tpu_torch.crypto.primes import miller_rabin
    from vmn_tpu_torch.crypto.randomsource import SeededSource

    rng = np.random.default_rng(seed)
    rs = SeededSource(b"test-short-q")
    while True:
        q = int.from_bytes(rng.bytes(16), "big") | (1 << 127) | 1
        if miller_rabin(q, rs, 20):
            break
    while True:
        k = (int.from_bytes(rng.bytes(16), "big") | (1 << 128)) & ~1
        p = k * q + 1
        if p.bit_length() == 256 and miller_rabin(p, rs, 20):
            break
    h = 2
    while pow(h, k, p) == 1:
        h += 1
    return p, q, pow(h, k, p)


def _prg(seed: bytes):
    from vmn_tpu_torch.crypto.hash import SHA256
    from vmn_tpu_torch.crypto.prg import PRGHeuristic

    prg = PRGHeuristic(SHA256)
    prg.set_seed(SHA256.hash(seed))
    return prg


def test_random_array_short_q_equals_python_powers():
    """The port draws n (nbits + rbitlen)-bit integers from the PRG and
    raises each to the co-order (p - 1)/q, here 129 bits."""
    from vmn_tpu_torch.arith.pgroup import ModPGroup

    p, q, g = _short_q_group(14)
    co = (p - 1) // q
    assert co.bit_length() > 64
    grp = ModPGroup(p, q, g, device="cpu")
    n, rbitlen = 6, 100
    got = grp.random_array(n, _prg(b"f14"), rbitlen).to_ints()
    bits = grp.nbits + rbitlen
    nbytes = (bits + 7) // 8
    raw = _prg(b"f14").read_bytes(n * nbytes)
    want = [pow((int.from_bytes(raw[i * nbytes:(i + 1) * nbytes], "big")
                 & ((1 << bits) - 1)) % p, co, p) for i in range(n)]
    assert got == want
    assert all(pow(x, q, p) == 1 for x in got)


def test_vmn_tpu_random_array_short_q_raises():
    """vmn_tpu takes the co-order in a 64-bit exponent array: a larger
    one raises (the port's F14; vmn_tpu stays as it is)."""
    from vmn_tpu.arith.pgroup import ModPGroup as JG
    from vmn_tpu.crypto.hash import SHA256 as JSHA
    from vmn_tpu.crypto.prg import PRGHeuristic as JPRG

    grp = JG(*_short_q_group(14))
    prg = JPRG(JSHA)
    prg.set_seed(JSHA.hash(b"f14"))
    with pytest.raises(ValueError, match="too large"):
        grp.random_array(6, prg, 100)


def test_random_array_safe_prime_same_limbs():
    """A safe prime's co-order (2) takes the same 64-bit exponent in both
    packages: the same limbs."""
    from vmn_tpu.arith.pgroup import ModPGroup as JG
    from vmn_tpu.crypto.hash import SHA256 as JSHA
    from vmn_tpu.crypto.prg import PRGHeuristic as JPRG

    pqg = vog_pqg("vog1000")
    prg = JPRG(JSHA)
    prg.set_seed(JSHA.hash(b"safe"))
    want = JG(*pqg).random_array(4, prg, 100)
    got = _port_group("vog1000").random_array(4, _prg(b"safe"), 100)
    assert np.array_equal(as_np(got.limbs), as_np(want.limbs))


# ------------------------------------------------------------ Modulus.of


@pytest.mark.parametrize("L,W,conv", [
    (14, 8, True), (16, 8, False), (24, 12, False), (33, 20, True),
    (128, 64, False), (192, 96, False), (256, 128, False),
    (64, 32, False), (63, 32, True), (40, 20, False), (23, 16, True),
    (130, 80, True)])
def test_modulus_words(L, W, conv):
    """Every width built before keeps its words; W = 32 at L = 64, W' =
    32 converting at L = 63 (c_in = R'^2/R, c_out = R, the kernels' one
    R' mod m); other limb counts round up to multiples of 8 words (16
    above 64)."""
    m = (1 << (16 * L - 1)) + 2 * L + 1  # odd, L limbs
    mod = K.Modulus.of(m, L, torch.device("meta"))
    assert (mod.L, mod.W, mod.conv) == (L, W, conv)
    assert K.kernel_words(L) == W
    mod = K.Modulus.of(m, L, "cpu")
    R, Rp = 1 << (16 * L), 1 << (32 * W)
    val = lambda t: sum(int(v) << (16 * i) for i, v in enumerate(t))  # noqa
    assert val(mod.kernel_one) == Rp % m and mod.kernel_limbs.shape == (2 * W,)
    if conv:
        assert val(mod.c_in) == Rp * Rp * pow(R, -1, m) % m
        assert val(mod.c_out) == R % m
    else:
        assert mod.c_in is None and mod.c_out is None


def test_modulus_cap():
    """A 6144- or 8192-bit group maps to W = 192 or 256, an 8224-bit one
    to W' = 288 with the boundary conversion; above 512 words (16416
    bits) no kernel is built: off the CPU the map raises naming the cap;
    the plain versions on the CPU take any width."""
    m = (1 << 8191) + 1
    assert K.Modulus.of(m, 512, torch.device("meta")).W == 256
    assert K.kernel_words(384) == 192
    m = (1 << 8223) + 1
    mod = K.Modulus.of(m, 514, torch.device("meta"))
    assert (mod.W, mod.conv) == (288, True)
    m = (1 << 16415) + 1
    with pytest.raises(ValueError, match="cap of 512 words"):
        K.Modulus.of(m, 1026, torch.device("meta"))
    with pytest.raises(ValueError, match="cap of 512 words"):
        K.kernel_words(1026)
    assert K.Modulus.of(m, 1026, "cpu").W == 513


# -------------------------------------------------- the on-demand build


def test_failed_width_build_raises_with_nvcc_log(tmp_path, monkeypatch):
    """A width library whose nvcc fails raises with nvcc's output; no
    library is left behind."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: a stand-in nvcc' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(K, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(K, "_BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="a stand-in nvcc"):
        K.build_widths([32])
    assert not list((tmp_path / "build").glob("*.so"))


class _Lib:
    """A stand-in library whose entry point returns `rc` and counts its
    calls."""

    def __init__(self, rc):
        self.rc, self.calls = rc, 0

    def vmn_mont_mul(self, *args):
        self.calls += 1
        return self.rc


def test_launch_routes_to_the_width_library(monkeypatch):
    """An entry point the main library has no case for (it returns
    kUnsupportedWidth before launching) goes to the width's library,
    which is remembered; where neither has it, the wrapper's check
    raises naming the width."""
    main, width = _Lib(K._UNSUPPORTED_WIDTH), _Lib(0)
    monkeypatch.setattr(K, "_library", lambda: main)
    monkeypatch.setattr(K, "width_library", lambda w: width)
    monkeypatch.setattr(K, "_route", {})
    assert K._launch("vmn_mont_mul", (32, 8, None)) == 0
    assert K._launch("vmn_mont_mul", (32, 8, None)) == 0
    assert (main.calls, width.calls) == (1, 2)
    width.rc = K._UNSUPPORTED_WIDTH
    rc = K._launch("vmn_mont_mul", (32, 16, None))
    with pytest.raises(ValueError, match=r"no kernel instantiated for this "
                       r"width \(W=32\)"):
        K._check("mont_mul", rc, 32)


# ------------------------------------------- plain versions vs vmn_tpu


@pytest.fixture(scope="module", params=list(VOG))
def ctxs(request):
    from vmn_tpu.arith.mont import MontCtx as JCtx

    p = vog_pqg(request.param)[0]
    return JCtx(p), TCtx(p, device="cpu")


def _mont(jc, tc, xs):
    import jax.numpy as jnp

    arr = limbs_np(xs, tc.L)
    return jc.to_mont(jnp.asarray(arr)), tc.to_mont(device_limbs(arr, "cpu"))


def _exps(es, le):
    import jax.numpy as jnp

    arr = limbs_np(es, le)
    return jnp.asarray(arr), device_limbs(arr, "cpu")


def test_vog_plain_mul_exp_match_vmn_tpu(ctxs):
    """H1 on the edge values and four more; H2 at 64-bit exponents (0 and
    all ones among them), and the inversion's a^(m-2) at full width
    against Python pow."""
    jc, tc = ctxs
    assert tc.mod.W == 32 and tc.mod.conv == (tc.L == 63)
    rng = np.random.default_rng(tc.L)
    xs = edge_values(tc.m) + rand_ints(rng, 4, tc.m)
    ja, ta = _mont(jc, tc, xs)
    jb, tb = _mont(jc, tc, xs[::-1])
    assert np.array_equal(as_np(ta), as_np(ja))
    got = K.mont_mul_plain(ta, tb, tc.mod)
    assert np.array_equal(as_np(got), as_np(jc.mul(ja, jb)))
    es = [0, (1 << 64) - 1] + rand_ints(rng, len(xs) - 2, 1 << 64)
    je, te = _exps(es, 4)
    got = K.mont_exp_plain(ta, te, tc.mod, 64)
    assert np.array_equal(as_np(got), as_np(jc.exp(ja, je, 64)))
    inv_bits = (tc.m - 2).bit_length()
    e_inv = device_limbs(limbs_np([tc.m - 2], -(-inv_bits // 16)), "cpu")
    one = K.mont_exp_plain(ta[3:4], e_inv, tc.mod, inv_bits)
    assert tc.decode(one) == [pow(xs[3], tc.m - 2, tc.m)]


@pytest.mark.parametrize("window", [4, 8])
def test_vog_plain_fb_exp_matches_vmn_tpu(ctxs, window):
    jc, tc = ctxs
    rng = np.random.default_rng(tc.L + window)
    es = [0, (1 << 64) - 1] + rand_ints(rng, 4, 1 << 64)
    je, te = _exps(es, 4)
    table = tc.fixed_base_table(4, 64, window)
    assert np.array_equal(as_np(table),
                          as_np(jc.fixed_base_table(4, 64, window)))
    got = K.mont_fb_exp_plain(table, te, tc.mod)
    assert np.array_equal(as_np(got),
                          as_np(jc.fixed_base_exp(4, je, 64, window)))
    assert tc.decode(got) == [pow(4, e, tc.m) for e in es]


def test_vog_plain_expprod_matches_vmn_tpu(ctxs):
    """H4's positions and K7's combine (MontCtx.expprod) on seven bases
    with 64-bit exponents."""
    jc, tc = ctxs
    rng = np.random.default_rng(tc.L + 3)
    xs = [1, tc.m - 1] + rand_ints(rng, 5, tc.m)
    es = [(1 << 64) - 1, 0] + rand_ints(rng, 5, 1 << 64)
    ja, ta = _mont(jc, tc, xs)
    je, te = _exps(es, 4)
    P = K.mont_expprod_positions_plain(ta, te, tc.mod, 64)
    got = K.mont_expprod_combine_plain(P, tc.mod)
    assert np.array_equal(as_np(got), as_np(tc.expprod(ta, te, 64)))
    assert np.array_equal(as_np(got), as_np(jc.expprod(ja, je, 64)))
    want = 1
    for x, e in zip(xs, es):
        want = want * pow(x, e, tc.m) % tc.m
    assert tc.decode(got[None]) == [want]


def test_fb_exp4_plain_matches_vmn_tpu_at_w96():
    """H3 at window 4 at W = 96 (modp3072), the fixed-base powers of a
    group with a short q: 64-bit exponents."""
    from vmn_tpu.arith.mont import MontCtx as JCtx

    m = modulus("modp3072")
    jc, tc = JCtx(m), TCtx(m, device="cpu")
    rng = np.random.default_rng(96)
    es = [0, (1 << 64) - 1] + rand_ints(rng, 3, 1 << 64)
    je, te = _exps(es, 4)
    table = tc.fixed_base_table(4, 64, 4)
    assert table.shape == (16, 16, 192)
    got = K.mont_fb_exp_plain(table, te, tc.mod)
    assert np.array_equal(as_np(got),
                          as_np(jc.fixed_base_exp(4, je, 64, 4)))


# ---------------------------------------------- on the card (skipped here)


def _vog_ctx(name, device):
    return TCtx(vog_pqg(name)[0], device)


def _case(kernel, tc, n, bits, window, device):
    """(kernel output, plain output) on n elements of tc's modulus."""
    rng = np.random.default_rng(n + tc.L + window)
    xs = (edge_values(tc.m)[1:] + rand_ints(rng, n, tc.m))[:n]
    base = tc.encode(xs)
    es = ([(1 << bits) - 1, 0] + rand_ints(rng, n, 1 << bits))[:n]
    e = device_limbs(limbs_np(es, -(-bits // 16)), device)
    if kernel == "mont_mul":
        other = tc.encode(rand_ints(rng, n, tc.m))
        return (K.mont_mul(base, other, tc.mod),
                K.mont_mul_plain(base, other, tc.mod))
    if kernel == "mont_exp":
        return (K.mont_exp(base, e, tc.mod, bits),
                K.mont_exp_plain(base, e, tc.mod, bits))
    if kernel == "mont_fb_exp":
        table = tc.fixed_base_table(5, bits, window)
        return (K.mont_fb_exp(table, e, tc.mod),
                K.mont_fb_exp_plain(table, e, tc.mod))
    if kernel == "mont_expprod_positions":
        return (K.mont_expprod_positions(base, e, tc.mod, bits),
                K.mont_expprod_positions_plain(base, e, tc.mod, bits))
    P = tc.encode(rand_ints(rng, K._ndig_pad(bits), tc.m))
    return (K.mont_expprod_combine(P, tc.mod),
            K.mont_expprod_combine_plain(P, tc.mod))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 1000])
@pytest.mark.parametrize("kernel,name,tpi", [
    (k, g, t) for k in K.COOP_MONT for g in VOG
    for t in sorted({t for _, t in K.coop_rule(k, 32)})])
def test_cuda_vog_kernel_matches_plain(kernel, name, tpi, n, cuda_device,
                                       monkeypatch):
    """Each Montgomery kernel at W = 32 (vog1000: W' = 32, converting) at
    each TPI of its rule (forced through it), full-width exponents, H3 at
    both windows, against its plain version; then K7's combine.  The
    width's library is built (at its first use) before the rule is
    forced, so that it holds every TPI of the rule."""
    K.width_library(32)
    monkeypatch.setitem(K.COOP_TPI, (kernel, 32), ((1, tpi),))
    tc = _vog_ctx(name, cuda_device)
    for window in ((4, 8) if kernel == "mont_fb_exp" else (8,)):
        got, want = _case(kernel, tc, n, tc.nbits - 1, window, cuda_device)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    got, want = _case("combine", tc, n, tc.nbits - 1, 8, cuda_device)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("curve", ["P-224", "P-384", "P-521"])
@pytest.mark.parametrize("kernel", ["mont_fb_exp", "mont_expprod_positions",
                                    "combine"])
def test_cuda_curve_field_kernel_matches_plain(kernel, curve, cuda_device):
    """H3 (window 4), H4 and K7's combine at the curves' fields, on no
    curve's path: P-224 at W' = 8 converting (the P-256 instantiations),
    P-384 at W = 12 and P-521 at W' = 20 converting, from the width's
    own library."""
    from vmn_tpu_torch.arith.ec import ECqPGroup

    tc = ECqPGroup.named(curve, device=cuda_device).ctx
    got, want = _case(kernel, tc, 300, tc.nbits, 4, cuda_device)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["modp3072", "modp4096"])
def test_cuda_wide_fb_exp4_matches_plain(name, cuda_device):
    """H3 at window 4 at W = 96 and 128, 256-bit exponents."""
    tc = TCtx(modulus(name), cuda_device)
    got, want = _case("mont_fb_exp", tc, 1000, 256, 4, cuda_device)
    torch.cuda.synchronize()
    assert torch.equal(got, want)

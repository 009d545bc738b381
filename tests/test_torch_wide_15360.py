"""The port past 8192 bits: the 15360-bit group ffc15360 (NIST SP 800-57
Part 1 Rev. 5, Table 2: finite-field cryptography at 256-bit strength;
W = 480 words, L = 960 limbs) and the cap of 512 words (W = 512, 16384
bits), the kernels' widths built on demand.

On the CPU, against `vmn_tpu` and Python integers:

* each plain version of a kernel on the ffc15360 path against
  `vmn_tpu.arith.mont.MontCtx` (its XLA path on the CPU) at L = 960: H1
  `mont_mul`, H2 `mont_exp` (64-bit exponents), H3 `mont_fb_exp` at
  window 8 (eight digits), H4 `mont_expprod_positions` with K7's combine
  through `MontCtx.expprod` (seven elements);
* `kernel_words` / `Modulus.of` at 15360 and 16384 bits (W = 480 and
  512, no conversion) and the cap: 16416 bits (L = 1026) raise off the
  CPU, naming 512 words;
* the launch rules at W = 480 and 512: each `COOP_TPI` rule and the TPI
  masks its width library is built with (csrc/mont_kernels.cu, VMN_W);
  H3's and H4's blocks of at most 512 threads there (`block_cap`, held
  to csrc/mont_coop.cuh); H3's pieces (eighths of a window-8 digit) and
  its packed table read piece by piece as the kernel reads it; H4's
  launch shape over N in {1, 16, 1000};
* the group files tests/golden/group_ffc15360.json and its 1024-bit
  stand-in group_ffc1024.json: p of 15360 (1024) bits, p - 1 = c·q with
  c even below 2^32, g = h^c mod p != 1 (primality is not run again
  here: one Python pow at 15360 bits takes seconds;
  tests/torch_make_wide_golden.py confirmed p and q with `vmn_tpu`'s
  miller_rabin);
* the slice as a whole at ffc1024, the same shape at 1024 bits: the
  port's k=1 golden mix (tools/make_golden.py's seeds, five messages
  from `random_array`, as the fixture script makes them: a c > 2 group
  checks membership by x^q) rewrites `vmn_tpu`'s transcript byte for
  byte (so `vmn_tpu`'s verifier, which accepted those bytes when the
  fixture was written, accepts the port's), and the port's verifier
  accepts `vmn_tpu`'s with its test vectors.

On a CUDA device only (skipped here): each kernel at W = 480 and 512
against its plain version, at 256-bit exponents and on one element at
full width, K7's combine over a full-width exponent's positions, and
the port's verifier on `vmn_tpu`'s ffc15360 golden transcript (on the
CPU it would take far too long).

Inputs are seeded numpy bytes handed to both packages.  Tolerance: exact
equality of limbs and bytes (integer arithmetic).
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_kernels import _ep_visits
from torch_port_util import (  # noqa: F401 (cuda_device: fixture)
    GOLDEN, TV_NAMES, as_np, assert_same_transcript, cuda_device,
    edge_values, group_file, group_pqg, limbs_np, rand_ints,
)
from vmn_tpu_torch.arith.mont import MontCtx as TCtx, device_limbs
from vmn_tpu_torch.kernel_timing import wide_modulus
from vmn_tpu_torch.ops import mont_kernels as K

GROUP = "ffc15360"
SMALL = "ffc1024"  # the same shape at 1024 bits, for the CPU
BITS = {GROUP: (15360, 15328), SMALL: (1024, 992)}
WIDTHS = (480, 512)
CSRC = Path(K.__file__).resolve().parent.parent / "csrc"
KERNELS = ("mont_mul", "mont_exp", "mont_fb_exp", "mont_expprod_positions")


def _modulus(w: int) -> int:
    """ffc15360's p at W = 480, the 16384-bit odd modulus at W = 512."""
    return group_pqg(GROUP)[0] if w == 480 else wide_modulus(32 * w)


@pytest.fixture(scope="module")
def ctxs():
    from vmn_tpu.arith.mont import MontCtx as JCtx

    m = _modulus(480)
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
    assert tc.L == 960
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
    """H3 at window 8 (the path's fixed-base powers) over eight digits:
    the port's table equals vmn_tpu's, and so do the powers."""
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


@pytest.mark.parametrize("w", WIDTHS)
def test_modulus_at_widths_past_256_words(w):
    """15360 and 16384 bits: L/2 words, no boundary conversion, off the
    CPU too (a meta device stands in for the card)."""
    m, L = _modulus(w), 2 * w
    assert m.bit_length() == 32 * w and m % 2 == 1
    assert K.kernel_words(L) == w
    mod = K.Modulus.of(m, L, torch.device("meta"))
    assert mod.W == w and not mod.conv and mod.c_in is None
    assert K.Modulus.of(m, L, "cpu").W == w


def test_modulus_cap_of_512_words():
    """Above 512 words no kernel is built: 16416 bits (L = 1026) raise off
    the CPU, naming the cap of 512 words (16384 bits); the plain versions
    on the CPU take it at 513 words."""
    m = (1 << 16415) + 1
    with pytest.raises(ValueError, match=r"cap of 512 words \(16384 bits\)"):
        K.Modulus.of(m, 1026, torch.device("meta"))
    with pytest.raises(ValueError, match="cap of 512 words"):
        K.kernel_words(1026)
    assert K.Modulus.of(m, 1026, "cpu").W == 513
    assert K.MAX_WORDS == 512


# ------------------------------------------------------- the launch rules


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_coop_rule_rows_and_tpi_masks(kernel, w):
    """Each rule at W = 480 and 512 is a row of COOP_TPI, names TPIs that
    divide W, fit a warp and leave a lane at most 16 words; the width's
    library is built with exactly those TPIs (bit t of the kernel's
    mask), which the .cu's at_tpi launches where t divides VMN_W."""
    assert w not in K._WIDTHS  # built on demand
    rule = K.COOP_TPI[kernel, w]
    assert rule == K.coop_rule(kernel, w) == ((1, 32),)
    tpis = {t for _, t in rule}
    for t in tpis:
        assert t & (t - 1) == 0 and t <= 32 and w % t == 0
        assert w // t <= 16
    assert set(K.width_tpis(w)[kernel]) == tpis
    flags = K._width_flags(w, K.width_tpis(w))
    mask = K.COOP_MONT[kernel]
    assert f"-D{mask}={sum(tpis)}" in flags and f"-DVMN_W={w}" in flags
    src = (CSRC / "mont_kernels.cu").read_text()
    assert f"at_tpi<{mask}>" in src
    assert "(kMask & T) != 0 && VMN_W % T == 0" in src


def test_coop_rule_between_256_and_512_words():
    """A width between the measured rows (e.g. 9216 bits: W = 288) takes
    the rule of the nearest width above it with one: TPI 32."""
    for L, w in ((576, 288), (800, 416), (1022, 512)):
        assert K.kernel_words(L) == w
        for kernel in KERNELS:
            assert K.coop_rule(kernel, w) == ((1, 32),)


def test_block_cap_mirrors_the_kernel():
    """H3's and H4's threads a block at most: 1024 up to 256 words, 512
    above (csrc/mont_coop.cuh's block_cap), used by both kernels'
    __launch_bounds__ and their launch checks, and by fb_launch and
    ep_launch."""
    coop = (CSRC / "mont_coop.cuh").read_text()
    assert "constexpr int kFbBlock = 1024;" in coop
    assert "constexpr int kWideBlock = 512;" in coop
    assert "return W <= 256 ? kFbBlock : kWideBlock;" in coop
    src = (CSRC / "mont_kernels.cu").read_text()
    assert src.count("__launch_bounds__(vmn::block_cap<W>(), 1)") == 2
    assert src.count("vmn::block_cap<W>()) ||") == 2
    assert (K.FB_BLOCK, K.WIDE_BLOCK) == (1024, 512)
    assert [K.block_cap(w) for w in (8, 64, 256, 288, 480, 512)] == [
        1024, 1024, 1024, 512, 512, 512]
    for w in WIDTHS:
        for n in (1, 16, 1000, 10000):
            tpi, threads, blocks = K.fb_launch(w, n, 132)
            assert tpi == 32 and threads % 32 == 0
            assert 0 < threads <= 512 and threads * blocks >= n * tpi


def test_fb_pieces_in_eighths():
    """H3's window-8 digit in eighths at W = 480 and 512: two 60 KB (64 KB)
    buffers fit the 227 KB a block may use, two quarters would not;
    window 4 whole."""
    assert K.FB_SHARED == 232448
    for w, stage in ((480, 61440), (512, 65536)):
        assert K.fb_pieces(w, 8) == 8 and K.fb_pieces(w, 4) == 1
        assert 4 * 256 * w // 8 == stage
        assert 2 * stage <= K.FB_SHARED < 4 * stage


@pytest.mark.parametrize("w", WIDTHS)
def test_fb_pack_read_piece_by_piece(w):
    """H3's packed table at W = 480 (S = 15 words a lane, V = 1) and 512
    (S = 16, V = 4), window 8, read as its kernel reads an eighth digit:
    piece u = j·8 + p is words u·32·W .. of the packed table, and lane r
    takes vector kk of its entry d at d·W + kk·TPI·V + r·V in the piece,
    which must hold words r·S + kk·V .. of entry p·32 + d of digit j."""
    tpi, window = 32, 8
    pieces = K.fb_pieces(w, window)
    per = (1 << window) // pieces
    rng = np.random.default_rng(w)
    ndig = 1
    table = torch.from_numpy(rng.integers(0, 1 << 16, (ndig, 1 << window,
                                                       2 * w),
                                          dtype=np.int64).astype(np.int32))
    packed = K.fb_pack(table, tpi).numpy().view(np.uint32).reshape(
        ndig * pieces, per * w)
    words = (table[..., 0::2].numpy().astype(np.uint32)
             | (table[..., 1::2].numpy().astype(np.uint32) << 16))
    S = w // tpi
    V = K.slice_vec(S)
    assert (S, V) == ((15, 1) if w == 480 else (16, 4))
    for u in range(ndig * pieces):
        j, p = divmod(u, pieces)
        for d in (0, 1, per - 1):
            for r in (0, 1, tpi - 1):
                got = [packed[u, d * w + kk * tpi * V + r * V + v]
                       for kk in range(S // V) for v in range(V)]
                assert got == list(words[j, p * per + d, r * S:(r + 1) * S])


@pytest.mark.parametrize("w", WIDTHS)
def test_ep_launch_past_256_words(w):
    """H4's launch at W = 480 and 512 over N in {1, 16, 1000} at the
    ffc15360 path's position counts (the co-order's 32 bits, 64, 256,
    |q| = 15328 and a full width): at least one element a chunk, the
    tables and accumulators within a block's shared memory, whole warps
    of at most 512 threads; every (element, position) pair folded once
    where the walk is small."""
    for n in (1, 16, 1000):
        for bits in (32, 64, 256, 32 * w - 32, 32 * w - 1):
            npos = K._ndig_pad(bits)
            sh = K.ep_launch(w, n, npos, 132)
            assert sh.tpi == 32 and sh.chunk >= 1
            assert sh.shared_bytes(w) <= K.EP_SHARED
            assert 4 * w * sh.jb * sh.subs <= K.EP_ACC_BYTES
            assert sh.threads % 32 == 0 and 0 < sh.threads <= K.block_cap(w)
            assert sh.jb * sh.pblocks == npos and sh.jb % K.EP_JB == 0
            assert (sh.eblocks - 1) * sh.per_block < n <= (
                sh.eblocks * sh.per_block)
            if n * npos <= 1 << 16:
                count, part = _ep_visits(w, n, npos, sh)
                assert (count == 1).all()
                assert part.min() >= 0 and part.max() < sh.parts


# ------------------------------------------------------------ the group


@pytest.mark.parametrize("name", list(BITS))
def test_group_file(name):
    """p has 15360 (1024) bits, p - 1 = c·q with c even below 2^32
    (vmn_tpu's 64-bit co-order exponent takes it), g = h^c mod p != 1
    for the smallest such h; the seed and the source are recorded."""
    f = group_file(name)
    p, q, g, c, h = f["p"], f["q"], f["g"], int(f["c"], 16), int(f["h"], 16)
    pbits, qbits = BITS[name]
    assert p.bit_length() == f["bits"] == pbits
    assert p - 1 == c * q and c % 2 == 0 and c < 1 << 32
    assert q.bit_length() == qbits and q % 2 == 1
    assert g == pow(h, c, p) != 1 and h >= 2
    assert all(pow(x, c, p) == 1 for x in range(2, h))
    assert f["seed"] == name
    assert "NIST SP 800-57" in group_file(GROUP)["source"]


# ------------------------------------ the slice as a whole, at 1024 bits


def _params(name, device="cpu"):
    from vmn_tpu_torch.arith.pgroup import ModPGroup
    from vmn_tpu_torch.protocol.context import ProtocolParams

    return ProtocolParams(sid="Golden", k=1, threshold=1,
                          pgroup=ModPGroup(*group_pqg(name), device=device))


@pytest.fixture(scope="module")
def port_mix(tmp_path_factory):
    """The port's golden mix on the CPU over ffc1024, as the fixture
    script makes vmn_tpu's: (nizkp dir, messages, plaintexts)."""
    from vmn_tpu_torch.crypto.hash import SHA256
    from vmn_tpu_torch.crypto.prg import PRGHeuristic
    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.protocol import elgamal
    from vmn_tpu_torch.protocol.com.board import LocalBoardHub
    from vmn_tpu_torch.protocol.mixnet.party import MixNetParty

    params = _params(SMALL)
    group = params.pgroup
    out = tmp_path_factory.mktemp("port_golden_ffc1024")
    party = MixNetParty(params, LocalBoardHub(1).board(1),
                        SeededSource(b"golden-party"), str(out))
    pk = party.keygen()
    prg = PRGHeuristic(SHA256)
    prg.set_seed(SHA256.hash(b"golden-msgs"))
    m = group.random_array(5, prg, params.rbitlen)
    r = group.ring.random((5,), SeededSource(b"golden-ciphs"), 0)
    ciphs = elgamal.encrypt(pk, m, r)
    party.board = LocalBoardHub(1).board(1)
    plain = party.session("golden", 1).mix(ciphs)
    return out / "nizkp.golden", m.to_ints(), plain.to_ints()


def test_port_rewrites_ffc1024_golden(port_mix):
    nizkp, msgs, plain = port_mix
    assert sorted(plain) == sorted(msgs)
    assert_same_transcript(nizkp, GOLDEN / f"nizkp_{SMALL}_k1")


def test_port_verifier_accepts_vmn_tpu_ffc1024_golden():
    from vmn_tpu_torch.protocol.mixnet.verifier import FiatShamirVerifier

    v = FiatShamirVerifier(_params(SMALL), GOLDEN / f"nizkp_{SMALL}_k1",
                           test_vectors=TV_NAMES)
    res = v.verify(expected_type="mixing")
    assert res.ok and res.shuffle_ok and res.decrypt_ok
    assert v.tv == json.loads(
        (GOLDEN / f"test_vectors_{SMALL}.json").read_text())



# ---------------------------------------------- on the card (skipped here)


def _case(kernel, w, n, device, window=8, bits=256):
    """(kernel call, plain call) at W on n elements and `bits`-bit
    exponents; the plain version on the card, or on host copies for one
    element (its integer route there: a full-width power's thousands of
    dependent products are seconds of torch launches on the card).  The
    inputs are made first (encoding launches H1)."""
    m = _modulus(w)
    tc, hc = TCtx(m, device), TCtx(m, "cpu")
    rng = np.random.default_rng(n + w + bits)
    xs = (edge_values(m)[1:] + rand_ints(rng, n, m))[:n]
    es = ([(1 << bits) - 1, 0] + rand_ints(rng, n, 1 << bits))[:n]
    e = device_limbs(limbs_np(es, -(-bits // 16)), device)
    if kernel == "mont_mul":
        args = (tc.encode(xs), tc.encode(rand_ints(rng, n, m)), tc.mod)
    elif kernel == "mont_fb_exp":
        args = (tc.fixed_base_table(5, bits, window), e, tc.mod)
    else:
        args = (tc.encode(xs), e, tc.mod, bits)
    if n == 1:
        args_plain = tuple(hc.mod if a is tc.mod else a.cpu()
                           if torch.is_tensor(a) else a for a in args)
    else:
        args_plain = args
    return (lambda: getattr(K, kernel)(*args),
            lambda: getattr(K, kernel + "_plain")(*args_plain))


@pytest.mark.cuda
@pytest.mark.parametrize("n,bits", [(1, 256), (37, 256), (300, 256),
                                    (1, None)])
@pytest.mark.parametrize("kernel,window", [
    (k, wb) for k in KERNELS for wb in ((8, 4) if k == "mont_fb_exp"
                                        else (8,))])
@pytest.mark.parametrize("w", WIDTHS)
def test_cuda_kernel_matches_plain(w, kernel, window, n, bits, cuda_device):
    """Each kernel at W = 480 and 512 (TPI 32, its one rule) against its
    plain version: 256-bit exponents on 1, 37 and 300 elements, and one
    element at full width (H3 at window 8: the path's table)."""
    if bits is None and (kernel, window) == ("mont_fb_exp", 4):
        pytest.skip("window 4 takes 256-bit exponents (a short q) only")
    K.width_library(w)
    run, plain = _case(kernel, w, n, cuda_device, window,
                       bits or 32 * w - 1)
    K.reset_launches()
    got = run()
    assert K.LAUNCHES[kernel] == 1
    want = plain()
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("w", WIDTHS)
def test_cuda_combine_matches_plain(w, cuda_device):
    """K7's combine over a full-width exponent's positions (3840, 4096)."""
    m = _modulus(w)
    tc, hc = TCtx(m, cuda_device), TCtx(m, "cpu")
    npos = K._ndig_pad(tc.nbits - 1)
    assert npos == 8 * w
    xs = rand_ints(np.random.default_rng(npos), npos, m)
    got = K.mont_expprod_combine(tc.encode(xs), tc.mod)
    want = K.mont_expprod_combine_plain(hc.encode(xs), hc.mod)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_port_verifier_accepts_vmn_tpu_ffc15360_golden(tmp_path,
                                                            cuda_device):
    """The port's verifier on the card accepts vmn_tpu's ffc15360 golden
    with its test vectors, and rejects it with the full public key's
    generator g changed to g^2 (another element of the subgroup), which
    the verifier compares with the group's before any proof."""
    from vmn_tpu_torch.arith.pgroup import ModPGroup
    from vmn_tpu_torch.protocol.context import ProtocolParams
    from vmn_tpu_torch.protocol.mixnet.verifier import (
        FiatShamirVerifier, VerificationError,
    )

    p, q, g = group_pqg(GROUP)
    params = ProtocolParams(sid="Golden", k=1, threshold=1,
                            pgroup=ModPGroup(p, q, g, device=cuda_device))
    golden = GOLDEN / f"nizkp_{GROUP}_k1"
    v = FiatShamirVerifier(params, golden, test_vectors=TV_NAMES)
    res = v.verify(expected_type="mixing")
    assert res.ok and res.shuffle_ok and res.decrypt_ok
    want = json.loads((GOLDEN / f"test_vectors_{GROUP}.json").read_text())
    assert v.tv == want
    bad = tmp_path / "nizkp"
    shutil.copytree(golden, bad)
    fpk = bad / "FullPublicKey.bt"
    raw = fpk.read_bytes()
    n = (p.bit_length() + 7) // 8
    old = g.to_bytes(n, "big")
    assert raw.count(old) == 1
    fpk.write_bytes(raw.replace(old, (g * g % p).to_bytes(n, "big")))
    with pytest.raises(VerificationError, match="standard generator"):
        FiatShamirVerifier(params, bad).verify(expected_type="mixing")

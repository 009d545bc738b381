"""The port at the wide RFC 3526 groups, modp3072 (W = 96 words, L = 192
limbs) and modp4096 (W = 128, L = 256), against `vmn_tpu` on the CPU.

* Each plain version of a kernel on this width's path against
  `vmn_tpu.arith.mont.MontCtx` (its XLA path on the CPU) on the same
  named group: H1 `mont_mul`, H2 `mont_exp` (64-bit exponents, and one
  element at full width against Python `pow`), H3 `mont_fb_exp` at
  window 8, H4 `mont_expprod_positions` with K7's combine through
  `MontCtx.expprod`.
* The carry-across of limbs (`vmn_tpu_torch/interop.py`).
* The launch shapes, in pure Python: each `COOP_TPI` rule at these
  widths names TPIs that divide W and have a case in
  csrc/mont_kernels.cu, H3's staged bytes fit a block's shared memory.
* The slice: the port's verifier accepts the modp3072 golden transcript
  that `vmn_tpu` wrote (tests/torch_make_wide_golden.py), writes its
  test vectors, and rejects it with one flipped byte
  (tests/test_torch_wide_4096.py does the same at modp4096).
* On a CUDA device only: each kernel at these widths against its plain
  version at every TPI of its rule.

Inputs are seeded numpy bytes handed to both packages.  Tolerance: exact
equality of limbs and bytes (integer arithmetic).
"""

import json
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401 (cuda_device: fixture)
    TV_NAMES, as_np, cuda_device, edge_values, group_pqg, limbs_np, modulus,
    rand_ints,
)
from vmn_tpu_torch import interop
from vmn_tpu_torch.arith.mont import MontCtx as TCtx, device_limbs
from vmn_tpu_torch.ops import mont_kernels as K

WIDE = {"modp3072": 96, "modp4096": 128}
GOLDEN = Path(__file__).parent / "golden"
CSRC = Path(K.__file__).resolve().parent.parent / "csrc" / "mont_kernels.cu"


@pytest.fixture(scope="module", params=list(WIDE))
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


def test_mont_mul_plain_matches_vmn_tpu(ctxs):
    jc, tc = ctxs
    assert tc.L == 2 * WIDE[{192: "modp3072", 256: "modp4096"}[tc.L]]
    rng = np.random.default_rng(tc.L)
    xs = edge_values(tc.m) + rand_ints(rng, 4, tc.m)
    ys = xs[::-1]
    ja, ta = _mont(jc, tc, xs)
    jb, tb = _mont(jc, tc, ys)
    assert np.array_equal(as_np(ta), as_np(ja))
    got = K.mont_mul_plain(ta, tb, tc.mod)
    assert np.array_equal(as_np(got), as_np(jc.mul(ja, jb)))
    assert tc.decode(got) == [x * y % tc.m for x, y in zip(xs, ys)]


def test_mont_exp_plain_matches_vmn_tpu(ctxs):
    """64-bit exponents (0 and all ones among them) on six elements, and
    the inversion's power a^(m-2) on one element at full width."""
    jc, tc = ctxs
    rng = np.random.default_rng(tc.L + 1)
    xs = [2, tc.m - 1] + rand_ints(rng, 4, tc.m)
    es = [0, (1 << 64) - 1] + rand_ints(rng, 4, 1 << 64)
    ja, ta = _mont(jc, tc, xs)
    je, te = _exps(es, 4)
    got = K.mont_exp_plain(ta, te, tc.mod, 64)
    assert np.array_equal(as_np(got), as_np(jc.exp(ja, je, 64)))
    assert tc.decode(got) == [pow(x, e, tc.m) for x, e in zip(xs, es)]
    inv_bits = (tc.m - 2).bit_length()
    e_inv = device_limbs(limbs_np([tc.m - 2], -(-inv_bits // 16)), "cpu")
    one = K.mont_exp_plain(ta[2:3], e_inv, tc.mod, inv_bits)
    assert tc.decode(one) == [pow(xs[2], tc.m - 2, tc.m)]


def test_mont_fb_exp_plain_matches_vmn_tpu(ctxs):
    """H3 at window 8 (the wide paths' fixed-base powers): the port's
    table equals vmn_tpu's, and so do the powers."""
    jc, tc = ctxs
    rng = np.random.default_rng(tc.L + 2)
    es = [0, (1 << 64) - 1] + rand_ints(rng, 5, 1 << 64)
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
    with 64-bit exponents."""
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


@pytest.mark.parametrize("name", list(WIDE))
def test_interop_round_trips_wide(name):
    """vmn_tpu's Montgomery limbs of a wide group into the port and back."""
    from vmn_tpu.arith.pgroup import ModPGroup as JG
    from vmn_tpu_torch.arith.pgroup import ModPGroup as TG

    jg, tg = JG.named(name), TG.named(name, device="cpu")
    assert tg.L == 2 * WIDE[name]
    xs = rand_ints(np.random.default_rng(len(name)), 4, tg.p)
    raw = np.asarray(jg.from_ints(xs).limbs)
    assert np.array_equal(interop.limbs_to_numpy(
        interop.limbs_from_numpy(raw, device="cpu")), raw)
    ga = interop.garray_from_numpy(tg, raw)
    assert ga.to_ints() == [x % tg.p for x in xs]
    assert np.array_equal(interop.limbs_to_numpy(ga.limbs), raw)


def _cases(fn: str, src: str) -> set:
    """The (W, [window,] TPI) of every `case` of entry point fn."""
    body = re.search(rf"int {fn}\(.*?\n\}}", src, re.S).group(0)
    out = set()
    for key in re.findall(r"case ([^:]+):", body):
        parts = [int(re.match(r"\d+", p.strip()).group(0))
                 for p in key.split("|")]
        out.add(tuple(parts))
    return out


ENTRY = {"mont_mul": "vmn_mont_mul", "mont_exp": "vmn_mont_exp",
         "mont_fb_exp": "vmn_mont_fb_exp",
         "mont_expprod_positions": "vmn_mont_expprod"}


@pytest.mark.parametrize("w", sorted(WIDE.values()))
@pytest.mark.parametrize("kernel", list(ENTRY))
def test_coop_rule_names_built_tpis(kernel, w):
    """Each TPI of the kernel's COOP_TPI rule at W = 96 and 128 divides W,
    fits a warp, and has its case in the entry point's switch (H3 at
    window 8, the window of the wide paths, and at window 4, a group
    with a short q); these widths are the main library's (K._WIDTHS)."""
    assert w in K._WIDTHS
    src = CSRC.read_text()
    cases = _cases(ENTRY[kernel], src)
    rule = K.COOP_TPI[kernel, w]
    assert rule[-1][0] == 1
    for _, tpi in rule:
        assert w % tpi == 0 and 32 % tpi == 0
        keys = ([(w, 8, tpi), (w, 4, tpi)] if kernel == "mont_fb_exp"
                else [(w, tpi)])
        for key in keys:
            assert key in cases, (kernel, key)
    assert f"case {w}: return launch_chain<{w}>" in src  # K7's combine


@pytest.mark.parametrize("w", sorted(WIDE.values()))
def test_fb_stage_fits_a_block(w):
    """H3 stages two buffers of a digit's entries, or of half of them
    where two digits pass the 227 KB a block may use (window 8 at
    W = 128): every (W, window, TPI) the wrapper can choose fits, and
    W = 96 keeps whole digits (192 KB)."""
    for window in (4, 8):
        digit = 4 * (1 << window) * w
        pieces = 1 if 2 * digit <= K.FB_SHARED else 2
        assert 2 * digit // pieces <= K.FB_SHARED
        assert pieces == (2 if (w, window) == (128, 8) else 1)
        for _, tpi in K.COOP_TPI["mont_fb_exp", w]:
            s = w // tpi
            # a lane's vectors stay whole inside a piece
            assert (digit // pieces // 4) % (tpi * K.slice_vec(s)) == 0
    assert 2 * 4 * 256 * 96 == 196608 <= K.FB_SHARED


# ------------------------------------------------------------- the slice


def _params(name, device="cpu"):
    """The golden's parameters over a named RFC 3526 group or a group
    file's (modp6144, modp8192: `group_file`)."""
    from vmn_tpu_torch.arith.pgroup import _NAMED_GROUPS, ModPGroup
    from vmn_tpu_torch.protocol.context import ProtocolParams

    group = (ModPGroup.named(name, device=device) if name in _NAMED_GROUPS
             else ModPGroup(*group_pqg(name), device=device))
    return ProtocolParams(sid="Golden", k=1, threshold=1, pgroup=group)


def verify_wide_golden(name, tmp_path, device="cpu"):
    """The port's verifier on vmn_tpu's golden transcript of `name`:
    accepted, with vmn_tpu's test vectors; then rejected with one byte
    of the full public key's generator changed, g = 4 -> 9 (another
    element of the subgroup), which the verifier reads and compares
    with the group's generator before any proof."""
    from vmn_tpu_torch.protocol.mixnet.verifier import (
        FiatShamirVerifier, VerificationError,
    )

    golden = GOLDEN / f"nizkp_{name}_k1"
    v = FiatShamirVerifier(_params(name, device), golden,
                           test_vectors=TV_NAMES)
    res = v.verify(expected_type="mixing")
    assert res.ok and res.shuffle_ok and res.decrypt_ok
    want = json.loads((GOLDEN / f"test_vectors_{name}.json").read_text())
    assert v.tv == want
    bad = tmp_path / "nizkp"
    shutil.copytree(golden, bad)
    fpk = bad / "FullPublicKey.bt"
    raw = bytearray(fpk.read_bytes())
    bytelen = (modulus(name).bit_length() + 7) // 8
    at = bytes(raw).index(bytes(bytelen - 1) + b"\x04") + bytelen - 1
    raw[at] = 0x09
    fpk.write_bytes(bytes(raw))
    with pytest.raises(VerificationError, match="standard generator"):
        FiatShamirVerifier(_params(name, device), bad).verify(
            expected_type="mixing")


def test_port_verifier_accepts_vmn_tpu_modp3072_golden(tmp_path):
    verify_wide_golden("modp3072", tmp_path)


# ---------------------------------------------- on the card (skipped here)


def _wide_case(kernel, name, n, device, window=8):
    """(kernel call, plain call) at a wide group on n elements: 256-bit
    exponents, H3 at window 8 on full-width ones and at window 4 on
    256-bit ones; the inputs are made first (encoding launches H1)."""
    tc = TCtx(modulus(name), device)
    rng = np.random.default_rng(n + tc.L)
    xs = (edge_values(tc.m)[1:] + rand_ints(rng, n, tc.m))[:n]
    base = tc.encode(xs)
    bits = tc.nbits - 1 if (kernel, window) == ("mont_fb_exp", 8) else 256
    es = ([(1 << bits) - 1, 0] + rand_ints(rng, n, 1 << bits))[:n]
    e = device_limbs(limbs_np(es, -(-bits // 16)), device)
    if kernel == "mont_mul":
        args = (base, tc.encode(rand_ints(rng, n, tc.m)), tc.mod)
    elif kernel == "mont_fb_exp":
        args = (tc.fixed_base_table(5, bits, window), e, tc.mod)
    else:
        args = (base, e, tc.mod, bits)
    return (lambda: getattr(K, kernel)(*args),
            lambda: getattr(K, kernel + "_plain")(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 300])
@pytest.mark.parametrize("kernel,name,tpi", [
    (k, g, t) for k in ENTRY for g, w in WIDE.items()
    for t in sorted({t for _, t in K.COOP_TPI[k, w]})])
def test_cuda_wide_kernel_matches_plain(kernel, name, tpi, n, cuda_device,
                                        monkeypatch):
    """Each kernel at W = 96 and 128 at each TPI of its rule (forced
    through the rule), against its plain version."""
    monkeypatch.setitem(K.COOP_TPI, (kernel, WIDE[name]), ((1, tpi),))
    run, plain = _wide_case(kernel, name, n, cuda_device)
    K.reset_launches()
    got = run()
    assert K.LAUNCHES[kernel] == 1
    want = plain()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(WIDE))
def test_cuda_wide_combine_matches_plain(name, cuda_device):
    """K7's combine over a full-width exponent's positions (768, 1024)."""
    tc = TCtx(modulus(name), cuda_device)
    npos = K._ndig_pad(tc.nbits - 1)
    P = tc.encode(rand_ints(np.random.default_rng(npos), npos, tc.m))
    got = K.mont_expprod_combine(P, tc.mod)
    assert torch.equal(got, K.mont_expprod_combine_plain(P, tc.mod))

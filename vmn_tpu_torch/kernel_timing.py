"""Device times of the port's kernel wrappers on one CUDA card.

Usage (from any directory, on a machine with a card):

    python3 vmn_tpu_torch/kernel_timing.py [--tree DIR] [--n N] [--ec-n N]
    python3 vmn_tpu_torch/kernel_timing.py --sweep [--only WRAPPER ...]
                                           [--widths W ...] [--curve P-224]
    python3 vmn_tpu_torch/kernel_timing.py --prf [--tree DIR]
      (the ChaCha20 kernel of DIR alone: its `chacha20_limbs` keys; an
      A/B of two trees runs them in turns, each a process)

Without --sweep it times, with `device_ms`, the wrappers of the
`vmn_tpu_torch` package under DIR (default: the tree this file is in) on
inputs made on the card from fixed seeds:

* H1 `mont_mul` and H2 `mont_exp` at modp2048 (W = 64) on N elements
  (2047-bit exponents) and on one (a product; a^(m-2) as `MontCtx.inv`
  computes it), and the same at the P-256 field (W = 8) on --ec-n
  elements and on one (256-bit exponents);
* H3 `mont_fb_exp` at modp2048 on N elements: window 8 on 2047-bit
  exponents (the modp2048 path) and window 4 on 256-bit ones; at the
  P-256 field (W = 8) window 4 on 256-bit exponents (the width of the
  test256 golden) on N elements;
* H4 `mont_expprod_positions` at modp2048 at each (elements, exponent
  bits) the modp2048 path calls it with (`EP_WIDTHS`; N elements for
  its 10000), and at the P-256 field (W = 8, the test256 golden's width)
  on N elements, 256-bit exponents;
* K7's combine over 512 positions (a 2047-bit exponent's):
  `mont_expprod_combine` where the tree has it, else the loop of
  single-element H1 launches that `mont_expprod` ran before it had its
  own launch;
* H5 `ec_scalar_mul`, H6 `ec_multiexp_positions`, H7 `ec_fb_exp` (on g)
  and H8 `ec_point_add` at P-256 on 4096 and on --ec-n points, H8 also
  on one pair and, at --ec-n, H8's and H6's kernels alone (without H6's
  H8 lane tree): the device time of the launches whose name holds
  `ec_add_kernel` or `ec_mexp_kernel`, from torch.profiler; at --ec-n H6
  also at 100- and (below the curve's own) 256-bit scalars, the widths
  beside the full one at which the EC paths' mixes and verifies call it
  (chip_smoke.py's `[multiexp]` lines count those calls; `_{bits}`
  keys);
* the EC position combine over 64 positions (a 256-bit
  multi-exponentiation): `ec_multiexp_combine` where the tree has it,
  else the loop of single-point H8 launches that `ec_multiexp` ran
  before it had its own launch;
* at each wider width the tree instantiates (its `_WIDTHS`: modp3072,
  W = 96, and modp4096, W = 128, from the wide-group slice on), the same
  as at modp2048 with exponents of |q| bits in place of 2047 (the
  combine over 768 and 1024 positions), H3 at window 8 only (`_w96`,
  `_w128` keys);
* where the tree instantiates W = 12 (the P-384 slice on): H1 and H2 at
  the P-384 field on --ec-n elements and on one (384-bit exponents,
  `_w12` keys), and H5-H8 and the EC combine at P-384 on --ec-n points
  (`_p384` keys, the combine over 96 positions);
* where the tree instantiates P-521's inner width (W' = 20: its L = 33
  limbs padded, converted at the kernels' boundary): H1 and H2 at the
  P-521 field (521-bit exponents, `_w20` keys), and H5, H6, H8 and the
  EC combine at P-521 on --ec-n points (`_p521` keys, the combine over
  144 positions; no H7);
* where the tree maps P-224 (L = 14 limbs) to the inner width W' = 8
  (the P-256 instantiations, converted at the kernels' boundary): H1 and
  H2 at the P-224 field and ring (224-bit exponents, `_p224` and
  `_p224_ring` keys), and H5, H6, H8 and the EC combine at P-224 on
  --ec-n points (`_p224` keys, the combine over 64 positions; no H7);
* where the tree has the device PRF (ops/prf_kernels.py): the ChaCha20
  kernel `chacha20_limbs` at the draws of the DeviceSource mixes, N rows
  of 2147 bits (modp2048's re-encryption exponents: |q| + 100) and
  --ec-n rows of 356 bits (P-256's), each whole (`chacha20_limbs`,
  `chacha20_limbs_p256` keys).

Every tree of the port since the EC slice has these wrappers with these
signatures, so a commit and its parent, unpacked side by side, are timed
the same way on the same inputs, one process each.

--sweep times the cooperative kernels of this tree at every TPI (lanes an
element or point) they are built for: H1, H2 and H3 over a range of N at
each width the tree instantiates (H3 at both windows of W = 64, at
window 8 of W = 96 and 128, none at W = 12), H4 over a range of N at
full-width and 256-bit exponents (W >= 64) and 256-bit ones (W = 8), H5
over a range of points and H8 over 1 to 2^17 pairs at P-256 and at
P-384 (where the tree has W = 12), and the EC combine over 16 and 64
positions (P-384: 16 and 96), forcing the TPI through `COOP_TPI`, the
table the wrappers choose it from (a TPI with no kernel is skipped); it
prints, per kernel and width, the fastest TPI at each N.  It also times
H6 (one chunk shape is built a width) over a range of points, and H4 at
modp2048 at each (elements, exponent bits) of the path under every pair
of its launch-shape constants EP_MIN_ELEMENTS and EP_ACC_BYTES (`--only
ep_shape` for that alone).  `--widths` limits the sweep to those widths
(e.g. `--widths 12`: H1, H2 at the P-384 field and the EC kernels at
P-384; `--widths 20`: the same at P-521's inner width).  `--widths 32`
sweeps a width built on demand (Oakley's 1024-bit group, RFC 2409
§6.2): H1-H4 at TPI 8, 16 and 32 from a width library built for the
sweep, H3 at both windows; `--widths 192 256` the same at RFC 3526's
modp6144 and modp8192 (`RFC_WIDE`) at the TPIs that leave a lane at
most 8 words (32), 16 for H1 and H2 (16 and 32; `SWEEP_SLICE_WORDS`),
over 3 runs a time; `--widths 480 512` at the 15360-bit group ffc15360
and a 16384-bit modulus (`FFC_WIDE`) at TPI 32 alone (16 words a lane
at most, every kernel), over the N of the ffc15360 path; at W = 96 and 128 H3 also at window 4
(256-bit exponents) from such a library at TPI 16 and 32 (`--widths 96
128 --only mont_fb_exp` for that alone).  `--curve P-224`
sweeps P-224's padded moduli in its place: H1 and H2 at the field and
the ring (224-bit exponents), H5, H8 and the combine (16 and 64
positions) and H6 at the field, all at W' = 8 with the conversion on.

--startup splits the start-up of a process that runs the port on the
card (as each `vmn` process of the CLI does) into its steps, measured in
a fresh Python process: the interpreter, `import torch`, the port's CLI
modules, the CUDA context, `build_kernels()` (hashing every source;
the library is built already) and the `ctypes` load, the modp2048 and
P-256 groups' set-up, and the first launch.

Prints the card's name and power limit, then one JSON object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

if __name__ == "__main__":  # run as a file: its folder is no import root
    sys.path.pop(0)

import torch  # noqa: E402

SPIN_CYCLES_PER_S = 1.98e9  # torch.cuda._sleep counts SM clock cycles
EC_COMBINE_POSITIONS = 64  # K10's ndig_pad at a 256-bit scalar
# The modp widths above 64 words: modp3072 and modp4096.
WIDE_N = (1, 4, 16, 64, 256, 1024, 2048, 4096, 8192, 10000)
SWEEP_N = {64: (1, 4, 16, 64, 256, 1024, 2048, 4096, 6144, 8192, 10000,
                16384),
           8: (1, 16, 256, 1024, 4096, 8192, 16384, 32768, 65536, 131072,
               262144),
           96: WIDE_N, 128: WIDE_N}
SWEEP_N[12] = SWEEP_N[20] = SWEEP_N[24] = SWEEP_N[8]
SWEEP_SMUL_N = (256, 1024, 4096, 8192, 16384, 32768, 65536, 131072, 262144)
SWEEP_FB_N = {64: (1, 16, 256, 1024, 2048, 4096, 8192, 10000, 16384),
              8: (1, 4, 16, 64, 256, 1024, 4096),
              96: (1, 16, 256, 1024, 2048, 4096, 8192, 10000),
              128: (1, 16, 256, 1024, 2048, 4096, 8192, 10000)}
# H3's (window, exponent bits) by width: the fixed-base powers of each
# path (None: |q| bits, the full width)
FB_CASES = {64: ((8, None), (4, 256)), 8: ((4, 256),), 96: ((8, None),),
            128: ((8, None),), 12: (), 20: (), 24: ()}
# The sweep's: window 4 at 256 bits too at W = 32, 96 and 128 (a group
# with a 256-bit q, FIPS 186-4 §4.2's (L, N) = (3072, 256)).
SWEEP_FB_CASES = {**FB_CASES, 32: ((8, None), (4, 256)),
                  96: ((8, None), (4, 256)), 128: ((8, None), (4, 256))}
# The on-demand width swept beside the main library's (a 1024-bit group,
# `vog -bitlen 1024`: W = 32), at W = 64's grids and TPIs.
SWEEP_N[32] = SWEEP_N[64]
SWEEP_FB_N[32] = SWEEP_FB_N[64]
# Per width, the kernels whose sweep needs TPIs that the main library
# lacks: a width library of every candidate TPI (`_sweep_tpis`) is built
# for them first (ops/mont_kernels.py width_library).
SWEEP_LIBS = {32: ("mont_mul", "mont_exp", "mont_fb_exp",
                   "mont_expprod_positions"),
              96: ("mont_fb_exp",), 128: ("mont_fb_exp",)}
# RFC 3526's groups past 4096 bits, built on demand (W = 192, 256; p from
# their group files, tests/golden/group_{name}.json): H1-H4 from a width
# library of every candidate TPI, H3 at both windows, over N grids cut to
# the path's shapes and timed over fewer runs (a full-width H2 of 10000
# elements takes seconds there).
RFC_WIDE = {192: "modp6144", 256: "modp8192"}
GOLDEN = Path(__file__).resolve().parent.parent / "tests" / "golden"
SWEEP_REPS = dict.fromkeys(RFC_WIDE, 3)  # runs a time (10 elsewhere)
SWEEP_N.update(dict.fromkeys(RFC_WIDE, (1, 4, 16, 64, 256, 1024, 2048, 4096,
                                        10000)))
SWEEP_FB_N.update(dict.fromkeys(RFC_WIDE, (1, 16, 256, 1024, 2048, 4096,
                                           10000)))
SWEEP_FB_CASES.update(dict.fromkeys(RFC_WIDE, ((8, None), (4, 256))))
SWEEP_LIBS.update(dict.fromkeys(RFC_WIDE, SWEEP_LIBS[32]))
# The widths past 256 words, built on demand: W = 480 at the 15360-bit
# group of tests/golden/group_ffc15360.json, W = 512 at
# `wide_modulus(16384)` (no group of the repo has it); over the N of the
# ffc15360 path (its slice's 1000 and batches of one), 3 runs a time.
FFC_WIDE = {480: "ffc15360", 512: None}
FFC_SWEEP_N = (1, 16, 256, 1000)
SWEEP_REPS.update(dict.fromkeys(FFC_WIDE, 3))
for _grid in (SWEEP_N, SWEEP_FB_N):
    _grid.update(dict.fromkeys(FFC_WIDE, FFC_SWEEP_N))
SWEEP_FB_CASES.update(dict.fromkeys(FFC_WIDE, ((8, None), (4, 256))))
SWEEP_LIBS.update(dict.fromkeys(FFC_WIDE, SWEEP_LIBS[32]))
# The words a lane of a kernel may hold in a sweep's width library: H3
# and H4 run blocks of up to 1024 threads (64 registers a thread), so 8
# (kernel_words); H1 and H2 blocks of 128 (up to 255 and 168 registers),
# so 16 there: W = 192 and 256 try TPI 16 beside 32.  Above 256 words
# every kernel 16 (H3's and H4's blocks of 512 threads, `block_cap`): TPI
# 32 alone at W = 480 and 512.
SWEEP_SLICE_WORDS = {"mont_mul": 16, "mont_exp": 16}
WIDE_SLICE_WORDS = 16
# RFC 2409 §6.2, the Oakley 1024-bit MODP group's prime: W = 32.
_OAKLEY_1024 = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE65381FFFFFFFFFFFFFFFF", 16)
# The curves of the EC kernels by field width W, their scalars' bits and
# the positions of the combine's sweep (the last: a scalar's).
# P-521 at its inner width W' = 20 (L = 33 limbs padded to 40, Modulus):
# 144 positions at a 521-bit scalar.
EC_CURVES = {8: ("P-256", 256, (16, 64)), 12: ("P-384", 384, (16, 96)),
             20: ("P-521", 521, (16, 144))}
# The curves timed at --ec-n beside P-256 (W: key suffix).
EC_TAGS = {12: "_p384", 20: "_p521"}
# P-224 (L = 14 limbs at the inner width W' = 8, the P-256 instantiations
# with the boundary conversion on): its W is P-256's, so it is timed under
# its own key and swept with --curve.
P224 = ("P-224", 224, (16, 64))
SWEEP_MEXP_N = (4096, 16384, 65536, 131072, 262144)
SWEEP_EP_N = {64: (1, 6, 16, 64, 256, 1024, 2048, 4096, 10000),
              8: (1, 16, 256, 1024, 4096, 10000),
              32: (1, 6, 16, 64, 256, 1024, 2048, 4096, 10000),
              96: (1, 6, 16, 64, 256, 1024, 4096, 10000),
              128: (1, 6, 16, 64, 256, 1024, 4096, 10000)}
SWEEP_EP_N.update(dict.fromkeys(RFC_WIDE, SWEEP_EP_N[128]))
SWEEP_EP_N.update(dict.fromkeys(FFC_WIDE, FFC_SWEEP_N))
SWEEP_ADD_N = (1, 128, 1024, 4096, 16384, 131072)
# H4's (elements, exponent bits) on the ModP paths (PERF.md §6): the
# element count 10000 stands for --n, bits None for |q|.
EP_WIDTHS = ((1, None), (6, None), (16, None), (10000, 100), (10000, 256),
             (10000, 400), (10000, 612), (10000, None))
EP_CALLS = (2, 2, 1, 2, 7, 9, 3, 1)  # mix + verify calls at each width
SWEEP_COMBINE_POSITIONS = (16, 64)
# H4's launch-shape constants (ops/mont_kernels.py), swept at EP_WIDTHS.
SWEEP_EP_MIN_ELEMENTS = (4, 8, 16, 32, 64)
SWEEP_EP_ACC_BYTES = (32 * 1024, 64 * 1024, 128 * 1024)
TPI_CANDIDATES = (1, 2, 4, 8, 16, 32)


def device_ms(fn, reps: int = 3) -> float:
    """Mean device milliseconds per run of a kernel wrapper fn(): the runs
    are queued behind a spin kernel (torch.cuda._sleep) as long as three
    times their host time, so that they follow one another on the device
    without host gaps, and are timed with CUDA events.  A wrapper's own
    host work (argument checks, ctypes) is thus left out, which matters
    for the batch-1 launches of a few microseconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0, 3 * reps * host_s) * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, name: str, reps: int = 20) -> float:
    """Mean device milliseconds per run of fn() of the CUDA kernels whose
    name holds `name`, from torch.profiler (the wrapper's other launches,
    copies and allocations left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name)
    if not us:
        raise RuntimeError(f"profiler saw no device time of {name}")
    return us / 1e3 / reps


def _elements(gen, n: int, L: int, dev) -> torch.Tensor:
    """n random (n, L) int32 limb rows with the top limb 0: below the
    moduli timed here, whose top limb is 0xFFFF."""
    x = torch.randint(0, 1 << 16, (n, L), generator=gen, device=dev,
                      dtype=torch.int32)
    x[:, -1] = 0
    return x


def _exponents(gen, n: int, nbits: int, dev) -> torch.Tensor:
    le = -(-nbits // 16)
    e = torch.randint(0, 1 << 16, (n, le), generator=gen, device=dev,
                      dtype=torch.int32)
    e[:, -1] &= (1 << (nbits - 16 * (le - 1))) - 1
    return e


def _limbs_of(x: int, dev) -> torch.Tensor:
    le = -(-x.bit_length() // 16)
    return torch.tensor([[(x >> (16 * i)) & 0xFFFF for i in range(le)]],
                        dtype=torch.int32, device=dev)


def _group_p(name: str) -> int:
    """p of a group file (tests/golden/group_{name}.json)."""
    return int(json.loads((GOLDEN / f"group_{name}.json").read_text())["p"],
               16)


def wide_modulus(bits: int) -> int:
    """An odd modulus of exactly `bits` bits, SHA-256 in counter mode over
    b"modulus-{bits}": where no group of the repo has a width (W = 512),
    the kernels are checked and timed at it (a Montgomery product needs
    only an odd modulus)."""
    import hashlib

    seed = f"modulus-{bits}".encode()
    raw = b"".join(hashlib.sha256(seed + i.to_bytes(8, "big")).digest()
                   for i in range(-(-bits // 256)))
    x = int.from_bytes(raw, "big") >> (8 * len(raw) - bits)
    return x | 1 << (bits - 1) | 1


def _moduli(dev, widths=(64, 8)):
    """{W: MontCtx} of modp2048 (64), the P-256 field (8), the P-384 field
    (12), the P-521 field (its inner width 20), Oakley's 1024-bit group
    (32), modp3072 (96), modp4096 (128), modp6144 (192), modp8192 (256),
    ffc15360 (480) and `wide_modulus(16384)` (512), for the widths
    asked."""
    from vmn_tpu_torch.arith.ec import _CURVES
    from vmn_tpu_torch.arith.mont import MontCtx
    from vmn_tpu_torch.arith.pgroup import (
        _RFC3526_2048, _RFC3526_3072, _RFC3526_4096,
    )

    moduli = {64: _RFC3526_2048, 8: _CURVES["P-256"][0],
              12: _CURVES["P-384"][0], 20: _CURVES["P-521"][0],
              32: _OAKLEY_1024, 96: _RFC3526_3072, 128: _RFC3526_4096}
    named = {**RFC_WIDE, **FFC_WIDE}
    return {w: MontCtx(moduli[w] if w in moduli else
                       _group_p(named[w]) if named[w] else
                       wide_modulus(32 * w), dev) for w in widths}


def _tree_widths(K) -> list:
    """The widths that the tree of mont_kernels module K instantiates, in
    the order they are timed: modp2048 and the P-256 field first."""
    return [w for w in (64, 8, 12, 20, 96, 128) if w in K._WIDTHS]


def _full_bits(ctx) -> int:
    """The exponent bits of a ModP path's full-width powers (|q|)."""
    return ctx.nbits - 1


def time_tree(n: int, ec_n: int) -> dict:
    """{case: device ms} of the wrappers of the imported package, at each
    width it instantiates."""
    from vmn_tpu_torch.ops import ec_kernels as E
    from vmn_tpu_torch.ops import mont_kernels as K

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2048)
    out = {}
    for w, ctx in _moduli(dev, _tree_widths(K)).items():
        tag = "" if w == 64 else f"_w{w}"
        count = ec_n if w in EC_CURVES else n
        ebits = EC_CURVES[w][1] if w in EC_CURVES else _full_bits(ctx)
        a = _elements(gen, count, ctx.L, dev)
        b = _elements(gen, count, ctx.L, dev)
        e = _exponents(gen, count, ebits, dev)
        inv_bits = (ctx.m - 2).bit_length()
        e_inv = _limbs_of(ctx.m - 2, dev)
        a1, b1 = a[:1].clone(), b[:1].clone()
        out[f"mont_mul{tag}"] = device_ms(lambda: K.mont_mul(a, b, ctx.mod))
        out[f"mont_exp{tag}"] = device_ms(
            lambda: K.mont_exp(a, e, ctx.mod, ebits))
        out[f"mont_mul{tag}_b1"] = device_ms(
            lambda: K.mont_mul(a1, b1, ctx.mod), reps=20)
        out[f"mont_exp{tag}_b1"] = device_ms(
            lambda: K.mont_exp(a1, e_inv, ctx.mod, inv_bits))
        e256 = _exponents(gen, n, 256, dev)
        for window, bits in FB_CASES[w]:
            tbl = ctx.fixed_base_table(5, bits or ebits, window)
            eb = e256 if bits == 256 else e
            out[f"mont_fb_exp{window}{tag}"] = device_ms(
                lambda: K.mont_fb_exp(tbl, eb, ctx.mod))
        if w == 8:
            a_n = a[:n]
            out["mont_expprod_positions_w8"] = device_ms(
                lambda: K.mont_expprod_positions(a_n, e256, ctx.mod, 256))
            continue
        if w in EC_TAGS:  # the EC paths run H1 and H2 alone there
            continue
        for count, bits in _ep_widths(ctx, n):
            eb = _exponents(gen, count, bits, dev)
            ab = a[:count]
            key = f"mont_expprod_positions{tag}" + (
                "" if (count, bits) == (n, 256) else f"_{count}x{bits}")
            out[key] = device_ms(
                lambda: K.mont_expprod_positions(ab, eb, ctx.mod, bits))
        P = _elements(gen, K._ndig_pad(ebits), ctx.L, dev)
        out[f"mont_expprod_combine{tag}"] = device_ms(
            lambda: _combine(K, P, ctx.mod))
    out.update(_time_ec(E, dev, 4096, "_4096"))
    out.update(_time_ec(E, dev, ec_n, ""))
    for w, tag in EC_TAGS.items():
        if w in getattr(E, "_WIDTHS", ()):
            out.update(_time_ec(E, dev, ec_n, tag, w))
    if getattr(K, "INNER_WORDS", {}).get(14) == 8:  # P-224 at W' = 8
        for ctx, tag in _p224_moduli(dev):
            a = _elements(gen, ec_n, ctx.L, dev)
            b = _elements(gen, ec_n, ctx.L, dev)
            e = _exponents(gen, ec_n, P224[1], dev)
            out[f"mont_mul{tag}"] = device_ms(
                lambda: K.mont_mul(a, b, ctx.mod))
            out[f"mont_exp{tag}"] = device_ms(
                lambda: K.mont_exp(a, e, ctx.mod, P224[1]))
        out.update(_time_ec(E, dev, ec_n, "_p224", 8, P224))
    if importlib.util.find_spec("vmn_tpu_torch.ops.prf_kernels"):
        out.update(time_prf(dev, n, ec_n))
    return out


def time_prf(dev, n: int, ec_n: int) -> dict:
    """{case: device ms} of `chacha20_limbs` at the DeviceSource mixes'
    draws: N rows of modp2048's |q| + rbitlen = 2047 + 100 bits, --ec-n
    rows of P-256's 256 + 100."""
    from vmn_tpu_torch.ops import prf_kernels as PK

    key = bytes(range(32))
    out = {}
    for tag, count, bits in (("", n, 2147), ("_p256", ec_n, 356)):
        out[f"chacha20_limbs{tag}"] = device_ms(
            lambda: PK.chacha20_limbs(key, 1, count, bits, device=dev))
    return out


def _p224_moduli(dev):
    """[(MontCtx, key suffix)] of P-224's field and scalar ring."""
    from vmn_tpu_torch.arith.ec import ECqPGroup

    grp = ECqPGroup.named("P-224", device=dev)
    return [(grp.ctx, "_p224"), (grp.ring.ctx, "_p224_ring")]


def _ep_widths(ctx, n: int) -> list:
    """EP_WIDTHS at ctx's width: (elements, exponent bits)."""
    return [(n if count == 10000 else count, bits or _full_bits(ctx))
            for count, bits in EP_WIDTHS]


def _combine(K, P, mod):
    if hasattr(K, "mont_expprod_combine"):
        return K.mont_expprod_combine(P, mod)
    acc = mod.one_mont.reshape(1, -1)
    for j in range(P.shape[0] - 1, -1, -1):
        for _ in range(4):
            acc = K.mont_mul(acc, acc, mod)
        acc = K.mont_mul(acc, P[j : j + 1], mod)
    return acc[0]


def _ec_combine(E, P, mod):
    if hasattr(E, "ec_multiexp_combine"):
        return E.ec_multiexp_combine(*P, mod)
    zero = torch.zeros((1, mod.L), dtype=torch.int32, device=P[0].device)
    acc = (zero, mod.one_mont.reshape(1, -1), zero)
    for j in range(P[0].shape[0] - 1, -1, -1):
        for _ in range(4):
            acc = E.ec_point_add(*acc, *acc, mod)
        acc = E.ec_point_add(*acc, *(t[j : j + 1] for t in P), mod)
    return tuple(t[0] for t in acc)


def _time_ec(E, dev, n: int, tag: str, w: int = 8, curve=None) -> dict:
    """The EC wrappers on n points of the curve of width W (EC_CURVES, or
    `curve`: P224); at --ec-n (no tag, or EC_TAGS' and P-224's) also the
    combine, H8 on one pair and H8's and H6's kernels alone; H7 where it
    is built (not at P-224 and P-521)."""
    import numpy as np

    from vmn_tpu_torch.arith.ec import ECqPGroup, _ec_fb_table
    from vmn_tpu_torch.crypto.hash import SHA256
    from vmn_tpu_torch.crypto.prg import PRGHeuristic

    name, bits, positions = curve or EC_CURVES[w]
    grp = ECqPGroup.named(name, device=dev)
    mod = grp.ctx.mod
    prg = PRGHeuristic(SHA256)
    prg.set_seed(SHA256.hash(b"smoke-ec-points"))
    pts = grp.random_array(n, prg, 8)
    x, y, inf = pts.x, pts.y, pts.inf
    rng = np.random.default_rng(256)
    e = grp.ring.from_ints([int.from_bytes(rng.bytes(bits // 8 + 8), "big")
                            % grp.n for _ in range(n)]).limbs
    X, Y, Z = E.ec_scalar_mul(x, y, inf, e, mod, bits)
    X2, Y2, Z2 = (t.flip(0).contiguous() for t in (X, Y, Z))
    extra = {}
    if tag != "_4096":
        P = [t[:positions[-1]].contiguous() for t in (X, Y, Z)]
        extra[f"ec_multiexp_combine{tag}"] = device_ms(
            lambda: _ec_combine(E, P, mod))
        one = [t[1:2].clone() for t in (X, Y, Z, X2, Y2, Z2)]
        extra[f"ec_point_add_b1{tag}"] = device_ms(
            lambda: E.ec_point_add(*one, mod), reps=20)
        extra[f"ec_point_add_kernel_only{tag}"] = kernel_ms(
            lambda: E.ec_point_add(X, Y, Z, X2, Y2, Z2, mod), "ec_add_kernel")
        extra[f"ec_multiexp_positions_kernel_only{tag}"] = kernel_ms(
            lambda: E.ec_multiexp_positions(x, y, inf, e, mod, bits),
            "ec_mexp_", reps=3)  # ec_mexp_kernel, ec_mexp_coop_kernel
        for b in (w for w in (100, 256) if w < bits):  # the paths' others
            eb = e[:, : -(-b // 16)].clone()
            eb[:, -1] &= (1 << (b - 16 * (eb.shape[1] - 1))) - 1
            extra[f"ec_multiexp_positions{tag}_{b}"] = device_ms(
                lambda eb=eb, b=b: E.ec_multiexp_positions(x, y, inf, eb,
                                                           mod, b))
    if not mod.conv:  # H7: off the paths, not built at a padded modulus
        tbx, tby = _ec_fb_table(grp.curve, *grp.g._jac(), bits // 4)
        extra[f"ec_fb_exp{tag}"] = device_ms(
            lambda: E.ec_fb_exp(tbx, tby, e, mod))
    return {
        **extra,
        f"ec_scalar_mul{tag}": device_ms(
            lambda: E.ec_scalar_mul(x, y, inf, e, mod, bits)),
        f"ec_multiexp_positions{tag}": device_ms(
            lambda: E.ec_multiexp_positions(x, y, inf, e, mod, bits)),
        f"ec_point_add{tag}": device_ms(
            lambda: E.ec_point_add(X, Y, Z, X2, Y2, Z2, mod), reps=20),
    }


def _sweep_tpis(w: int, kernel: str) -> tuple:
    """The TPIs of `kernel` a width library for a sweep holds: 8, 16 and
    32 where they divide W and leave a lane at most SWEEP_SLICE_WORDS
    (8 but for H1 and H2; 16 for every kernel past 256 words)."""
    most = (WIDE_SLICE_WORDS if w > 256 else
            SWEEP_SLICE_WORDS.get(kernel, 8))
    return tuple(t for t in (8, 16, 32) if w % t == 0 and w // t <= most)


def _sweep_kernel(K, kernel: str, w: int, ns, run, rows: list,
                  best: dict, tag: str = "", only=()) -> None:
    """Time run(n) at every TPI that divides W and has a kernel, forcing it
    through COOP_TPI[kernel, w]; the rule is restored after (taken out
    where W had none: an on-demand width).  Nothing where `only` names
    other kernels."""
    if only and kernel not in only:
        return
    rule = K.COOP_TPI.get((kernel, w))
    if rule is None and kernel not in getattr(K, "COOP_MONT", ()):
        return
    tpis = []
    try:
        for tpi in (t for t in TPI_CANDIDATES if w % t == 0):
            K.COOP_TPI[kernel, w] = ((1, tpi),)
            try:
                run(ns[0])
            except ValueError:  # no kernel instantiated at this TPI
                continue
            tpis.append(tpi)
        for n in ns:
            times = {}
            for tpi in tpis:
                K.COOP_TPI[kernel, w] = ((1, tpi),)
                times[tpi] = device_ms(lambda: run(n),
                                       reps=SWEEP_REPS.get(w, 10))
                rows.append({"kernel": kernel + tag, "W": w, "N": n,
                             "tpi": tpi, "ms": times[tpi]})
            best.setdefault(f"{kernel}{tag} W={w}", {})[n] = min(
                times, key=times.get)
            print(f"[sweep] kernel={kernel}{tag} W={w} N={n} " + " ".join(
                f"tpi{t}_ms={ms:.4f}" for t, ms in times.items()), flush=True)
    finally:
        if rule is None:
            del K.COOP_TPI[kernel, w]
        else:
            K.COOP_TPI[kernel, w] = rule


def sweep(only=(), widths=(), curve=None) -> dict:
    """H1 and H2 at every instantiated TPI over SWEEP_N at each width the
    tree instantiates, H4 over SWEEP_EP_N, H3 over SWEEP_FB_N; H5 over
    SWEEP_SMUL_N points, H8 over SWEEP_ADD_N pairs and the EC combine
    over the positions of EC_CURVES at each curve's width; H6 over
    SWEEP_MEXP_N points.  Only the kernels (wrapper names) in `only`, and
    the widths in `widths`, where they name any.  curve "P-224": the
    same at P-224's padded moduli (W' = 8) alone."""
    from vmn_tpu_torch.ops import ec_kernels as E
    from vmn_tpu_torch.ops import mont_kernels as K

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows, best = [], {}
    if curve == "P-224":
        top = max(SWEEP_N[8])
        moduli = _p224_moduli(dev)
        for ctx, tag in moduli:
            a = _elements(gen, top, ctx.L, dev)
            b = _elements(gen, top, ctx.L, dev)
            e = _exponents(gen, top, P224[1], dev)
            runs = {"mont_mul": lambda k: K.mont_mul(a[:k], b[:k], ctx.mod),
                    "mont_exp": lambda k: K.mont_exp(a[:k], e[:k], ctx.mod,
                                                     P224[1])}
            for kernel, run in runs.items():
                _sweep_kernel(K, kernel, 8, SWEEP_N[8], run, rows, best,
                              tag=tag, only=only)
        _sweep_ec(K, E, 8, moduli[0][0], gen, dev, rows, best, only, P224)
        return {"sweep": rows, "fastest_tpi": best}
    on_demand = tuple(SWEEP_LIBS) if hasattr(K, "width_library") else ()
    mont_widths = [w for w in dict.fromkeys((*_tree_widths(K), *on_demand))
                   if not widths or w in widths]
    for w, ctx in _moduli(dev, mont_widths).items():
        if w in on_demand:
            K.width_library(w, {k: _sweep_tpis(w, k) for k in SWEEP_LIBS[w]
                                if not only or k in only})
        ebits = _full_bits(ctx) if w not in EC_CURVES else EC_CURVES[w][1]
        top = max(SWEEP_N[w])
        a = _elements(gen, top, ctx.L, dev)
        b = _elements(gen, top, ctx.L, dev)
        e = _exponents(gen, top, ebits, dev)
        runs = {"mont_mul": lambda k: K.mont_mul(a[:k], b[:k], ctx.mod),
                "mont_exp": lambda k: K.mont_exp(a[:k], e[:k], ctx.mod,
                                                 ebits)}
        for kernel, run in runs.items():
            _sweep_kernel(K, kernel, w, SWEEP_N[w], run, rows, best,
                          only=only)
        if w in EC_TAGS:
            continue  # W = 12, 20: their paths run H1 and H2 alone
        ep_top = max(SWEEP_EP_N[w])
        a = _elements(gen, ep_top, ctx.L, dev)
        for bits in (ebits, 256) if w not in EC_CURVES else (256,):
            e = _exponents(gen, ep_top, bits, dev)
            _sweep_kernel(K, "mont_expprod_positions", w, SWEEP_EP_N[w],
                          lambda k: K.mont_expprod_positions(
                              a[:k], e[:k], ctx.mod, bits), rows, best,
                          tag=f" bits={bits}", only=only)
        fb_n = max(SWEEP_FB_N[w])
        a = _elements(gen, fb_n, ctx.L, dev)
        for window, bits in SWEEP_FB_CASES[w]:
            bits = bits or ebits
            tbl = ctx.fixed_base_table(5, bits, window)
            e = _exponents(gen, fb_n, bits, dev)
            _sweep_kernel(K, "mont_fb_exp", w, SWEEP_FB_N[w],
                          lambda k: K.mont_fb_exp(tbl, e[:k], ctx.mod), rows,
                          best, tag=f" window={window}", only=only)
    # The EC kernels' work does not depend on their inputs (constant time,
    # docs/DEVIATIONS.md #5), so field elements below p stand in for points.
    for w in getattr(E, "_WIDTHS", (8,)):
        if not widths or w in widths:
            _sweep_ec(K, E, w, _moduli(dev, (w,))[w], gen, dev, rows, best,
                      only)
    if (not only or "ep_shape" in only) and (not widths or 64 in widths):
        _sweep_ep_shape(K, _moduli(dev)[64], gen, dev, rows)
    return {"sweep": rows, "fastest_tpi": best}


def _sweep_ec(K, E, w, ctx, gen, dev, rows: list, best: dict, only,
              curve=None) -> None:
    """H5, the EC combine and H8 at every TPI, H6 at its shape, on the
    curve of width W (EC_CURVES, or `curve`: P224, its rows tagged)."""
    _, bits, positions = curve or EC_CURVES[w]
    tag = "" if curve is None else "_" + curve[0].replace("-", "").lower()
    top = max(SWEEP_SMUL_N)
    x, y = (_elements(gen, top, ctx.L, dev) for _ in range(2))
    inf = torch.zeros(top, dtype=torch.bool, device=dev)
    e = _exponents(gen, top, bits, dev)
    _sweep_kernel(K, "ec_scalar_mul", w, SWEEP_SMUL_N,
                  lambda k: E.ec_scalar_mul(x[:k], y[:k], inf[:k], e[:k],
                                            ctx.mod, bits), rows, best,
                  tag=tag, only=only)
    P = [_elements(gen, max(positions), ctx.L, dev) for _ in range(3)]
    _sweep_kernel(K, "ec_multiexp_combine", w, positions,
                  lambda k: E.ec_multiexp_combine(*(t[:k] for t in P),
                                                  ctx.mod), rows, best,
                  tag=tag, only=only)
    Z1, X2, Y2, Z2 = (_elements(gen, top, ctx.L, dev) for _ in range(4))
    _sweep_kernel(K, "ec_point_add", w, SWEEP_ADD_N,
                  lambda k: E.ec_point_add(x[:k], y[:k], Z1[:k], X2[:k],
                                           Y2[:k], Z2[:k], ctx.mod),
                  rows, best, tag=tag, only=only)
    mexp = not only or "ec_multiexp_positions" in only
    for n in SWEEP_MEXP_N if mexp else ():
        ms = device_ms(lambda: E.ec_multiexp_positions(
            x[:n], y[:n], inf[:n], e[:n], ctx.mod, bits), reps=5)
        rows.append({"kernel": "ec_multiexp_positions" + tag, "W": w,
                     "N": n, "shape": _mexp_shape(E, n, w, bits), "ms": ms})
        print(f"[sweep] kernel=ec_multiexp_positions{tag} W={w} N={n} "
              f"shape={rows[-1]['shape']} ms={ms:.4f}", flush=True)


def _sweep_ep_shape(K, ctx, gen, dev, rows: list) -> None:
    """H4 at W = 64 at each of EP_WIDTHS under every (EP_MIN_ELEMENTS,
    EP_ACC_BYTES) of the sweep, the TPI from its rule; the constants are
    restored after.  One row per (constants, width) with its launch shape
    and a `path_ms` row per constants: the widths' times weighted by the
    path's calls (EP_CALLS)."""
    a = _elements(gen, 10000, ctx.L, dev)
    widths = _ep_widths(ctx, 10000)
    es = {bits: _exponents(gen, 10000, bits, dev)
          for bits in {b for _, b in widths}}
    saved = K.EP_MIN_ELEMENTS, K.EP_ACC_BYTES
    try:
        for K.EP_MIN_ELEMENTS in SWEEP_EP_MIN_ELEMENTS:
            for K.EP_ACC_BYTES in SWEEP_EP_ACC_BYTES:
                path = 0.0
                for (n, bits), calls in zip(widths, EP_CALLS):
                    ab, eb = a[:n], es[bits][:n]
                    ms = device_ms(lambda: K.mont_expprod_positions(
                        ab, eb, ctx.mod, bits), reps=10)
                    path += calls * ms
                    sh = K.ep_launch(64, n, K._ndig_pad(bits), K._sms(dev))
                    rows.append({
                        "kernel": "ep_shape", "N": n, "bits": bits,
                        "min_elements": K.EP_MIN_ELEMENTS,
                        "acc_bytes": K.EP_ACC_BYTES, "ms": ms,
                        "shape": {f: getattr(sh, f) for f in (
                            "tpi", "threads", "jb", "subs", "chunk",
                            "eblocks", "pblocks")}})
                rows.append({"kernel": "ep_shape",
                             "min_elements": K.EP_MIN_ELEMENTS,
                             "acc_bytes": K.EP_ACC_BYTES, "path_ms": path})
                print(f"[sweep] kernel=ep_shape min_elements="
                      f"{K.EP_MIN_ELEMENTS} acc_bytes={K.EP_ACC_BYTES} "
                      f"path_ms={path:.4f} " + " ".join(
                          f"{r['N']}x{r['bits']}={r['ms']:.4f}"
                          for r in rows[-1 - len(widths):-1]),
                      flush=True)
    finally:
        K.EP_MIN_ELEMENTS, K.EP_ACC_BYTES = saved


def _mexp_shape(E, n: int, w: int, bits: int) -> dict:
    """H6's launch shape at width W for n points at scalars of `bits`
    bits (64 positions at 256 bits)."""
    npos = -(-(-(-bits // 4)) // 16) * 16  # ndig_pad
    if hasattr(E, "MEXP_SHAPES"):
        chunk, folders = E.MEXP_SHAPES[w]
        blocks, subs = E.mexp_shape(n, npos, w)
    else:  # a tree before PR 11: one shape, P-256's
        chunk, folders = E.MEXP_CHUNK, E.MEXP_FOLDERS
        blocks, subs = E.mexp_shape(n, npos)
    return {"chunk": chunk, "folders": folders, "blocks": blocks,
            "subs": subs}


# The child of --startup: marks (seconds since its first statement) after
# each step of a card process's start-up, as one JSON line.
STARTUP_CHILD = """
import time
t0 = time.perf_counter()
marks = {}
def mark(name):
    marks[name] = time.perf_counter() - t0
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
mark("import_torch")
import vmn_tpu_torch.cli.main  # noqa: F401 (the CLI's entry point)
import vmn_tpu_torch.cli.vmn  # noqa: F401 (the mix-server tool's imports)
mark("import_port_cli")
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
mark("cuda_context")
from vmn_tpu_torch.ops import ec_kernels as E
from vmn_tpu_torch.ops import mont_kernels as K
K.build_kernels()
mark("build_kernels_hash")
E._library()
mark("cdll_load")
from vmn_tpu_torch.arith.ec import ECqPGroup
from vmn_tpu_torch.arith.pgroup import ModPGroup
g = ModPGroup.named("modp2048")
ECqPGroup.named("P-256")
torch.cuda.synchronize()
mark("group_setup")
one = g.ctx.one_mont[None]
K.mont_mul(one, one, g.ctx.mod)
torch.cuda.synchronize()
mark("first_launch")
print(json.dumps(marks))
"""


def startup(tree: Path) -> dict:
    """The seconds of each step of a card process's start-up (STARTUP_CHILD
    in a fresh process; `interpreter`: the process's wall time less the
    child's own)."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", STARTUP_CHILD, str(tree)],
                         capture_output=True, text=True, check=True,
                         timeout=600)
    wall = time.perf_counter() - t0
    marks = json.loads(res.stdout.strip().splitlines()[-1])
    steps, last = {}, 0.0
    for name, at in marks.items():
        steps[name] = at - last
        last = at
    return {"wall_s": wall, "interpreter_and_exit_s": wall - last,
            "steps_s": steps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path,
                    default=Path(__file__).resolve().parent.parent,
                    help="root of the port's tree to time (default: this "
                         "file's tree)")
    ap.add_argument("--n", type=int, default=10000,
                    help="elements at modp2048 (default 10000)")
    ap.add_argument("--ec-n", type=int, default=1 << 17,
                    help="elements and points at P-256 (default 131072)")
    ap.add_argument("--sweep", action="store_true",
                    help="time this tree's cooperative kernels at every "
                         "TPI instead")
    ap.add_argument("--only", nargs="+", default=(), metavar="WRAPPER",
                    help="with --sweep: only these kernels (wrapper names, "
                         "e.g. mont_expprod_positions ec_point_add; "
                         "ep_shape: H4's launch-shape constants)")
    ap.add_argument("--widths", nargs="+", type=int, default=(), metavar="W",
                    help="with --sweep: only these widths (words), e.g. 12")
    ap.add_argument("--curve", choices=["P-224"],
                    help="with --sweep: this padded curve's moduli alone "
                         "(P-224: L = 14 limbs at W' = 8)")
    ap.add_argument("--startup", action="store_true",
                    help="split a card process's start-up into its steps "
                         "instead")
    ap.add_argument("--prf", action="store_true",
                    help="time the tree's ChaCha20 kernel alone instead, at "
                         "the DeviceSource mixes' draws (--n rows of 2147 "
                         "bits, --ec-n of 356)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_timing: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.tree.resolve()))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    from vmn_tpu_torch.ops import mont_kernels as K

    K.build_kernels()
    if args.startup:
        res = startup(args.tree.resolve())
    elif args.sweep:
        res = sweep(frozenset(args.only), frozenset(args.widths), args.curve)
    elif args.prf:
        res = {"tree": str(args.tree),
               "ms": time_prf(torch.device("cuda", 0), args.n, args.ec_n)}
    else:
        res = {"tree": str(args.tree), "ms": time_tree(args.n, args.ec_n)}
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

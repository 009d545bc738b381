"""Drive the vmn_tpu_torch mix paths once on one CUDA card.

Usage:  python3 chip_smoke.py [--n N] [--ec-n N] [--profile PATH]

Phases (one line each; any failure raises and the exit code is not 0):
  1. environment: torch/CUDA versions and the card's name and power limit;
  2. build the Hopper kernels from vmn_tpu_torch/csrc with nvcc (one nvcc
     per source file, all started together);
  3. check H1 mont_mul, H2 mont_exp, H3 mont_fb_exp (windows 4 and 8) and
     H4 mont_expprod_positions at modp2048 width against their plain
     PyTorch versions on the card (exact equality, a few rows against
     Python pow) and time both;
  4. check H5 ec_scalar_mul, H6 ec_multiexp_positions (with the combine of
     `ec_multiexp`), H7 ec_fb_exp and H8 ec_point_add at P-256 the same
     way (exact equality of Jacobian limbs on the whole batch; after
     `normalize`, a few rows against Python EC arithmetic), with infinity,
     P == Q, P == -Q, scalar 0 and scalar n - 1 among the inputs, and H7
     against H5 on the same fixed-base batch: once on 4096 points and once
     on the EC path's batch (--ec-n);
  5. the test256 and P-256 golden mixes on the card: each transcript must
     equal tests/golden/nizkp_{test256,p256}_k1 byte for byte, and the
     port's verifier must accept it;
  6. the ModP path: modp2048, k=1, N ciphertexts (default 10000): keygen,
     encryption, mix (shuffle + proof of shuffle + verifiable
     decryption), plaintext multiset check, the standalone verifier, and
     the same transcript with one flipped byte rejected;
  7. the EC path: the same at P-256 with --ec-n ciphertexts (default
     131072 = 2^17, from where `exp_prod` takes H6).

Each mix zeroes the wrappers' launch counters just before `session.mix`
and reads them just after it.  H1-H4 must have launched in the modp2048
mix, and H5, H6 and H8 in the P-256 mix (H7 is off that path, as in
vmn_tpu, and reports 0); the `kernels` line reports each kernel's
launches in its own path's mix, beside the error, time, plain version's
time and bound (the least time the card could take for the same work)
of its check at that path's batch; the EC kernels' check at 4096 points
stands under `at_4096`.  The last three lines are that JSON object, the
card's name and power limit, and a JSON status object.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden"

# Per wrapper: file:line of the Pallas kernel its Hopper kernel replaces,
# and the check of phase 3 or 4 that holds its path's shapes.
# mont_fb_exp replaces both K4 (window 8, every fixed-base exponent of the
# modp2048 mix) and K5 (window 4, exponents under 512 bits: test256 only).
REPLACES = {
    "mont_mul": "vmn_tpu/ops/mont_kernels.py:192",
    "mont_exp": "vmn_tpu/ops/mont_kernels.py:754",
    "mont_fb_exp": "vmn_tpu/ops/mont_kernels.py:443",
    "mont_expprod_positions": "vmn_tpu/ops/mont_kernels.py:616",
    "ec_scalar_mul": "vmn_tpu/ops/ec_kernels.py:278",
    "ec_multiexp_positions": "vmn_tpu/ops/ec_kernels.py:445",
    "ec_fb_exp": "vmn_tpu/ops/ec_kernels.py:668",
    "ec_point_add": "vmn_tpu/ops/ec_kernels.py:748",
}
MAIN_CHECK = {"mont_mul": "mont_mul", "mont_exp": "mont_exp",
              "mont_fb_exp": "mont_fb_exp8",
              "mont_expprod_positions": "mont_expprod_positions",
              "ec_scalar_mul": "ec_scalar_mul",
              "ec_multiexp_positions": "ec_multiexp_positions",
              "ec_fb_exp": "ec_fb_exp", "ec_point_add": "ec_point_add"}

# Bounds: the larger of bytes moved (each input read once, each output
# written once, int32 limbs as stored) over the card's memory rate, and
# operations over its peak rate for their type.  The operations are the
# 32-bit integer multiplies of the Montgomery products the function needs:
# a W-word CIOS product (W = L/2) takes W² low and W² high halves of a·b,
# W multiplies q = t·m' and 2·W² halves of q·m, 4·W² + W in all, each one
# multiply-add instruction.  A digit of 0 multiplies or adds nothing, so
# the digits of this run's exponents are counted.  Field additions and
# selects are left out, so the true bound is higher still.  Rates, H100
# SXM at its 700 W limit: 3.35 TB/s (NVIDIA's data sheet), and 32-bit
# integer multiplies at 64 per clock per SM (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0; half the 128
# FMA lanes behind the data sheet's 67 TFLOP/s fp32) on 132 SMs at the
# 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
INT_MUL_PER_S = 132 * 64 * 1.98e9
# Montgomery products per point operation at a = -3, Jacobian coordinates
# (products and squarings alike):
EC_ADD_PRODUCTS = 16    # general addition, 12 + 4
EC_MADD_PRODUCTS = 11   # mixed addition (the second point affine), 7 + 4
EC_DOUBLE_PRODUCTS = 8  # doubling, 3 + 5
# The 16-entry table of a point: 2·P one doubling, 3·P..15·P mixed adds.
EC_TABLE_PRODUCTS = EC_DOUBLE_PRODUCTS + 13 * EC_MADD_PRODUCTS


def nonzero_digits(e: torch.Tensor, ndig: int, window: int) -> int:
    from vmn_tpu_torch.ops.mont_kernels import _digits

    return int((_digits(e, ndig, window) != 0).sum())


def bound(products: int, words: int, nbytes: int) -> dict:
    ops = products * (4 * words * words + words)
    t_ops, t_bytes = ops / INT_MUL_PER_S, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def phase(tag: str, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def ptxas_summary(text: str):
    """One line per kernel instantiation from nvcc's -Xptxas -v report:
    name<widths>, registers, stack frame and spill bytes."""
    name = None
    out = []
    for line in text.splitlines():
        m = re.search(r"Compiling entry .*?([a-z][a-z_]*_kernel)I((?:Li\d+E)+)",
                      line)
        if m:
            args = ",".join(re.findall(r"Li(\d+)E", m.group(2)))
            name, frame = f"{m.group(1)}<{args}>", ""
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            frame = (f"stack={m.group(1)}B spill_st={m.group(2)}B "
                     f"spill_ld={m.group(3)}B")
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name} regs={m.group(1)} {frame}")
            name = None
    return out


def timed(fn, reps: int = 1):
    """(last result, mean milliseconds per run) of `reps` runs of fn(),
    timed with CUDA events on the current stream."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


# ------------------------------------------------------------ phase 3


def check_kernels(n: int) -> dict:
    from vmn_tpu_torch.arith.limbs import ints_to_limbs
    from vmn_tpu_torch.arith.mont import MontCtx, device_limbs
    from vmn_tpu_torch.arith.pgroup import _RFC3526_2048
    from vmn_tpu_torch.ops import mont_kernels as K

    dev = torch.device("cuda", 0)
    ctx = MontCtx(_RFC3526_2048, dev)
    m = ctx.m
    rng = np.random.default_rng(2048)

    def ints(count, bits):
        nb = (bits + 7) // 8 + 8
        return [int.from_bytes(rng.bytes(nb), "big") % (1 << bits)
                for _ in range(count)]

    a_int = [x % m for x in ints(n, 2048)]
    a_int[:3] = [1, m - 1, 2]
    b_int = [x % m for x in ints(n, 2048)]
    a, b = ctx.encode(a_int), ctx.encode(b_int)
    e_full_int = ints(n, 2047)  # field exponents: u^-x, g^r
    e_full_int[0] = 0
    e_short_int = ints(n, 256)  # batching-vector exponents
    e_full = device_limbs(ints_to_limbs(e_full_int, ctx.L), dev)
    e_short = device_limbs(ints_to_limbs(e_short_int, 16), dev)
    g = 4
    tbl8 = ctx.fixed_base_table(g, 2047, 8)
    tbl4 = ctx.fixed_base_table(g, 256, 4)
    rows = [0, 1, 2, n - 1]
    cases = {
        # name: (kernel call, plain call, Python check of a few rows)
        "mont_mul": (
            lambda: K.mont_mul(a, b, ctx.mod),
            lambda: K.mont_mul_plain(a, b, ctx.mod),
            lambda out: [a_int[i] * b_int[i] % m for i in rows],
        ),
        "mont_exp": (
            lambda: K.mont_exp(a, e_full, ctx.mod, 2047),
            lambda: K.mont_exp_plain(a, e_full, ctx.mod, 2047),
            lambda out: [pow(a_int[i], e_full_int[i], m) for i in rows],
        ),
        "mont_fb_exp8": (
            lambda: K.mont_fb_exp(tbl8, e_full, ctx.mod),
            lambda: K.mont_fb_exp_plain(tbl8, e_full, ctx.mod),
            lambda out: [pow(g, e_full_int[i], m) for i in rows],
        ),
        "mont_fb_exp4": (
            lambda: K.mont_fb_exp(tbl4, e_short, ctx.mod),
            lambda: K.mont_fb_exp_plain(tbl4, e_short, ctx.mod),
            lambda out: [pow(g, e_short_int[i], m) for i in rows],
        ),
        "mont_expprod_positions": (
            lambda: K.mont_expprod_positions(a, e_short, ctx.mod, 256),
            lambda: K.mont_expprod_positions_plain(a, e_short, ctx.mod, 256),
            None,
        ),
    }
    W, L, nb = ctx.L // 2, ctx.L, 4 * n * ctx.L  # nb: one (n, L) array
    ndig, ndig_s = -(-2047 // 4), 256 // 4
    nz_short = nonzero_digits(e_short, ndig_s, 4)
    bounds = {
        "mont_mul": bound(n, W, 3 * nb),
        # the table's 14 products, 4 squarings between digits, one product
        # per digit that is not 0
        "mont_exp": bound(n * (14 + 4 * (ndig - 1))
                          + nonzero_digits(e_full, ndig, 4), W, 3 * nb),
        "mont_fb_exp8": bound(nonzero_digits(e_full, tbl8.shape[0], 8), W,
                              4 * tbl8.numel() + 2 * nb),
        "mont_fb_exp4": bound(nz_short, W,
                              4 * tbl4.numel() + 4 * n * 16 + nb),
        # each base's table, then per position one product per digit
        # that is not 0, less the first
        "mont_expprod_positions": bound(
            n * 14 + max(nz_short - ndig_s, 0), W,
            nb + 4 * n * 16 + 4 * K._ndig_pad(256) * L),
    }
    results = {}
    for name, (kern, plain, py) in cases.items():
        got, _ = timed(kern)  # first launch: compare, then time warm
        want, plain_ms = timed(plain)
        err = max_abs_err(got, want)
        if py is not None:
            if ctx.decode(got[rows]) != py(got):
                raise AssertionError(f"{name}: kernel != Python pow")
        else:
            # P_j = prod_i a_i^(d_ij): recombine and compare with pow
            want_int = 1
            for x, k in zip(a_int, e_short_int):
                want_int = want_int * pow(x, k, m) % m
            combined = K.mont_expprod(a, e_short, ctx.mod, 256)
            if ctx.decode(combined[None]) != [want_int]:
                raise AssertionError(f"{name}: multi-exp != Python pow")
        _, ms = timed(kern, reps=3)
        results[name] = {"N": n, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, **bounds[name]}
        kernel_line(name, results[name])
    return results


def max_abs_err(got, want) -> int:
    """Largest absolute limb difference of kernel and plain outputs (a
    tensor or a tuple of tensors); raises unless they are equal."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              if g.numel() else 0 for g, w in zip(got, want))
    if err != 0 or not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"kernel != plain (max abs {err})")
    return err


def kernel_line(name: str, r: dict) -> None:
    phase("kernel", name=name, N=r["N"], tolerance="exact", equal=True,
          max_abs_err=r["max_abs_err"], ms=f"{r['ms']:.3f}",
          plain_ms=f"{r['plain_ms']:.3f}", bound_ms=f"{r['bound_ms']:.4f}",
          bound_by=r["bound_by"])


# ------------------------------------------------------------ phase 4


def host_ec_add(p: int, a: int, P, Q):
    """Affine addition over Python ints (None = infinity)."""
    if P is None:
        return Q
    if Q is None:
        return P
    (x1, y1), (x2, y2) = P, Q
    if x1 == x2 and (y1 + y2) % p == 0:
        return None
    if P == Q:
        lam = (3 * x1 * x1 + a) * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    return x3, (lam * (x1 - x3) - y1) % p


def host_ec_mul(p: int, a: int, P, k: int):
    acc, add = None, P
    while k:
        if k & 1:
            acc = host_ec_add(p, a, acc, add)
        add = host_ec_add(p, a, add, add)
        k >>= 1
    return acc


def ec_bounds(n: int, e: torch.Tensor, ndig: int, table_words: int) -> dict:
    """Bounds of H5-H8 at P-256 on n points and exponents e of ndig 4-bit
    digits (the fixed-base table of table_words words)."""
    W, L = 8, 16
    nb = 4 * n * L  # one (n, L) int32 array
    nz = nonzero_digits(e, ndig, 4)
    return {
        # the table, 4 doublings between digits, one general addition per
        # digit that is not 0
        "ec_scalar_mul": bound(
            n * (EC_TABLE_PRODUCTS + 4 * (ndig - 1) * EC_DOUBLE_PRODUCTS)
            + nz * EC_ADD_PRODUCTS, W, 2 * nb + n + nb + 3 * nb),
        # each point's table, then per position one addition per digit
        # that is not 0, less the first
        "ec_multiexp_positions": bound(
            n * EC_TABLE_PRODUCTS + max(nz - ndig, 0) * EC_ADD_PRODUCTS,
            W, 2 * nb + n + nb + 3 * 4 * ndig * L),
        # one mixed addition of an affine table row per digit that is not 0
        "ec_fb_exp": bound(nz * EC_MADD_PRODUCTS, W,
                           4 * table_words + nb + 3 * nb),
        "ec_point_add": bound(n * EC_ADD_PRODUCTS, W, 6 * nb + 3 * nb),
    }


EC_CHECK_N = 4096  # the small EC check, beside the one at --ec-n


def check_ec_kernels(n: int) -> dict:
    """H5-H8 at P-256 on n points: kernel == plain on the whole batch, a
    few rows against Python EC arithmetic, times; H7 also against H5 on
    g.  Run at 4096 points and at the EC path's batch (--ec-n), where H6
    splits the points into its widest lanes."""
    from vmn_tpu_torch.arith import ec as EC
    from vmn_tpu_torch.crypto.hash import SHA256
    from vmn_tpu_torch.crypto.prg import PRGHeuristic
    from vmn_tpu_torch.ops import ec_kernels as E

    dev = torch.device("cuda", 0)
    grp = EC.ECqPGroup.named("P-256", device=dev)
    mod, p, a, q = grp.ctx.mod, grp.p, grp.a, grp.n
    L = grp.L
    prg = PRGHeuristic(SHA256)
    prg.set_seed(SHA256.hash(b"smoke-ec-points"))
    pts = grp.random_array(n, prg, 8)
    x, y = pts.x.clone(), pts.y.clone()
    inf = pts.inf.clone()
    x[0], y[0], inf[0] = 0, 0, True  # row 0: the point at infinity
    rng = np.random.default_rng(256)
    ks = [int.from_bytes(rng.bytes(40), "big") % q for _ in range(n)]
    ks[1], ks[2], ks[3] = 0, q - 1, 1
    e = grp.ring.from_ints(ks).limbs
    nbits = 256
    ndig = nbits // 4
    X, Y, Z = E.ec_scalar_mul(x, y, inf, e, mod, nbits)
    # H8 pairs: rows 0-2 add a point to itself (row 0: infinity +
    # infinity), row 3 its negative; the rest pair the batch with its
    # reverse (the last row: P + infinity).  Non-trivial Z from H5.
    idx = torch.arange(n - 1, -1, -1, device=dev)
    idx[:4] = torch.arange(4, device=dev)
    j1 = (X, Y, Z)
    j2 = [t[idx] for t in j1]
    j2[1][3] = grp.ctx.neg(Y[3])
    tbx, tby = EC._ec_fb_table(grp.curve, *grp.g._jac(), ndig)
    gx = grp.g.x.expand(n, L).contiguous()
    gy = grp.g.y.expand(n, L).contiguous()
    no_inf = torch.zeros(n, dtype=torch.bool, device=dev)

    def affine(jac):
        return grp.to_affine(EC.ECArray(grp, *grp.curve.normalize(*jac)))

    in_pts = [None] + pts.copy_of_range(1, n).to_affine()
    rows = sorted({0, 1, 2, 3, 4, n // 3, n // 2, n - 1})
    G = (grp.gx, grp.gy)
    bnds = ec_bounds(n, e, ndig, tbx.numel() + tby.numel())
    cases = {
        "ec_scalar_mul": (
            lambda: E.ec_scalar_mul(x, y, inf, e, mod, nbits),
            lambda: E.ec_scalar_mul_plain(x, y, inf, e, mod, nbits),
            lambda out: [host_ec_mul(p, a, in_pts[i], ks[i])
                         if in_pts[i] else None for i in rows]),
        "ec_multiexp_positions": (
            lambda: E.ec_multiexp_positions(x, y, inf, e, mod, nbits),
            lambda: E.ec_multiexp_positions_plain(x, y, inf, e, mod, nbits),
            None),
        "ec_fb_exp": (
            lambda: E.ec_fb_exp(tbx, tby, e, mod),
            lambda: E.ec_fb_exp_plain(tbx, tby, e, mod),
            lambda out: [host_ec_mul(p, a, G, ks[i]) for i in rows]),
        "ec_point_add": (
            lambda: E.ec_point_add(*j1, *j2, mod),
            lambda: E.ec_point_add_plain(*j1, *j2, mod),
            None),
    }
    results = {}
    smul_aff = None
    for name, (kern, plain, py) in cases.items():
        got, _ = timed(kern)
        want, plain_ms = timed(plain)
        err = max_abs_err(got, want)
        if name == "ec_scalar_mul":
            smul_aff = affine(got)
            if [smul_aff[i] for i in rows] != py(got):
                raise AssertionError(f"{name}: kernel != Python EC")
        elif name == "ec_multiexp_positions":
            acc = None
            for pt in smul_aff:
                acc = host_ec_add(p, a, acc, pt)
            combined = E.ec_multiexp(x, y, inf, e, mod, nbits)
            if affine(tuple(t[None] for t in combined)) != [acc]:
                raise AssertionError(f"{name}: multi-exp != Python EC")
        elif name == "ec_fb_exp":
            if [affine(got)[i] for i in rows] != py(got):
                raise AssertionError(f"{name}: kernel != Python EC")
        else:
            second = [smul_aff[k] for k in idx.tolist()]
            s3 = smul_aff[3]
            second[3] = None if s3 is None else (s3[0], (-s3[1]) % p)
            got_aff = affine(got)
            if ([got_aff[i] for i in rows]
                    != [host_ec_add(p, a, smul_aff[i], second[i])
                        for i in rows]):
                raise AssertionError(f"{name}: kernel != Python EC")
        _, ms = timed(kern, reps=3)
        results[name] = {"N": n, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, **bnds[name]}
        kernel_line(name, results[name])
    # The routing fact for fixed-base powers: H7 against H5 on g.
    _, fb_ms = timed(lambda: E.ec_fb_exp(tbx, tby, e, mod), reps=3)
    _, sm_ms = timed(lambda: E.ec_scalar_mul(gx, gy, no_inf, e, mod, nbits),
                     reps=3)
    results["ec_fb_exp"]["vs_ec_scalar_mul_on_g"] = {"fb_ms": fb_ms,
                                                     "smul_ms": sm_ms}
    phase("fixed-base", base="g", N=n, bits=nbits, h7_ms=f"{fb_ms:.3f}",
          h5_ms=f"{sm_ms:.3f}", h5_over_h7=f"{sm_ms / fb_ms:.2f}")
    return results


# ---------------------------------------------------------- phases 5-7


def run_mix(params, msgs, workdir: Path, party_seed: bytes,
            ciph_seed: bytes):
    """keygen -> encrypt the message array `msgs` -> mix; returns (nizkp
    dir, plaintext array, mix seconds, kernel launches of the mix
    alone)."""
    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.ops import ec_kernels as E
    from vmn_tpu_torch.ops import mont_kernels as K
    from vmn_tpu_torch.protocol import elgamal
    from vmn_tpu_torch.protocol.com.board import LocalBoardHub
    from vmn_tpu_torch.protocol.mixnet.party import MixNetParty

    group = params.pgroup
    party = MixNetParty(params, LocalBoardHub(1).board(1),
                        SeededSource(party_seed), str(workdir))
    pk = party.keygen()
    r = group.ring.random((msgs.size,), SeededSource(ciph_seed), 0)
    ciphs = elgamal.encrypt(pk, msgs, r)
    party.board = LocalBoardHub(1).board(1)
    session = party.session(params.sid.lower(), 1)
    torch.cuda.synchronize()
    K.reset_launches()
    E.reset_launches()
    t0 = time.perf_counter()
    plain = session.mix(ciphs)
    torch.cuda.synchronize()
    mix_s = time.perf_counter() - t0
    launches = {**K.LAUNCHES, **E.LAUNCHES}
    return session.nizkp, plain, mix_s, launches


def _group(name: str):
    """A named group on the card: an NIST curve or a ModP group."""
    if name.startswith("P-"):
        from vmn_tpu_torch.arith.ec import ECqPGroup

        return ECqPGroup.named(name, device="cuda")
    from vmn_tpu_torch.arith.pgroup import ModPGroup

    return ModPGroup.named(name, device="cuda")


def _params(sid: str, group):
    from vmn_tpu_torch.protocol.context import ProtocolParams

    return ProtocolParams(sid=sid, k=1, threshold=1, pgroup=group)


def _points(group, arr):
    """Plaintexts as sortable host values: ints (ModP) or affine points."""
    return arr.to_affine() if hasattr(arr, "to_affine") else arr.to_ints()


def verify(params, nizkp: Path):
    from vmn_tpu_torch.protocol.mixnet.verifier import FiatShamirVerifier

    t0 = time.perf_counter()
    res = FiatShamirVerifier(params, nizkp).verify(expected_type="mixing")
    torch.cuda.synchronize()
    return res.ok, time.perf_counter() - t0


def tampered_rejected(params, nizkp: Path, tmp: Path) -> bool:
    bad = tmp / f"tampered_{params.sid}"
    shutil.copytree(nizkp, bad)
    reply = bad / "proofs" / "PoSReply01.bt"
    raw = bytearray(reply.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    reply.write_bytes(bytes(raw))
    ok, _ = verify(params, bad)
    return not ok


def golden_phase(tmp: Path, name: str) -> None:
    """The golden k=1 mix of tools/make_golden.py on the card: test256
    (5 messages) or P-256 (3 messages); transcript byte-equal."""
    t0 = time.perf_counter()
    group = _group(name)
    n, make = ((3, group.from_affine) if name.startswith("P-")
               else (5, group.from_ints))
    golden = GOLDEN / f"nizkp_{name.replace('-', '').lower()}_k1"
    params = _params("Golden", group)
    msgs = [group.encode_message(f"{i:08d}".encode()) for i in range(n)]
    nizkp, plain, mix_s, launches = run_mix(
        params, make(msgs), tmp / f"golden_{name}", b"golden-party",
        b"golden-ciphs")
    files = sorted(p.relative_to(golden) for p in golden.rglob("*")
                   if p.is_file())
    got = sorted(p.relative_to(nizkp) for p in nizkp.rglob("*")
                 if p.is_file())
    if files != got:
        raise AssertionError(f"golden file sets differ: {got} != {files}")
    for rel in files:
        if (nizkp / rel).read_bytes() != (golden / rel).read_bytes():
            raise AssertionError(f"golden transcript differs in {rel}")
    if sorted(_points(group, plain)) != sorted(msgs):
        raise AssertionError("golden plaintext multiset differs")
    ok, _ = verify(params, nizkp)
    if not ok:
        raise AssertionError("port verifier rejected the golden transcript")
    phase("golden", group=name, files=len(files), byte_equal=True,
          verify_ok=True, mix_s=f"{mix_s:.3f}",
          launches=json.dumps({k: v for k, v in launches.items() if v},
                              separators=(",", ":")),
          phase_s=f"{time.perf_counter() - t0:.1f}")


def slice_phase(name: str, n: int, tmp: Path) -> dict:
    """A mix path at N ciphertexts; returns each wrapper's launches in
    its mix."""
    from vmn_tpu_torch.crypto.hash import SHA256
    from vmn_tpu_torch.crypto.prg import PRGHeuristic

    t0 = time.perf_counter()
    group = _group(name)
    params = _params(f"Smoke{name.replace('-', '')}", group)
    # Messages: group elements from a seeded PRG, made on the device as
    # bench.py makes them (encoding N strings would cost one Python pow
    # each, minutes of set-up at these N).
    prg = PRGHeuristic(SHA256)
    prg.set_seed(SHA256.hash(b"smoke-msgs"))
    m = group.random_array(n, prg, params.rbitlen)
    msgs = _points(group, m)
    torch.cuda.reset_peak_memory_stats()
    nizkp, plain, mix_s, launches = run_mix(
        params, m, tmp / f"slice_{name}", b"smoke-party",
        b"smoke-ciphs")
    if sorted(_points(group, plain)) != sorted(msgs):
        raise AssertionError("plaintext multiset not preserved")
    ok, verify_s = verify(params, nizkp)
    if not ok:
        raise AssertionError("port verifier rejected the mix transcript")
    peak = torch.cuda.max_memory_allocated()
    if not tampered_rejected(params, nizkp, tmp):
        raise AssertionError("tampered transcript accepted")
    phase("slice", group=name, k=1, N=n, multiset=True,
          verify_ok=True, tampered_rejected=True,
          mix_s=f"{mix_s:.3f}", verify_s=f"{verify_s:.3f}",
          mix_cps=f"{n / mix_s:.1f}", verify_cps=f"{n / verify_s:.1f}",
          max_memory_allocated=peak,
          phase_s=f"{time.perf_counter() - t0:.1f}")
    return launches


SPANS = (  # (module, class, method) timed as host spans by --profile
    ("vmn_tpu_torch.protocol.mixnet.party", "MixSession", "mix"),
    ("vmn_tpu_torch.protocol.mixnet.verifier", "FiatShamirVerifier",
     "verify"),
    ("vmn_tpu_torch.protocol.mixnet.party", "MixSession", "shuffle"),
    ("vmn_tpu_torch.protocol.mixnet.party", "MixSession", "decrypt"),
    ("vmn_tpu_torch.protocol.hvzk.pos_tw", "PoSProver", "precompute"),
    ("vmn_tpu_torch.protocol.hvzk.pos_tw", "PoSProver", "commit"),
    ("vmn_tpu_torch.protocol.hvzk.pos_tw", "PoSProver", "reply"),
    ("vmn_tpu_torch.protocol.hvzk.pos_tw", "PoSVerifier", "compute_AF"),
    ("vmn_tpu_torch.protocol.hvzk.pos_tw", "PoSVerifier", "set_commitment"),
    ("vmn_tpu_torch.protocol.hvzk.pos_tw", "PoSVerifier", "verify"),
    ("vmn_tpu_torch.protocol.context", "ProtocolContext",
     "independent_generators"),
)


def profile_phase(name: str, n: int, tmp: Path) -> None:
    """One more mix + verify of a path under torch.profiler: host spans
    (synchronised at entry and exit), device time by kernel and the
    device idle share over the mix + verify window."""
    import functools
    import importlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def spanned(fn, label):
        @functools.wraps(fn)
        def run(*a, **kw):
            torch.cuda.synchronize()
            with record_function(label):
                out = fn(*a, **kw)
                torch.cuda.synchronize()
            return out
        return run

    saved = []
    for modname, cls, meth in SPANS:
        owner = getattr(importlib.import_module(modname), cls)
        saved.append((owner, meth, getattr(owner, meth)))
        setattr(owner, meth, spanned(getattr(owner, meth), f"{cls}.{meth}"))
    try:
        from vmn_tpu_torch.crypto.hash import SHA256
        from vmn_tpu_torch.crypto.prg import PRGHeuristic

        group = _group(name)
        params = _params(f"Prof{name.replace('-', '')}", group)
        prg = PRGHeuristic(SHA256)
        prg.set_seed(SHA256.hash(b"smoke-msgs"))
        m = group.random_array(n, prg, params.rbitlen)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            nizkp, _, mix_s, _ = run_mix(params, m, tmp / "prof",
                                         b"smoke-party", b"smoke-ciphs")
            ok, verify_s = verify(params, nizkp)
    finally:
        for owner, meth, fn in saved:
            setattr(owner, meth, fn)
    if not ok:
        raise AssertionError("profiled transcript rejected")
    names = {f"{c}.{m}" for _, c, m in SPANS}
    spans, ranges, kernels, ivals = {}, {}, {}, []
    events = list(prof.events())
    for e in events:
        if e.device_type != DeviceType.CUDA and e.name in names:
            spans[e.name] = spans.get(e.name, 0.0) + e.time_range.elapsed_us()
            ranges[e.name] = (e.time_range.start, e.time_range.end)
    # the window: from the start of session.mix to the verifier's return
    lo = ranges["MixSession.mix"][0]
    hi = ranges["FiatShamirVerifier.verify"][1]
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        # device events, less the spans' own annotation ranges
        if (e.device_type == DeviceType.CUDA and e.name not in names
                and t > lo and s < hi):
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += t - s
            k[1] += 1
            ivals.append((max(s, lo), min(t, hi)))
    busy, end = 0.0, -1.0
    for s, t in sorted(ivals):
        if t > end:
            busy += t - max(s, end)
            end = t
    window_us = hi - lo
    phase("profile", group=name, N=n, mix_s=f"{mix_s:.3f}",
          verify_s=f"{verify_s:.3f}", device_busy_s=f"{busy / 1e6:.3f}",
          idle_share=f"{1 - busy / window_us:.3f}",
          device_events=len(ivals))
    for name, us in sorted(spans.items(), key=lambda kv: -kv[1]):
        print(f"  span {name} s={us / 1e6:.3f}")
    for name, (us, cnt) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  device {name[:60]} s={us / 1e6:.3f} "
              f"share={us / busy:.3f} launches={cnt}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=10000,
                    help="ciphertexts in the modp2048 mix (default 10000)")
    ap.add_argument("--ec-n", type=int, default=1 << 17,
                    help="ciphertexts in the P-256 mix (default 131072)")
    ap.add_argument("--profile", choices=["modp2048", "P-256"],
                    help="after the phases, profile one more mix + verify "
                         "of this path (host spans, device time by kernel, "
                         "device idle share)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    from vmn_tpu_torch.ops import ec_kernels as E
    from vmn_tpu_torch.ops import mont_kernels as K

    card = card_line()
    phase("env", python=sys.version.split()[0], torch=torch.__version__,
          cuda=torch.version.cuda, card=f"'{card}'",
          devices=torch.cuda.device_count())

    so = K.build_kernels()
    phase("build", seconds=f"{K.BUILD_INFO['seconds']:.1f}", lib=so.name)
    for line in ptxas_summary(K.BUILD_INFO["ptxas"]):
        print("  ptxas " + line)

    t0 = time.perf_counter()
    checks = check_kernels(args.n)
    ec_small = check_ec_kernels(EC_CHECK_N)
    checks.update(check_ec_kernels(args.ec_n))
    for name, r in ec_small.items():
        checks[name][f"at_{EC_CHECK_N}"] = r
    phase("kernels", checked=len(checks),
          phase_s=f"{time.perf_counter() - t0:.1f}")

    with tempfile.TemporaryDirectory(prefix="vmn_smoke_") as tmpname:
        tmp = Path(tmpname)
        golden_phase(tmp, "test256")
        golden_phase(tmp, "P-256")
        modp = slice_phase("modp2048", args.n, tmp)
        ec = slice_phase("P-256", args.ec_n, tmp)
        if args.profile:
            profile_phase(args.profile,
                          args.ec_n if args.profile == "P-256" else args.n,
                          tmp)
    phase("launches", modp2048_mix=json.dumps(modp, separators=(",", ":")),
          p256_mix=json.dumps(ec, separators=(",", ":")))
    missing = [k for k in K.KERNELS if modp[k] == 0]
    missing += [k for k in E.EC_KERNELS if ec[k] == 0 and k != "ec_fb_exp"]
    if missing:
        raise AssertionError(f"not launched in their path's mix: {missing}")
    phase("done", elapsed_s=f"{time.perf_counter() - t_start:.1f}")

    torch.cuda.synchronize()
    kernels = []
    for name in (*K.KERNELS, *E.EC_KERNELS):
        is_ec = name in E.EC_KERNELS
        kernels.append({
            "name": name, "route": "cuda",
            "source": "vmn_tpu_torch/csrc/"
                      + ("ec_kernels.cu" if is_ec else "mont_kernels.cu"),
            "replaces": REPLACES[name],
            "launches": (ec if is_ec else modp)[name],
            "path": "P-256 mix" if is_ec else "modp2048 mix",
            **checks[MAIN_CHECK[name]]})
    kernels[K.KERNELS.index("mont_fb_exp")].update(
        window=8, window4={"replaces": "vmn_tpu/ops/mont_kernels.py:487",
                           "exponent_bits": 256, **checks["mont_fb_exp4"]})
    kernels[len(K.KERNELS) + E.EC_KERNELS.index("ec_fb_exp")].update(
        note="off the mix path, as in vmn_tpu (arith/ec.py _exp_impl)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Drive the vmn_tpu_torch mix path once on one CUDA card.

Usage:  python3 chip_smoke.py [--n N]

Phases (one line each; any failure raises and the exit code is not 0):
  1. environment: torch/CUDA versions and the card's name and power limit;
  2. build the Hopper kernels from vmn_tpu_torch/csrc with nvcc;
  3. check H1 mont_mul, H2 mont_exp, H3 mont_fb_exp (windows 4 and 8) and
     H4 mont_expprod_positions at modp2048 width against their plain
     PyTorch versions on the card (exact equality, a few rows against
     Python pow) and time both;
  4. the test256 golden mix on the card: the transcript must equal
     tests/golden/nizkp_test256_k1 byte for byte;
  5. the slice: modp2048, k=1, N ciphertexts (default 10000): keygen,
     encryption, mix (shuffle + proof of shuffle + verifiable
     decryption), plaintext multiset check, the standalone verifier, and
     the same transcript with one flipped byte rejected.

Each mix zeroes the wrappers' launch counters just before `session.mix`
and reads them just after it.  Every wrapper must have launched its
kernel in the modp2048 mix, the main path; the `kernels` line reports
those counts.  The test256 golden mix's counts get a line of their own.
The last three lines are a JSON object of per-kernel results, the card's
name and power limit, and a JSON status object.
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
GOLDEN = REPO / "tests" / "golden" / "nizkp_test256_k1"

# Per wrapper: file:line of the Pallas kernel its Hopper kernel replaces,
# and the phase-3 check that holds the main path's shapes.  mont_fb_exp
# replaces both K4 (window 8, every fixed-base exponent of the modp2048
# mix) and K5 (window 4, exponents under 512 bits: test256 only).
REPLACES = {
    "mont_mul": "vmn_tpu/ops/mont_kernels.py:192",
    "mont_exp": "vmn_tpu/ops/mont_kernels.py:754",
    "mont_fb_exp": "vmn_tpu/ops/mont_kernels.py:443",
    "mont_expprod_positions": "vmn_tpu/ops/mont_kernels.py:616",
}
MAIN_CHECK = {"mont_mul": "mont_mul", "mont_exp": "mont_exp",
              "mont_fb_exp": "mont_fb_exp8",
              "mont_expprod_positions": "mont_expprod_positions"}


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
    results = {}
    for name, (kern, plain, py) in cases.items():
        got, _ = timed(kern)  # first launch: compare, then time warm
        want, plain_ms = timed(plain)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel != plain (max abs {err})")
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
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        phase("kernel", name=name, tolerance="exact", equal=True,
              max_abs_err=err, ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.3f}")
    return results


# ---------------------------------------------------------- phases 4-5


def run_mix(params, msgs, workdir: Path, party_seed: bytes,
            ciph_seed: bytes):
    """keygen -> encrypt the message array `msgs` -> mix; returns (nizkp
    dir, plaintext ints, mix seconds, kernel launches of the mix alone)."""
    from vmn_tpu_torch.crypto.randomsource import SeededSource
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
    t0 = time.perf_counter()
    plain = session.mix(ciphs)
    torch.cuda.synchronize()
    mix_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    return session.nizkp, plain.to_ints(), mix_s, launches


def _params(sid: str, group):
    from vmn_tpu_torch.protocol.context import ProtocolParams

    return ProtocolParams(sid=sid, k=1, threshold=1, pgroup=group)


def verify(params, nizkp: Path):
    from vmn_tpu_torch.protocol.mixnet.verifier import FiatShamirVerifier

    t0 = time.perf_counter()
    res = FiatShamirVerifier(params, nizkp).verify(expected_type="mixing")
    torch.cuda.synchronize()
    return res.ok, time.perf_counter() - t0


def tampered_rejected(params, nizkp: Path, tmp: Path) -> bool:
    bad = tmp / "tampered"
    shutil.copytree(nizkp, bad)
    reply = bad / "proofs" / "PoSReply01.bt"
    raw = bytearray(reply.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    reply.write_bytes(bytes(raw))
    ok, _ = verify(params, bad)
    return not ok


def golden_phase(tmp: Path) -> None:
    from vmn_tpu_torch.arith.pgroup import ModPGroup

    t0 = time.perf_counter()
    params = _params("Golden", ModPGroup.named("test256", device="cuda"))
    group = params.pgroup
    msgs = [group.encode_message(f"{i:08d}".encode()) for i in range(5)]
    nizkp, plain, mix_s, launches = run_mix(
        params, group.from_ints(msgs), tmp / "golden", b"golden-party",
        b"golden-ciphs")
    files = sorted(p.relative_to(GOLDEN) for p in GOLDEN.rglob("*")
                   if p.is_file())
    got = sorted(p.relative_to(nizkp) for p in nizkp.rglob("*")
                 if p.is_file())
    if files != got:
        raise AssertionError(f"golden file sets differ: {got} != {files}")
    for rel in files:
        if (nizkp / rel).read_bytes() != (GOLDEN / rel).read_bytes():
            raise AssertionError(f"golden transcript differs in {rel}")
    if sorted(plain) != sorted(msgs):
        raise AssertionError("golden plaintext multiset differs")
    ok, _ = verify(params, nizkp)
    if not ok:
        raise AssertionError("port verifier rejected the golden transcript")
    phase("golden", group="test256", files=len(files), byte_equal=True,
          verify_ok=True, mix_s=f"{mix_s:.3f}",
          launches=json.dumps(launches, separators=(",", ":")),
          phase_s=f"{time.perf_counter() - t0:.1f}")


def slice_phase(n: int, tmp: Path) -> dict:
    """The main path; returns each wrapper's launches in its mix."""
    from vmn_tpu_torch.arith.pgroup import ModPGroup
    from vmn_tpu_torch.crypto.hash import SHA256
    from vmn_tpu_torch.crypto.prg import PRGHeuristic

    t0 = time.perf_counter()
    params = _params("Smoke", ModPGroup.named("modp2048", device="cuda"))
    # Messages: group elements from a seeded PRG, made on the device as
    # bench.py makes them (encoding N strings would cost one 2048-bit
    # Python pow each, minutes of set-up at N=10000).
    prg = PRGHeuristic(SHA256)
    prg.set_seed(SHA256.hash(b"smoke-msgs"))
    m = params.pgroup.random_array(n, prg, params.rbitlen)
    msgs = m.to_ints()
    torch.cuda.reset_peak_memory_stats()
    nizkp, plain, mix_s, launches = run_mix(
        params, m, tmp / "slice", b"smoke-party", b"smoke-ciphs")
    if sorted(plain) != sorted(msgs):
        raise AssertionError("plaintext multiset not preserved")
    ok, verify_s = verify(params, nizkp)
    if not ok:
        raise AssertionError("port verifier rejected the mix transcript")
    peak = torch.cuda.max_memory_allocated()
    if not tampered_rejected(params, nizkp, tmp):
        raise AssertionError("tampered transcript accepted")
    phase("slice", group="modp2048", k=1, N=n, multiset=True,
          verify_ok=True, tampered_rejected=True,
          mix_s=f"{mix_s:.3f}", verify_s=f"{verify_s:.3f}",
          mix_cps=f"{n / mix_s:.1f}", verify_cps=f"{n / verify_s:.1f}",
          max_memory_allocated=peak,
          phase_s=f"{time.perf_counter() - t0:.1f}")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=10000,
                    help="ciphertexts in the modp2048 mix (default 10000)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

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
    phase("kernels", checked=len(checks),
          phase_s=f"{time.perf_counter() - t0:.1f}")

    with tempfile.TemporaryDirectory(prefix="vmn_smoke_") as tmpname:
        tmp = Path(tmpname)
        golden_phase(tmp)
        counts = slice_phase(args.n, tmp)
    phase("launches", modp2048_mix=json.dumps(counts, separators=(",", ":")))
    missing = [k for k in K.KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"not launched in the modp2048 mix: {missing}")
    phase("done", elapsed_s=f"{time.perf_counter() - t_start:.1f}")

    torch.cuda.synchronize()
    kernels = [
        {"name": name, "route": "cuda",
         "source": "vmn_tpu_torch/csrc/mont_kernels.cu",
         "replaces": REPLACES[name], "launches": counts[name],
         **checks[MAIN_CHECK[name]]}
        for name in K.KERNELS
    ]
    kernels[K.KERNELS.index("mont_fb_exp")].update(
        window=8, window4={"replaces": "vmn_tpu/ops/mont_kernels.py:487",
                           "exponent_bits": 256, **checks["mont_fb_exp4"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Shared helpers of the `vmn_tpu_torch` port tests.

Inputs are made from a seed with numpy and handed to both packages; the
port's limbs come back as uint32 numpy arrays so that a comparison with
`vmn_tpu` is plain array equality.  Everything compared is integer
arithmetic, so every tolerance in these tests is exact equality.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

# Keep torch from starving the other test workers.
torch.set_num_threads(2)

TEST256_P = int(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff72ef", 16
)


# The verifier's test-vector names that tools/make_golden.py requests
# (copied: that script imports jax at module level).
TV_NAMES = [
    "par.sid", "par.version", "par.k", "par.lambda", "par.n_e",
    "par.n_r", "par.n_v", "par.s_PRG", "par.s_Gq", "par.s_H",
    "par.omega", "der.rho", "bas.pk", "bas.C_omega", "bas.M_omega",
    "bas.R_omega", "bas.h", "bas.L_0", "bas.L_l", "bas.y_l", "u",
    "PoS.s", "PoS.v", "PoS.A", "PoS.F", "PoS.B", "PoS.Ap", "PoS.Bp",
    "PoS.Cp", "PoS.Dp", "PoS.Fp", "PoS.C", "PoS.D", "PoS.k_A",
    "PoS.k_B", "PoS.k_C", "PoS.k_D", "PoS.k_E", "PoS.k_F", "Dec.s",
    "Dec.v",
    # precomputation-mode names (PoSC + CCPoS chains)
    "par.N_0", "PoSC.s", "PoSC.v", "CCPoS.s", "CCPoS.v",
]


def golden_files(root) -> list:
    """Relative paths of the files under a transcript directory."""
    return sorted(p.relative_to(root) for p in root.rglob("*")
                  if p.is_file())


GOLDEN = Path(__file__).parent / "golden"


def curve_golden(curve: str):
    """(transcript directory, test-vector file) of a curve's k=1 golden
    (tests/torch_make_wide_golden.py; P-256's by tools/make_golden.py)."""
    tag = curve.replace("-", "").lower()
    return GOLDEN / f"nizkp_{tag}_k1", GOLDEN / f"test_vectors_{tag}.json"


def curve_params(curve: str, device="cpu"):
    """The port's protocol parameters of the k=1 goldens over `curve`."""
    from vmn_tpu_torch.arith.ec import ECqPGroup
    from vmn_tpu_torch.protocol.context import ProtocolParams

    return ProtocolParams(sid="Golden", k=1, threshold=1,
                          pgroup=ECqPGroup.named(curve, device=device))


def curve_golden_mix(curve: str, device, out, n: int = 3):
    """The golden k=1 mix of tools/make_golden.py (its seeds) by the port
    over `curve` on `device`: (nizkp dir, messages, plaintext points)."""
    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.protocol import elgamal
    from vmn_tpu_torch.protocol.com.board import LocalBoardHub
    from vmn_tpu_torch.protocol.mixnet.party import MixNetParty

    params = curve_params(curve, device)
    group = params.pgroup
    party = MixNetParty(params, LocalBoardHub(1).board(1),
                        SeededSource(b"golden-party"), str(out))
    pk = party.keygen()
    msgs = [group.encode_message(f"{i:08d}".encode()) for i in range(n)]
    r = group.ring.random((n,), SeededSource(b"golden-ciphs"), 0)
    ciphs = elgamal.encrypt(pk, group.from_affine(msgs), r)
    party.board = LocalBoardHub(1).board(1)
    plain = party.session("golden", 1).mix(ciphs)
    return Path(out) / "nizkp.golden", msgs, plain.to_affine()


def assert_same_transcript(nizkp, golden) -> None:
    """The transcript under nizkp holds golden's files, byte for byte."""
    assert golden_files(nizkp) == golden_files(golden)
    for rel in golden_files(golden):
        assert (nizkp / rel).read_bytes() == (golden / rel).read_bytes(), rel


def flipped_reply_copy(golden, dest):
    """A copy of the transcript golden under dest with the last byte of
    its proof-of-shuffle reply flipped."""
    import shutil

    shutil.copytree(golden, dest)
    reply = Path(dest) / "proofs" / "PoSReply01.bt"
    raw = bytearray(reply.read_bytes())
    raw[-1] ^= 0x01
    reply.write_bytes(bytes(raw))
    return Path(dest)


def record_calls(mp, calls: dict) -> None:
    """Count each kernel wrapper's calls into `calls`, through every
    loaded module that holds the wrapper under its name (mp: a pytest
    MonkeyPatch, which puts the wrappers back)."""
    import sys

    from vmn_tpu_torch.ops import ec_kernels as E
    from vmn_tpu_torch.ops import mont_kernels as K

    for owner, names in ((K, K.KERNELS), (E, E.EC_KERNELS)):
        for name in names:
            fn = getattr(owner, name)

            def counted(*args, _fn=fn, _name=name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*args, **kw)

            for m in list(sys.modules.values()):
                if getattr(m, name, None) is fn:
                    mp.setattr(m, name, counted)


def run_parties(k: int, fn, parties=None) -> list:
    """fn(j) in one thread for each party j in `parties` (default
    1..k), as the mix-servers of one process; 1-based results.  A
    party's exception fails the call."""
    import threading
    import traceback

    parties = list(range(1, k + 1)) if parties is None else parties
    results, errors = [None] * (k + 1), []

    def run(j):
        try:
            results[j] = fn(j)
        except Exception:  # noqa: BLE001 - surfaced below
            errors.append(traceback.format_exc())

    threads = [threading.Thread(target=run, args=(j,), daemon=True)
               for j in parties]
    [th.start() for th in threads]
    [th.join(timeout=900) for th in threads]
    assert not errors, errors[0]
    return results


def modp2048_p() -> int:
    from vmn_tpu_torch.arith.pgroup import _RFC3526_2048

    return _RFC3526_2048


def group_file(name: str) -> dict:
    """The group of tests/golden/group_{name}.json, as
    tests/torch_make_wide_golden.py writes it: a fresh one (vog1024,
    vog1000: "seed") or an RFC 3526 one past 4096 bits (modp6144,
    modp8192: "source"); p, q and g as ints, "bits" and the rest as
    written."""
    f = json.loads((GOLDEN / f"group_{name}.json").read_text())
    return {**f, **{k: int(f[k], 16) for k in ("p", "q", "g")}}


def group_pqg(name: str) -> tuple:
    """(p, q, g) of a group file (`group_file`)."""
    f = group_file(name)
    return f["p"], f["q"], f["g"]


def modulus(name: str) -> int:
    """The modulus of test256, of a named RFC 3526 group (modp2048,
    modp3072, modp4096) or of a group file (`group_file`)."""
    from vmn_tpu_torch.arith.pgroup import _NAMED_GROUPS

    if name == "test256":
        return TEST256_P
    if name in _NAMED_GROUPS:
        return _NAMED_GROUPS[name][0]
    return group_pqg(name)[0]


# The group of each width W = L/2 of the Montgomery kernels.
WIDTH_GROUP = {8: "test256", 32: "vog1024", 64: "modp2048", 96: "modp3072",
               128: "modp4096", 192: "modp6144", 256: "modp8192"}


def rand_ints(rng: np.random.Generator, n: int, bound: int) -> list:
    """n integers in [0, bound) from numpy bytes."""
    nbytes = (bound.bit_length() + 7) // 8 + 8
    return [int.from_bytes(rng.bytes(nbytes), "big") % bound
            for _ in range(n)]


def edge_values(m: int) -> list:
    return [0, 1, 2, m - 1, m - 2, m // 2, 3, m // 3]


def limbs_np(ints, L: int) -> np.ndarray:
    from vmn_tpu_torch.arith.limbs import ints_to_limbs

    return ints_to_limbs(list(ints), L)


def as_np(t) -> np.ndarray:
    """Port tensor or JAX array -> uint32 numpy limbs."""
    if isinstance(t, torch.Tensor):
        return t.cpu().numpy().astype(np.uint32)
    return np.asarray(t).astype(np.uint32)


def host_ec_add(p: int, a: int, P, Q):
    """Affine point addition on y^2 = x^3 + ax + b over Python ints;
    None is the point at infinity."""
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
    """k·P by double-and-add over Python ints."""
    acc, add = None, P
    while k:
        if k & 1:
            acc = host_ec_add(p, a, acc, add)
        add = host_ec_add(p, a, add, add)
        k >>= 1
    return acc


def vmn_tpu_exp_prod(jgrp, x, y, inf, e, nbits: int):
    """vmn_tpu's `exp_prod` of port points (Montgomery limbs x, y and the
    infinity mask) and exponent limbs e, on its CPU route: scalar
    multiples on its XLA path and a product tree (Pallas serves it on the
    TPU alone, vmn_tpu/arith/ec.py:922-953; its multi-exponentiation
    kernel in interpret mode costs several times as long).  Its
    normalized (x, y, inf) as numpy arrays, flattened."""
    import jax.numpy as jnp
    from vmn_tpu.arith.ec import ECArray
    from vmn_tpu.arith.pgroup import FArray

    pts = ECArray(jgrp, jnp.asarray(as_np(x)), jnp.asarray(as_np(y)),
                  jnp.asarray(np.asarray(inf.cpu())))
    out = pts.exp_prod(FArray(jgrp.ring, jnp.asarray(as_np(e))), nbits)
    return tuple(np.asarray(t).reshape(-1) for t in (out.x, out.y, out.inf))


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100, see README)")
    return torch.device("cuda", 0)


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn_ranks(argv: list, nranks: int, triplet: bool = True) -> list:
    """`nranks` started processes of `python argv` (from the repository
    root, one torch thread each), joined by the VMN_DIST_* triplet on a
    free localhost port (without it where `triplet` is False); collect
    them with `join_ranks`."""
    import os
    import subprocess
    import sys

    repo = Path(__file__).resolve().parent.parent
    port = free_port()
    procs = []
    for i in range(nranks):
        env = {**os.environ, "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join(
                   [str(repo), *filter(None, [os.environ.get("PYTHONPATH")])])}
        if triplet:
            env.update(VMN_DIST_COORD=f"localhost:{port}",
                       VMN_DIST_NPROC=str(nranks), VMN_DIST_PROCID=str(i))
        procs.append(subprocess.Popen(
            [sys.executable, *argv], env=env, cwd=str(repo),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return procs


def join_ranks(procs: list, timeout: float = 240) -> list:
    """[(exit code, output)] of `spawn_ranks`' processes; past `timeout`
    seconds every one still running is killed and the call fails, so
    that a rank that hangs in a collective fails its test."""
    import subprocess
    import time

    end = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, end - time.monotonic()))
            outs.append((p.returncode, out.decode()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise AssertionError(f"a rank did not end within {timeout} s")
    return outs

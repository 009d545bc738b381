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
    msgs = messages(group, n)
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


# ------------------------------------------------ boards that misbehave


class TamperBoard:
    """Board proxy that mutates matching labels at publish time, so every
    OTHER party receives the corrupted message while the misbehaving
    party's local state keeps the original."""

    def __init__(self, inner, match, mutate):
        self._inner = inner
        self._match = match
        self._mutate = mutate

    def publish(self, label, data):
        if self._match(label):
            data = self._mutate(data)
        return self._inner.publish(label, data)

    def scope(self, sid):
        return TamperBoard(self._inner.scope(sid), self._match,
                           self._mutate)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class CrashBoard:
    """Board proxy that simulates a crash: forwards the matching
    publish, then raises — the party dies right after its message
    reaches the board."""

    class Crash(Exception):
        pass

    def __init__(self, inner, label):
        self._inner = inner
        self._label = label

    def publish(self, label, data):
        self._inner.publish(label, data)
        if label == self._label:
            raise CrashBoard.Crash(label)

    def scope(self, sid):
        return CrashBoard(self._inner.scope(sid), self._label)

    def __getattr__(self, name):
        return getattr(self._inner, name)


# ------------------------------------- the check matrix and adversaries
#
# The port's copies of the runs of tests/test_matrix.py (`_run_mix`) and
# tests/test_adversarial.py, on any device: the tests hold them to
# `vmn_tpu` on the CPU, chip_smoke.py runs them on the card.

ADV_K, ADV_T, ADV_N = 3, 2, 5  # tests/test_adversarial.py's k, t and N


def matrix_params(name: str, device="cpu"):
    """(the port's ProtocolParams, width) of a check-matrix golden
    (tests/torch_make_wide_golden.py's MATRIX) over test256."""
    from torch_make_wide_golden import MATRIX
    from vmn_tpu_torch.arith.pgroup import ModPGroup
    from vmn_tpu_torch.protocol.context import ProtocolParams

    kw, width = MATRIX[name]
    return ProtocolParams(pgroup=ModPGroup.named("test256", device=device),
                          **kw), width


def messages(group, n: int) -> list:
    """The encoded messages f"{i:08d}" of the golden and matrix runs."""
    return [group.encode_message(f"{i:08d}".encode()) for i in range(n)]


def matrix_ciphertexts(params, party, width: int, n: int = 5):
    """tests/test_matrix.py's `_run_mix` ciphertexts under `party`'s
    joint key: messages f"{i:08d}" in each of the key width's components
    and each of the `width` plaintext components, randomness from
    SeededSource(b"ciphertexts").  (messages, ciphertexts)."""
    from vmn_tpu_torch.crypto.randomsource import SeededSource

    msgs = messages(params.pgroup, n)
    return msgs, widened_ciphertexts(params, party, params.pgroup.from_ints(
        msgs), width, SeededSource(b"ciphertexts"))


def widened_ciphertexts(params, party, enc, width: int, source):
    """The group elements `enc` in each of the key width's components and
    each of the `width` plaintext components, encrypted under `party`'s
    joint key with randomness from `source` (tests/test_matrix.py's
    `_run_mix`)."""
    from vmn_tpu_torch.arith.pgroup import PPArray
    from vmn_tpu_torch.protocol import elgamal

    key_grp = party.ctx.key_group()
    m = enc if params.keywidth == 1 else key_grp.product(
        *[enc] * params.keywidth)
    if width > 1:
        m = PPArray(elgamal.plain_group(key_grp, width), (m,) * width)
    r = elgamal.plain_group(key_grp, width).ring.random(
        (enc.size,), source, 0)
    return elgamal.encrypt(party.full_public_key().widen(width), m, r)


def first_leaf(out):
    """The first component of a (nested) product-group array."""
    while hasattr(out, "project") and hasattr(out, "components"):
        out = out.project(0)
    return out


def matrix_mix(root: Path, params, width: int, auxsid: str = "mx"):
    """tests/test_matrix.py's `_run_mix` by the port: keygen of the k
    parties (SeededSource(f"party{j}"), directories root/Party{j:02d}),
    then their mix of `matrix_ciphertexts` in threads.  (messages, the
    parties' outputs, party 1's nizkp directory)."""
    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.protocol.com.board import LocalBoardHub
    from vmn_tpu_torch.protocol.mixnet.party import MixNetParty

    k = params.k
    hub = LocalBoardHub(k)

    def keygen(j):
        party = MixNetParty(params, hub.board(j),
                            SeededSource(f"party{j}".encode()),
                            str(root / f"Party{j:02d}"))
        party.keygen()
        return party

    parties = run_parties(k, keygen)
    msgs, ciphs = matrix_ciphertexts(params, parties[1], width)
    hub = LocalBoardHub(k)

    def mix(j):
        parties[j].board = hub.board(j)
        return parties[j].session(auxsid, width).mix(ciphs)

    return msgs, run_parties(k, mix), root / "Party01" / f"nizkp.{auxsid}"


def adversary_params(sid: str, device="cpu", noninteractive=True):
    from vmn_tpu_torch.arith.pgroup import ModPGroup
    from vmn_tpu_torch.protocol.context import ProtocolParams

    return ProtocolParams(sid=sid, k=ADV_K, threshold=ADV_T,
                          noninteractive=noninteractive,
                          pgroup=ModPGroup.named("test256", device=device))


def adversary_ciphertexts(group, pk):
    """tests/test_adversarial.py's ciphertexts: the messages under pk with
    randomness from SeededSource(b"encr").  (messages, ciphertexts)."""
    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.protocol import elgamal

    msgs = messages(group, ADV_N)
    r = group.ring.random((ADV_N,), SeededSource(b"encr"), 0)
    return msgs, elgamal.encrypt(pk, group.from_ints(msgs), r)


def adversary_run(root: Path, params, boards, auxsid: str = "adv",
                  allow=()):
    """tests/test_adversarial.py's `_run_parties` by the port: each party
    j over boards[j] keygens (SeededSource(f"party{j}")), waits for the
    others and mixes the adversary ciphertexts under its own view of the
    joint key.  (messages, the parties' outputs); a party's exception
    fails the call, but a ProtocolError of a party in `allow` (the
    cheater) is its output."""
    import threading

    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.protocol.mixnet.party import MixNetParty, ProtocolError

    barrier = threading.Barrier(params.k)

    def run(j):
        party = MixNetParty(params, boards[j],
                            SeededSource(f"party{j}".encode()),
                            str(root / f"Party{j:02d}"))
        pk = party.keygen()
        barrier.wait()
        try:
            return party.session(auxsid, 1).mix(
                adversary_ciphertexts(params.pgroup, pk)[1])
        except ProtocolError as e:
            if j in allow:
                return e
            raise

    outs = run_parties(params.k, run)
    return messages(params.pgroup, ADV_N), outs


def adversary_garbage_factors(root: Path, device="cpu"):
    """Party 2 publishes well-formed but wrong decryption factors (all
    ones); the others isolate it (tests/test_adversarial.py:179).
    (messages, outputs, party 1's CorrectIndices bits)."""
    from vmn_tpu_torch.eio.bytetree import ByteTree
    from vmn_tpu_torch.protocol import elgamal
    from vmn_tpu_torch.protocol.com.board import LocalBoardHub

    params = adversary_params("AdvDec", device)
    ones = elgamal.plain_group(params.pgroup, 1).one(
        (ADV_N,)).to_bytetree().to_bytes()
    hub = LocalBoardHub(ADV_K)
    boards = [None] + [hub.board(j) for j in range(1, ADV_K + 1)]
    boards[2] = TamperBoard(boards[2],
                            lambda lab: lab == "DecryptionFactors2",
                            lambda data: ones)
    msgs, outs = adversary_run(root, params, boards, allow=(2,))
    ci = ByteTree.from_bytes((root / "Party01" / "nizkp.adv" / "proofs"
                              / "CorrectIndices.bt").read_bytes())
    return msgs, outs, list(ci.data)  # (k + 1) slots, [0] unused


def adversary_coin_misopen(root: Path, device="cpu"):
    """Interactive: party 3 mis-opens every coin share; the coins are
    recovered from the threshold (tests/test_adversarial.py:215).
    (messages, outputs)."""
    from vmn_tpu_torch.protocol.com.board import LocalBoardHub

    params = adversary_params("AdvCoin", device, noninteractive=False)
    hub = LocalBoardHub(ADV_K)
    boards = [None] + [hub.board(j) for j in range(1, ADV_K + 1)]
    boards[3] = TamperBoard(boards[3], lambda lab: lab == "Shares",
                            lambda data: b"\x00" * 4)
    return adversary_run(root, params, boards)


def adversary_restart(root: Path, device="cpu"):
    """Party 2 crashes right after publishing its shuffled ciphertexts
    and restarts with a fresh RandomDevice; its persisted state replays
    byte-identical messages (tests/test_adversarial.py:265).  (messages,
    outputs, params, party 1's nizkp directory, whether party 2
    restarted)."""
    import threading

    from vmn_tpu_torch.crypto.randomsource import RandomDevice, SeededSource
    from vmn_tpu_torch.protocol.com.board import LocalBoardHub
    from vmn_tpu_torch.protocol.mixnet.party import MixNetParty

    params = adversary_params("Crash", device)
    hub = LocalBoardHub(ADV_K)
    barrier = threading.Barrier(ADV_K)
    restarted = []

    def run(j):
        board = hub.board(j)
        if j == 2:
            board = CrashBoard(board, "Ciphertext2")
        party = MixNetParty(params, board,
                            SeededSource(f"party{j}".encode()),
                            str(root / f"Party{j:02d}"))
        pk = party.keygen()
        barrier.wait()
        try:
            return party.session("crash", 1).mix(
                adversary_ciphertexts(params.pgroup, pk)[1])
        except CrashBoard.Crash:
            # a different (device) random source and a clean board
            # connection: the persisted state carries the randomness
            again = MixNetParty(params, hub.board(j), RandomDevice(),
                                str(root / f"Party{j:02d}"))
            again.load_keys()
            restarted.append(j)
            return again.session("crash", 1).mix(adversary_ciphertexts(
                params.pgroup, again.full_public_key())[1])

    outs = run_parties(ADV_K, run)
    return (messages(params.pgroup, ADV_N), outs, params,
            root / "Party01" / "nizkp.crash", restarted == [2])


def p224_coins(device="cpu") -> list:
    """The coins of vmn_tpu's EC coin-flipping run
    (tests/test_mixnet_ec.py: three parties over P-224, session "ECCoin",
    interactive, seeds b"ec{j}", eight coin bytes) flipped by the port on
    `device`: each party's bytes, as hex."""
    import torch_make_wide_golden as W
    from vmn_tpu_torch.arith.ec import ECqPGroup
    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.protocol.coinflip import CoinFlipPRingSource
    from vmn_tpu_torch.protocol.com.board import LocalBoardHub
    from vmn_tpu_torch.protocol.context import ProtocolContext, ProtocolParams

    params = ProtocolParams(sid=W.COIN_SID, k=W.COIN_K, threshold=W.COIN_T,
                            noninteractive=False,
                            pgroup=ECqPGroup.named("P-224", device=device))
    hub = LocalBoardHub(W.COIN_K)

    def flip(j):
        src = CoinFlipPRingSource(ProtocolContext(params), hub.board(j),
                                  SeededSource(f"ec{j}".encode()))
        return src.coin_bytes(W.COIN_BYTES).hex()

    return run_parties(W.COIN_K, flip)[1:]

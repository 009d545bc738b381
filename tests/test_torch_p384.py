"""The port at the NIST curve P-384 (field and ring of W = 12 words, L = 24
limbs) against `vmn_tpu` on the CPU.

* The slice: the port's k=1 golden mix (the inputs of
  tools/make_golden.py: P-384, n=3, `SeededSource(b"golden-party")`,
  `SeededSource(b"golden-ciphs")`) rewrites the transcript that
  `vmn_tpu` wrote (tests/golden/nizkp_p384_k1, by
  tests/torch_make_wide_golden.py) byte for byte and preserves the
  plaintext multiset; the port's verifier accepts `vmn_tpu`'s transcript,
  writes its 41 test vectors (tests/golden/test_vectors_p384.json) and
  rejects it with one flipped reply byte.
* The plain version of each kernel on this path against the Pallas
  kernel it ports, run in interpret mode as tests/test_kernels.py runs
  them, at P-384 on small batches: H8 (K12), H5 (K9), H7 (K11), and H1
  and H2 (K2, K3) on the field and on the scalar ring; H6 with the
  position combine (K10) against `vmn_tpu`'s `exp_prod` on its CPU
  route, compared after `normalize`.
* At each EC width (W = 8, 12 and P-521's inner 20): the TPI rules,
  their instantiations and H6's shape (`MEXP_SHAPES`) against the
  kernel's (its launch order: tests/test_torch_ec.py::
  test_mexp_order_is_the_kernels), one parametrised test.
* The carry-across of P-384 state from `vmn_tpu` (`interop`).
* On a CUDA device only (skipped here): H1 and H2 at W = 12 at every TPI
  of their rules, and the golden mix on the card.

Inputs are Python ints from fixed scalars or a seeded numpy generator,
handed to both packages.  Tolerance: exact equality of limbs and bytes
(integer arithmetic).
"""

import json
import re
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401 (cuda_device: fixture)
    TV_NAMES, as_np, cuda_device, edge_values, golden_files, host_ec_add,
    host_ec_mul, limbs_np, vmn_tpu_exp_prod,
)
from vmn_tpu_torch import interop
from vmn_tpu_torch.arith import ec as TEC
from vmn_tpu_torch.arith.ec import ECqPGroup as TGroup
from vmn_tpu_torch.arith.mont import device_limbs
from vmn_tpu_torch.ops import ec_kernels as E
from vmn_tpu_torch.ops import mont_kernels as K

GOLDEN = Path(__file__).parent / "golden" / "nizkp_p384_k1"
CSRC = Path(K.__file__).resolve().parent.parent / "csrc"
N = 3


@pytest.fixture(scope="module")
def tg():
    return TGroup.named("P-384", device="cpu")


@pytest.fixture(scope="module")
def jx():
    """The JAX side: jnp, vmn_tpu's P-384 group and kernel modules."""
    import jax.numpy as jnp
    from vmn_tpu.arith import ec as JEC
    from vmn_tpu.ops import ec_kernels as JK
    from vmn_tpu.ops import mont_kernels as JM

    return SimpleNamespace(jnp=jnp, JEC=JEC, JK=JK, JM=JM,
                           grp=JEC.ECqPGroup.named("P-384"))


@pytest.fixture
def interpret(jx, monkeypatch):
    """Pallas kernels through the basic interpreter (read at trace time)."""
    monkeypatch.setattr(jx.JM, "INTERPRET", True)


def _params():
    from vmn_tpu_torch.protocol.context import ProtocolParams

    return ProtocolParams(sid="Golden", k=1, threshold=1,
                          pgroup=TGroup.named("P-384", device="cpu"))


def _jnp(jx, t):
    return jx.jnp.asarray(as_np(t))


def _assert_limbs_equal(got, want):
    for g, w in zip(got, want):
        assert np.array_equal(as_np(g), as_np(w))


def _affine(tg, jac):
    return tg.to_affine(TEC.ECArray(tg, *tg.curve.normalize(*jac)))


def _points(tg, pts):
    """Affine points (None: infinity) as port limbs and infinity mask."""
    x = tg.ctx.encode([0 if q is None else q[0] for q in pts])
    y = tg.ctx.encode([0 if q is None else q[1] for q in pts])
    return x, y, torch.tensor([q is None for q in pts])


def _jacobian(tg, pts, lams):
    """Jacobian Montgomery limbs of affine points scaled by lambda (X =
    x·λ², Y = y·λ³, Z = λ); None is (0, 0, 0)."""
    p = tg.p
    cols = [[], [], []]
    for pt, lam in zip(pts, lams):
        vals = (0, 0, 0) if pt is None else (
            pt[0] * lam * lam % p, pt[1] * pow(lam, 3, p) % p, lam)
        for c, v in zip(cols, vals):
            c.append(v)
    X, Y, Z = (tg.ctx.encode(c) for c in cols)
    zero = torch.tensor([pt is None for pt in pts])
    return X, Y, torch.where(zero[:, None], torch.zeros_like(Z), Z)


# ------------------------------------------------------------ the slice


@pytest.fixture(scope="module")
def port_mix(tmp_path_factory):
    """The golden mix run by the port on the CPU: (nizkp dir, messages,
    plaintext points)."""
    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.protocol import elgamal
    from vmn_tpu_torch.protocol.com.board import LocalBoardHub
    from vmn_tpu_torch.protocol.mixnet.party import MixNetParty

    out = tmp_path_factory.mktemp("port_golden_p384")
    params = _params()
    group = params.pgroup
    party = MixNetParty(params, LocalBoardHub(1).board(1),
                        SeededSource(b"golden-party"), str(out))
    pk = party.keygen()
    msgs = [group.encode_message(f"{i:08d}".encode()) for i in range(N)]
    r = group.ring.random((N,), SeededSource(b"golden-ciphs"), 0)
    ciphs = elgamal.encrypt(pk, group.from_affine(msgs), r)
    party.board = LocalBoardHub(1).board(1)
    plain = party.session("golden", 1).mix(ciphs)
    return out / "nizkp.golden", msgs, plain.to_affine()


def test_port_rewrites_golden_p384_transcript(port_mix):
    nizkp, _, _ = port_mix
    assert golden_files(nizkp) == golden_files(GOLDEN)
    for rel in golden_files(GOLDEN):
        assert (nizkp / rel).read_bytes() == (GOLDEN / rel).read_bytes(), rel


def test_port_p384_mix_preserves_plaintext_multiset(port_mix):
    _, msgs, plain = port_mix
    assert sorted(plain) == sorted(msgs)


def test_port_verifier_accepts_vmn_tpu_p384_transcript():
    """The port's verifier on vmn_tpu's transcript: accepted, with the
    41 test vectors vmn_tpu's verifier wrote for it."""
    from vmn_tpu_torch.protocol.mixnet.verifier import FiatShamirVerifier

    v = FiatShamirVerifier(_params(), GOLDEN, test_vectors=TV_NAMES)
    assert v.verify(expected_type="mixing").ok
    want = json.loads((GOLDEN.parent / "test_vectors_p384.json").read_text())
    assert len(want) == 41 and v.tv == want


def test_port_verifier_rejects_flipped_p384_reply_byte(tmp_path):
    from vmn_tpu_torch.protocol.mixnet.verifier import FiatShamirVerifier

    nizkp = tmp_path / "nizkp"
    shutil.copytree(GOLDEN, nizkp)
    reply = nizkp / "proofs" / "PoSReply01.bt"
    raw = bytearray(reply.read_bytes())
    raw[-1] ^= 0x01
    reply.write_bytes(bytes(raw))
    assert not FiatShamirVerifier(_params(), nizkp).verify(
        expected_type="mixing").ok


# ----------------------------------- plain versions vs Pallas K2-K3, K9-K12


@pytest.mark.parametrize("modulus", ["field", "ring"])
def test_mont_plain_matches_pallas_at_w12(jx, tg, modulus):
    """H1 and H2's plain versions against K2 `mont_mul_pallas` and K3
    `mont_exp_pallas` on the P-384 field and on its scalar ring, both 24
    limbs: the edge values, and 384-bit exponents with m - 2 (the batch-1
    inversion), 0 and all ones among them; H2 also against Python pow."""
    from jax.experimental.pallas import tpu as pltpu
    from vmn_tpu.arith.mont import MontCtx as JCtx

    tc = tg.ctx if modulus == "field" else tg.ring.ctx
    jc = JCtx(tc.m)
    m = tc.m
    xs = edge_values(m)
    ys = xs[::-1]
    es = [0, 1, 2, m - 2, (1 << 384) - 1, 65537, m // 3, 3]
    a, b = (jc.to_mont(np.asarray(limbs_np(v, tc.L))) for v in (xs, ys))
    e = limbs_np(es, tc.L)
    ta, tb = (device_limbs(np.asarray(v), "cpu") for v in (a, b))
    te = device_limbs(e, "cpu")
    with pltpu.force_tpu_interpret_mode():
        want_mul = jx.JM.mont_mul_pallas(a, b, jc.m_limbs, jc.mprime)
        want_exp = jx.JM.mont_exp_pallas(a, jx.jnp.asarray(e), jc.m_limbs,
                                         jc.mprime, jc.one_mont, 384)
    assert np.array_equal(as_np(K.mont_mul_plain(ta, tb, tc.mod)),
                          as_np(want_mul))
    got = K.mont_exp_plain(ta, te, tc.mod, 384)
    assert np.array_equal(as_np(got), as_np(want_exp))
    assert tc.decode(got) == [pow(x, k, m) for x, k in zip(xs, es)]


def test_point_add_plain_matches_pallas(jx, tg, interpret):
    """H8's plain version against K12 `ec_point_add_pallas` at P-384, with
    every exceptional case, on Z = 1 and on scaled Jacobian inputs."""
    p, a, G = tg.p, tg.a, (tg.gx, tg.gy)
    P2 = host_ec_add(p, a, G, G)
    P3 = host_ec_add(p, a, P2, G)
    cases = [(G, P2), (G, G), (G, (G[0], p - G[1])), (None, P3), (P3, None),
             (None, None), (P2, P3), (P3, P3), (P3, (P3[0], p - P3[1]))]
    rng = np.random.default_rng(384)
    lam1 = [1] * 6 + [int(rng.integers(2, 1 << 62)) for _ in range(3)]
    lam2 = [1] * 6 + [int(rng.integers(2, 1 << 62)) for _ in range(3)]
    j1 = _jacobian(tg, [c[0] for c in cases], lam1)
    j2 = _jacobian(tg, [c[1] for c in cases], lam2)
    got = E.ec_point_add_plain(*j1, *j2, tg.ctx.mod)
    jc = jx.grp.ctx
    want = jx.JK.ec_point_add_pallas(*(_jnp(jx, t) for t in (*j1, *j2)),
                                     jc.m_limbs, jc.mprime)
    _assert_limbs_equal(got, want)
    assert _affine(tg, got) == [host_ec_add(p, a, u, v) for u, v in cases]


def test_scalar_mul_plain_matches_pallas(jx, tg, interpret):
    """H5's plain version against K9 `ec_scalar_mul_pallas` at 384 bits:
    scalars 0, 1, n - 1 and others; one input point at infinity."""
    p, a, G = tg.p, tg.a, (tg.gx, tg.gy)
    n = tg.n
    scalars = [0, 1, n - 1, (1 << 383) + 99, n // 3, 7]
    pts = [host_ec_mul(p, a, G, i + 2) for i in range(len(scalars))]
    pts[4] = None
    x, y, inf = _points(tg, pts)
    e = device_limbs(limbs_np(scalars, 24), "cpu")
    got = E.ec_scalar_mul_plain(x, y, inf, e, tg.ctx.mod, 384)
    jc = jx.grp.ctx
    want = jx.JK.ec_scalar_mul_pallas(
        _jnp(jx, x), _jnp(jx, y), jx.jnp.asarray(inf.numpy()), _jnp(jx, e),
        jc.m_limbs, jc.mprime, jc.one_mont, 384)
    _assert_limbs_equal(got, want)
    assert _affine(tg, got) == [
        None if q is None else host_ec_mul(p, a, q, k % n)
        for q, k in zip(pts, scalars)]


def _multiexp_batch(tg, N, nbits):
    """N points g^(i+2) with a point at infinity, a pair P, -P and a
    repeated point, and nbits-bit scalars with 0 and all ones: port limbs,
    affine points and scalars."""
    p, a, G = tg.p, tg.a, (tg.gx, tg.gy)
    pts = [host_ec_mul(p, a, G, i + 2) for i in range(N)]
    pts[1] = None
    pts[3] = (pts[2][0], p - pts[2][1])
    pts[4] = pts[2]
    rng = np.random.default_rng(N)
    ks = [int(k) for k in rng.integers(0, 1 << nbits, N, dtype=np.uint64)]
    ks[0], ks[-1] = 0, (1 << nbits) - 1
    x, y, inf = _points(tg, pts)
    return x, y, inf, device_limbs(limbs_np(ks, 2), "cpu"), pts, ks


def _multiexp_python(tg, pts, ks):
    p, a = tg.p, tg.a
    acc = None
    for q, k in zip(pts, ks):
        acc = host_ec_add(p, a, acc, None if q is None
                          else host_ec_mul(p, a, q, k))
    return acc


def test_multiexp_plain_matches_pallas(jx, tg, monkeypatch):
    """H6's plain version at W = 12 (chunks of 40 points) and the position
    combine (`ec_multiexp`) against vmn_tpu's `exp_prod` on its CPU route
    (its XLA scalar multiples and product tree; K10's fold is pinned in
    interpret mode at P-256, tests/test_torch_ec.py), after `normalize`,
    on 70 points split into three launches by a small EP_SUPER, none a
    whole chunk."""
    monkeypatch.setattr(E, "EP_SUPER", 32)
    x, y, inf, e, pts, ks = _multiexp_batch(tg, 70, 32)
    got = tg.curve.normalize(*(t[None] for t in E.ec_multiexp(
        x, y, inf, e, tg.ctx.mod, 32)))
    _assert_limbs_equal([t.reshape(-1) for t in got],
                        vmn_tpu_exp_prod(jx.grp, x, y, inf, e, 32))
    assert tg.to_affine(TEC.ECArray(tg, *got)) == [
        _multiexp_python(tg, pts, ks)]


def test_multiexp_plain_one_block_walks_the_chunks(tg, monkeypatch):
    """H6's plain version at W = 12 with MEXP_BLOCKS = 1: one block folds
    three chunks, the last short; with the combine, against Python EC
    arithmetic (the Pallas kernel holds the three-launch case above)."""
    monkeypatch.setattr(E, "MEXP_BLOCKS", 1)
    x, y, inf, e, pts, ks = _multiexp_batch(tg, 90, 32)
    assert E.mexp_shape(90, 16, 12) == (1, 12)  # 32 bits: 16 positions
    got = tg.curve.normalize(*(t[None] for t in E.ec_multiexp(
        x, y, inf, e, tg.ctx.mod, 32)))
    assert tg.to_affine(TEC.ECArray(tg, *got)) == [
        _multiexp_python(tg, pts, ks)]


def test_fb_exp_plain_matches_pallas(jx, tg, interpret, monkeypatch):
    """H7's plain version against K11 `ec_fb_exp_pallas` on the port's
    fixed-base table of g (d·2^(4j)·g), scalar 0 included."""
    monkeypatch.setattr(jx.JK, "TILE_N", 128)
    p, a, G = tg.p, tg.a, (tg.gx, tg.gy)
    ndig = 16
    tbx, tby = TEC._ec_fb_table(tg.curve, *tg.g._jac(), ndig)
    rows = tg.to_affine(TEC.ECArray(tg, tbx[3, 1:], tby[3, 1:],
                                    torch.zeros(15, dtype=torch.bool)))
    assert rows == [host_ec_mul(p, a, G, d << 12) for d in range(1, 16)]
    scalars = [0, 1, 2, (1 << 64) - 1, 12345, 7]
    e = device_limbs(limbs_np(scalars, 4), "cpu")
    got = E.ec_fb_exp_plain(tbx, tby, e, tg.ctx.mod)
    jc = jx.grp.ctx
    want = jx.JK.ec_fb_exp_pallas(_jnp(jx, tbx), _jnp(jx, tby), _jnp(jx, e),
                                  jc.m_limbs, jc.mprime, jc.one_mont)
    _assert_limbs_equal(got, want)
    assert _affine(tg, got) == [host_ec_mul(p, a, G, k) for k in scalars]


def test_multiexp_combine_plain_matches_python(tg):
    """The combine's plain version over 96 positions (a 384-bit scalar's),
    the top one at infinity, against Python EC arithmetic."""
    p, a, G = tg.p, tg.a, (tg.gx, tg.gy)
    pts = [None] + [host_ec_mul(p, a, G, 3 * j + 1) for j in range(95)]
    x, y, inf = _points(tg, pts[::-1])
    lams = [1 + (j % 5) for j in range(96)]
    P = _jacobian(tg, pts[::-1], lams)
    got = E.ec_multiexp_combine_plain(*P, tg.ctx.mod)
    acc = None
    for pt in reversed(pts[::-1]):
        for _ in range(4):
            acc = host_ec_add(p, a, acc, acc)
        acc = host_ec_add(p, a, acc, pt)
    assert _affine(tg, tuple(t[None] for t in got)) == [acc]
    assert not inf.all()


# ------------------------------ the TPI rules and H6's shape at each width

# (entry point, its source file) of each cooperative wrapper
_ENTRY = {"mont_mul": ("vmn_mont_mul", "mont_kernels.cu"),
          "mont_exp": ("vmn_mont_exp", "mont_kernels.cu"),
          "ec_scalar_mul": ("vmn_ec_smul", "ec_kernels.cu"),
          "ec_multiexp_combine": ("vmn_ec_chain", "ec_kernels.cu"),
          "ec_point_add": ("vmn_ec_add", "ec_kernels.cu")}
# the class template of ec_launch.cuh that each EC entry point reaches
_LAUNCHER = {"ec_scalar_mul": "Smul", "ec_multiexp_combine": "Chain",
             "ec_point_add": "Add"}
# each EC width (P-256's W = 8, P-384's 12, P-521's inner 24): its rules
# cover every batch, each TPI of a rule is built, H6's shape fits
_WIDTH_CASES = ([(w, "rules", k) for w in E._WIDTHS for k in _ENTRY]
                + [(w, "built", k) for w in E._WIDTHS for k in _ENTRY]
                + [(w, "mexp", None) for w in E._WIDTHS])


def _rules_cover_every_batch(w, kernel):
    """Every N >= 1 has a TPI that divides W (a power of two within a
    warp), fewer lanes as N grows, each TPI reached at its first N; every
    launch covers its elements' lanes in whole warps of at most one
    block's threads.  The combine is one point.  H3 and H4 have measured
    rules at W = 8 alone; at the other EC widths they take W = 32's
    (`coop_rule`), each TPI taken down to one dividing W."""
    rule = K.COOP_TPI[kernel, w]
    assert rule[-1][0] == 1
    assert [lo for lo, _ in rule] == sorted({lo for lo, _ in rule},
                                            reverse=True)
    if kernel == "ec_multiexp_combine":
        assert len(rule) == 1
    last = None
    edges = {lo + d for lo, _ in rule for d in (-1, 0, 1) if lo + d}
    for n in sorted({1, 2, 31, 4096, 1 << 17, 5 * 10**6, *edges}):
        tpi, threads, blocks = K.coop_launch(kernel, w, n)
        assert w % tpi == 0 and 32 % tpi == 0 and threads % 32 == 0
        assert 0 < threads <= K.COOP_BLOCK
        assert (blocks - 1) * threads < n * tpi <= blocks * threads
        assert last is None or tpi <= last
        last = tpi
    for lo, tpi in rule:
        assert K.threads_per_element(kernel, w, lo) == tpi
    for other in ("mont_fb_exp", "mont_expprod_positions"):
        if w != 8:
            assert (other, w) not in K.COOP_TPI
            rule = K.coop_rule(other, w)
            assert rule[-1][0] == 1
            assert {t for _, t in rule} == {
                min(t, w & -w) for _, t in K.COOP_TPI[other, 32]}


def _rules_name_built_tpis(w, kernel):
    """Each TPI of the rule has its case in the entry point's switch, and
    for the EC kernels an instantiation in ec_w{W}.cu; every case of the
    switch at W is one the rule can choose (an unchosen instantiation is
    not built); H6 has its case and instantiation at every EC width, H7
    at the unpadded ones (P-521's inner width has none: off the path)."""
    fn, name = _ENTRY[kernel]
    src = (CSRC / name).read_text()
    body = re.search(rf"int {fn}\(.*?\n\}}", src, re.S).group(0)
    cases = {int(t) for w2, t in re.findall(r"case (\d+) << 8 \| (\d+):",
                                            body) if int(w2) == w}
    assert cases == {t for _, t in K.COOP_TPI[kernel, w]}
    inst = (CSRC / f"ec_w{w}.cu").read_text()
    if kernel in _LAUNCHER:
        assert cases == {int(t) for t in re.findall(
            rf"template struct {_LAUNCHER[kernel]}<{w}, (\d+)>;", inst)}
    if kernel == "ec_point_add":
        assert f"template struct Mexp<{w}>;" in (
            CSRC / f"ec_mexp_w{w}.cu").read_text()
        assert f"case {w}: return Mexp<{w}>::launch" in src
        # a width that serves only padded moduli (P-521's W' = 20; W = 8
        # serves P-256 beside P-224)
        padded = w not in {L // 2 for L in map(_limb_count, TEC._CURVES)
                           if L not in K.INNER_WORDS}
        assert (f"template struct Fb<{w}>;" in inst) == (not padded)
        assert (f"case {w}: return Fb<{w}>::launch" in src) == (not padded)


def _limb_count(curve: str) -> int:
    """The 16-bit limbs of a curve's field elements."""
    return -(-TEC._CURVES[curve][0].bit_length() // 16)


def _mexp_shape_fits_the_block(w):
    """H6's shape as csrc/ec_kernels.cuh lays it out: the kernel's
    MexpShape<W> is MEXP_SHAPES[W] (and MEXP_TPI[W] lanes a group at the
    padded widths).  One thread a builder and a folder: two chunks of
    16-entry tables (45·W + 4 words a point), a slot of 6·W + 1 words a
    folder and the modulus, one, c_in and c_out (4·W words) within the
    227 KB a block
    may use, a builder a point of the chunk (two warps), and a larger
    chunk would not fit.  Groups of lanes: builders and folders in whole
    warps sharing the chunk, at most 1024 threads, and the two chunks
    with a running sum (3·W words) an item for a 521-bit scalar's 144
    positions within the 227 KB."""
    src = (CSRC / "ec_kernels.cuh").read_text()
    built = {int(m[0]): tuple(map(int, m[1:])) for m in re.findall(
        r"struct MexpShape<(\d+)> \{\s*static constexpr int kTPI = (\d+);"
        r"\s*static constexpr int kBuilders = (\d+), kFolders = (\d+), "
        r"kChunk = (\d+);", src)}
    assert set(built) == set(E.MEXP_SHAPES) >= set(E._WIDTHS)
    tpi, builders, folders, chunk = built[w]
    assert (chunk, folders) == E.MEXP_SHAPES[w]
    assert tpi == E.MEXP_TPI.get(w, 1)
    tables = 2 * chunk * (45 * w + 4)
    if tpi == 1:
        words = tables + folders * (6 * w + 1) + 4 * w
        assert 4 * words <= 232448 and chunk <= builders == 64
        assert folders % 32 == 0
        assert 4 * (words + 2 * (45 * w + 4)) > 232448 or w == 8
    else:
        assert builders * tpi % 32 == 0 and folders * tpi % 32 == 0
        assert chunk % builders == 0
        assert (builders + folders) * tpi <= 1024
        rounds = -(-144 // folders)
        assert 4 * (tables + rounds * folders * 3 * w) <= 232448


@pytest.mark.parametrize("w,check,kernel", _WIDTH_CASES)
def test_ec_width_rules_and_shapes(w, check, kernel):
    """The launch rules and shapes of one EC width (see the three checks
    above)."""
    if check == "rules":
        _rules_cover_every_batch(w, kernel)
    elif check == "built":
        _rules_name_built_tpis(w, kernel)
    else:
        _mexp_shape_fits_the_block(w)


# ---------------------------------------------------------------- interop


def test_interop_carries_p384_state(jx, tg):
    """vmn_tpu's P-384 points (Montgomery-form limbs, infinity mask) and
    ring elements (standard form) become the port's, and back to the same
    numpy limbs."""
    ks = [0, 1, 2, tg.n - 1, 12345]
    jp = jx.grp.g.exp(jx.grp.ring.from_ints(ks))
    tp = interop.ecarray_from_numpy(tg, np.asarray(jp.x), np.asarray(jp.y),
                                    np.asarray(jp.inf))
    assert tp.equals(tg.g.exp(tg.ring.from_ints(ks)))
    assert tp.to_affine() == jx.grp.to_affine(jp)
    assert np.array_equal(interop.limbs_to_numpy(tp.x), np.asarray(jp.x))
    je = jx.grp.ring.from_ints(ks)
    te = interop.farray_from_numpy(tg.ring, np.asarray(je.limbs))
    assert te.to_ints() == ks
    assert np.array_equal(interop.limbs_to_numpy(te.limbs),
                          np.asarray(je.limbs))


# ----------------------------------------------- on the card (skipped here)


@pytest.mark.cuda
@pytest.mark.parametrize("modulus", ["field", "ring"])
@pytest.mark.parametrize("kernel,tpi", [
    (k, t) for k in ("mont_mul", "mont_exp")
    for t in sorted({t for _, t in K.COOP_TPI[k, 12]})])
def test_cuda_w12_every_tpi(kernel, tpi, modulus, cuda_device):
    """H1 and H2 at W = 12 at each TPI of their rules, reached through N
    (37 past the fewest elements that pick it), on the P-384 field and
    ring: against the plain version."""
    grp = TGroup.named("P-384", device=cuda_device)
    tc = grp.ctx if modulus == "field" else grp.ring.ctx
    n = min(lo for lo, t in K.COOP_TPI[kernel, 12] if t == tpi) + 37
    assert K.threads_per_element(kernel, 12, n) == tpi
    rng = np.random.default_rng(n)
    vals = edge_values(tc.m) + [int.from_bytes(rng.bytes(56), "big") % tc.m
                                for _ in range(n)]
    a = tc.encode(vals[:n])
    b = tc.encode(vals[::-1][:n])
    if kernel == "mont_mul":
        got, want = K.mont_mul(a, b, tc.mod), K.mont_mul_plain(a, b, tc.mod)
    else:
        e = device_limbs(limbs_np([v % (1 << 384) for v in vals[1:n + 1]],
                                  24), cuda_device)
        got = K.mont_exp(a, e, tc.mod, 384)
        want = K.mont_exp_plain(a, e, tc.mod, 384)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_p384_golden_mix_rewrites_the_transcript(tmp_path, cuda_device):
    """The golden mix on the card: vmn_tpu's transcript, byte for byte."""
    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.protocol import elgamal
    from vmn_tpu_torch.protocol.com.board import LocalBoardHub
    from vmn_tpu_torch.protocol.context import ProtocolParams
    from vmn_tpu_torch.protocol.mixnet.party import MixNetParty

    group = TGroup.named("P-384", device=cuda_device)
    params = ProtocolParams(sid="Golden", k=1, threshold=1, pgroup=group)
    party = MixNetParty(params, LocalBoardHub(1).board(1),
                        SeededSource(b"golden-party"), str(tmp_path))
    pk = party.keygen()
    msgs = [group.encode_message(f"{i:08d}".encode()) for i in range(N)]
    r = group.ring.random((N,), SeededSource(b"golden-ciphs"), 0)
    ciphs = elgamal.encrypt(pk, group.from_affine(msgs), r)
    party.board = LocalBoardHub(1).board(1)
    party.session("golden", 1).mix(ciphs)
    nizkp = tmp_path / "nizkp.golden"
    assert golden_files(nizkp) == golden_files(GOLDEN)
    for rel in golden_files(GOLDEN):
        assert (nizkp / rel).read_bytes() == (GOLDEN / rel).read_bytes(), rel

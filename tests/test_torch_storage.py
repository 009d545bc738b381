"""The port's out-of-core arrays (`vmn_tpu_torch.arith.storage`, the
`spill` methods, `arrays=file`) against `vmn_tpu` on the CPU.

Port copies of tests/test_storage.py's four cases (roundtrip, small
arrays staying in memory, ram mode as identity, group ops on spilled
arrays, the last over FArray, GArray, PPArray and PPFArray at test256
and ECArray at P-224: each spilled array gives the limbs of the
unspilled one and of `vmn_tpu`'s); the golden k=1 mix and the golden
precomputation mix of tools/make_golden.py with every array spilled
(MIN_SPILL_BYTES = 0), which rewrite vmn_tpu's transcripts byte for byte
and leave spill files, as tests/test_matrix.py's arrays=file case does;
and the kernel wrappers' device guard: an operand on another device
than the modulus raises (here with the `meta` device; on the card, a
host tensor handed to the card's `MontCtx` and `ECqPGroup`).

Tolerance: exact equality of limbs and bytes.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401 (cuda_device: fixture)
    as_np, assert_same_transcript, cuda_device,
)
from vmn_tpu_torch.arith import storage
from vmn_tpu_torch.ops import ec_kernels as E
from vmn_tpu_torch.ops import mont_kernels as K

GOLDEN = Path(__file__).parent / "golden"


@pytest.fixture
def file_backend(tmp_path, monkeypatch):
    """The file backend in tmp_path with every array spilled; ram mode
    and the previous directory come back after the test."""
    monkeypatch.setattr(storage, "_SPILL_DIR", storage._SPILL_DIR)
    monkeypatch.setattr(storage, "MIN_SPILL_BYTES", 0)
    storage.set_backend("file", tmp_path)
    yield tmp_path
    storage.set_backend("ram")


def test_spill_roundtrip(file_backend):
    t = torch.arange(64, dtype=torch.int32).reshape(8, 8)
    sp = storage.maybe_spill(t)
    assert isinstance(sp, storage.Spilled)
    assert (sp.shape, sp.dtype, sp.device) == (t.shape, t.dtype, t.device)
    assert torch.equal(sp.load(), t)
    assert storage.maybe_spill(sp) is sp
    assert list(file_backend.glob("spill*.npy"))


def test_small_arrays_stay_in_ram(tmp_path, monkeypatch):
    monkeypatch.setattr(storage, "_SPILL_DIR", storage._SPILL_DIR)
    storage.set_backend("file", tmp_path)
    try:
        t = torch.zeros(4, dtype=torch.int32)
        assert storage.maybe_spill(t) is t
    finally:
        storage.set_backend("ram")


def test_ram_mode_is_identity():
    storage.set_backend("ram")
    t = torch.zeros((1024, 1024), dtype=torch.int32)
    assert storage.maybe_spill(t) is t


def _fields(a):
    """The tensors of an array, components flattened."""
    if hasattr(a, "components"):
        return [t for c in a.components for t in _fields(c)]
    if hasattr(a, "inf"):
        return [a.x, a.y, a.inf]
    return [a.limbs]


def _same(a, b):
    fa, fb = _fields(a), _fields(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert np.array_equal(as_np(x), as_np(np.asarray(y)))


def _modp(kind):
    """(port array, vmn_tpu array, op on an array and its group) at
    test256."""
    from vmn_tpu.arith.pgroup import ModPGroup as JGroup
    from vmn_tpu.arith.pgroup import PPGroup as JPP

    from vmn_tpu_torch.arith.pgroup import ModPGroup, PPGroup

    tg, jg = ModPGroup.named("test256", device="cpu"), JGroup.named("test256")
    xs, ys = [3, 5, 7, 11, 13], [2, 1 << 200, 9, 12345, 77]

    def make(g, pp):
        f, e = g.ring.from_ints(xs), g.ring.from_ints(ys)
        if kind == "FArray":
            return f, lambda a: a.mul(a).add(e)
        if kind == "PPFArray":
            ring = pp(g, 2).ring
            return (ring.product(f, e),
                    lambda a: a.mul(a).add(ring.product(e, f)))
        ge = g.g.exp(f)
        if kind == "GArray":
            return ge, lambda a: a.exp(e).mul(a)
        return pp(g, 2).product(ge, g.g.exp(e)), lambda a: a.exp(e).mul(a)

    (t, op), (j, jop) = make(tg, PPGroup), make(jg, JPP)
    return t, j, op, jop


def _ec():
    """(port array, vmn_tpu array, op) at P-224, short scalars."""
    from vmn_tpu.arith.ec import ECqPGroup as JGroup

    from vmn_tpu_torch.arith.ec import ECqPGroup

    tg, jg = ECqPGroup.named("P-224", device="cpu"), JGroup.named("P-224")
    xs, ys = [3, 0, 7], [2, 5, 0]

    def make(g):
        e = g.ring.from_ints(ys)
        return (g.g.exp_bits(g.ring.from_ints(xs), 4),
                lambda a: a.exp_bits(e, 4).mul(a))

    (t, op), (j, jop) = make(tg), make(jg)
    return t, j, op, jop


@pytest.mark.parametrize("kind", ["FArray", "GArray", "PPArray", "PPFArray",
                                  "ECArray"])
def test_group_ops_on_spilled_arrays(file_backend, kind):
    """An op on a spilled array gives the limbs of the same op on the
    array in memory and on vmn_tpu's; the spilled array holds handles,
    not tensors, and loads them onto its group's device."""
    t, j, op, jop = _ec() if kind == "ECArray" else _modp(kind)
    sp = t.spill()
    leaves = getattr(sp, "components", (sp,))
    for leaf, orig in zip(leaves, getattr(t, "components", (t,))):
        assert type(leaf) is not type(orig) and leaf.spill() is leaf
        assert leaf.shape == orig.shape and leaf.size == orig.size
        for f in ("x", "y", "inf") if kind == "ECArray" else ("limbs",):
            handle = getattr(type(orig), f).__get__(leaf)
            assert isinstance(handle, storage.Spilled)
            assert handle.path.exists()
    assert all(x.device.type == "cpu" for x in _fields(sp))
    _same(sp, t)
    want = op(t)
    _same(op(sp), want)
    _same(want, jop(j))


def _golden_mix(out: Path, maxciph: int = 0):
    """tools/make_golden.py's k=1 test256 mix by the port on the CPU
    (with a precomputation for `maxciph` when given): (nizkp dir,
    messages, plaintexts)."""
    from vmn_tpu_torch.arith.pgroup import ModPGroup
    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.protocol import elgamal
    from vmn_tpu_torch.protocol.com.board import LocalBoardHub
    from vmn_tpu_torch.protocol.context import ProtocolParams
    from vmn_tpu_torch.protocol.mixnet.party import MixNetParty

    group = ModPGroup.named("test256", device="cpu")
    params = ProtocolParams(sid="Golden", k=1, threshold=1, pgroup=group)
    party = MixNetParty(params, LocalBoardHub(1).board(1),
                        SeededSource(b"golden-party"), str(out))
    pk = party.keygen()
    msgs = [group.encode_message(f"{i:08d}".encode()) for i in range(5)]
    r = group.ring.random((5,), SeededSource(b"golden-ciphs"), 0)
    ciphs = elgamal.encrypt(pk, group.from_ints(msgs), r)
    party.board = LocalBoardHub(1).board(1)
    session = party.session("golden", 1)
    if maxciph:
        session.precomp(maxciph)
    plain = session.mix(ciphs)
    return out / "nizkp.golden", msgs, plain.to_ints()


@pytest.mark.parametrize("golden,maxciph", [
    ("nizkp_test256_k1", 0), ("nizkp_test256_k1_precomp", 8)])
def test_arrays_file_mix_rewrites_golden(file_backend, golden, maxciph):
    """arrays=file with every array spilled: the precomputation's
    resident arrays and the shuffle's output list go to disk, and the
    port still rewrites vmn_tpu's transcript byte for byte (reference:
    tests/test_matrix.py's arrays=file case)."""
    from vmn_tpu_torch.protocol.mixnet import party as P

    spilled = []
    orig = storage.maybe_spill

    def counted(t):
        out = orig(t)
        if out is not t:
            spilled.append(out.shape)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(storage, "maybe_spill", counted)
        nizkp, msgs, plain = _golden_mix(file_backend / "party", maxciph)
    assert P.storage is storage
    assert_same_transcript(nizkp, GOLDEN / golden)
    assert sorted(plain) == sorted(msgs)
    # the ciphertext list's two components; the precomputation adds its
    # generators, raised generators, commitments, re-encryption exponents
    # and the two components of its re-encryption factors
    assert len(spilled) == (8 if maxciph else 2)
    assert len(list(file_backend.glob("spill*.npy"))) == len(spilled)


def _wrapper_calls(mod, t):
    """Every kernel wrapper called with operand t (an int32 (2, L)
    tensor) against the modulus mod."""
    e = torch.zeros((2, 1), dtype=torch.int32, device=t.device)
    tab = torch.zeros((64, 16, mod.L), dtype=torch.int32, device=t.device)
    inf = torch.zeros(2, dtype=torch.bool, device=t.device)
    return {
        "mont_mul": lambda: K.mont_mul(t, t, mod),
        "mont_exp": lambda: K.mont_exp(t, e, mod, 16),
        "mont_fb_exp": lambda: K.mont_fb_exp(tab, e, mod),
        "mont_expprod_positions": lambda: K.mont_expprod_positions(
            t, e, mod, 16),
        "mont_expprod_combine": lambda: K.mont_expprod_combine(t, mod),
        "ec_scalar_mul": lambda: E.ec_scalar_mul(t, t, inf, e, mod, 16),
        "ec_multiexp_positions": lambda: E.ec_multiexp_positions(
            t, t, inf, e, mod, 16),
        "ec_multiexp_combine": lambda: E.ec_multiexp_combine(t, t, t, mod),
        "ec_fb_exp": lambda: E.ec_fb_exp(tab, tab, e, mod),
        "ec_point_add": lambda: E.ec_point_add(t, t, t, t, t, t, mod),
    }


@pytest.mark.parametrize("name", K.KERNELS + E.EC_KERNELS)
def test_wrapper_refuses_operand_on_another_device(name):
    """A wrapper whose operands lie on another device than its modulus
    raises before it computes anything: it never takes the plain
    version for them (operands on `meta`, the modulus on the CPU)."""
    from vmn_tpu_torch.arith.mont import MontCtx

    from torch_port_util import TEST256_P

    mod = MontCtx(TEST256_P, device="cpu").mod
    t = torch.zeros((2, mod.L), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="the modulus on cpu"):
        _wrapper_calls(mod, t)[name]()


@pytest.mark.cuda
def test_cuda_host_operand_on_card_group_raises(cuda_device, tmp_path,
                                                monkeypatch):
    """A host tensor handed to the card's MontCtx and to the card's
    ECqPGroup's kernels raises; a spilled card array loads onto the card
    and its ops launch the kernels."""
    from vmn_tpu_torch.arith.ec import ECqPGroup
    from vmn_tpu_torch.arith.mont import MontCtx
    from vmn_tpu_torch.arith.pgroup import ModPGroup

    from torch_port_util import TEST256_P

    ctx = MontCtx(TEST256_P, device=cuda_device)
    host = torch.ones((4, ctx.L), dtype=torch.int32)
    with pytest.raises(ValueError, match="the modulus on cuda"):
        ctx.mul(host, host)
    grp = ECqPGroup.named("P-224", device=cuda_device)
    mod = grp.curve.ctx.mod
    host = torch.zeros((2, mod.L), dtype=torch.int32)
    for name in E.EC_KERNELS:
        with pytest.raises(ValueError, match="the modulus on cuda"):
            _wrapper_calls(mod, host)[name]()
    monkeypatch.setattr(storage, "_SPILL_DIR", storage._SPILL_DIR)
    monkeypatch.setattr(storage, "MIN_SPILL_BYTES", 0)
    storage.set_backend("file", tmp_path)
    try:
        g = ModPGroup.named("test256", device=cuda_device)
        a = g.g.exp(g.ring.from_ints([3, 5, 7]))
        sp = a.spill()
        assert sp.limbs.device == a.limbs.device
        K.reset_launches()
        assert sp.mul(sp).equals(a.mul(a))
        assert K.LAUNCHES["mont_mul"] == 2
    finally:
        storage.set_backend("ram")

"""The port's host-only copies against `vmn_tpu`: limb codec, byte trees,
PRG, random oracle, seeded source, Jacobi, group marshalling — and the
port's import isolation from JAX.

Same seeded numpy inputs into both packages; tolerance: exact equality
of limbs and bytes (all integer/byte work).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_port_util import TEST256_P

import vmn_tpu.arith.limbs as J_limbs
import vmn_tpu.crypto.prg as J_prg
import vmn_tpu.crypto.randomsource as J_rs
import vmn_tpu.crypto.ro as J_ro
import vmn_tpu.eio.bytetree as J_bt
import vmn_tpu.native.build as J_native
import vmn_tpu_torch.arith.limbs as T_limbs
import vmn_tpu_torch.crypto.prg as T_prg
import vmn_tpu_torch.crypto.randomsource as T_rs
import vmn_tpu_torch.crypto.ro as T_ro
import vmn_tpu_torch.eio.bytetree as T_bt
import vmn_tpu_torch.native.build as T_native
from vmn_tpu.crypto.hash import SHA256 as J_SHA256
from vmn_tpu_torch.crypto.hash import SHA256 as T_SHA256

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("rows", [7, 2048])  # numpy route and native route
def test_limb_codec_matches(rows):
    rng = np.random.default_rng(rows)
    L = 16
    xs = [int.from_bytes(rng.bytes(32), "big") for _ in range(rows)]
    arr_j = J_limbs.ints_to_limbs(xs, L)
    arr_t = T_limbs.ints_to_limbs(xs, L)
    assert np.array_equal(arr_j, arr_t)
    assert T_limbs.limbs_to_ints(arr_t) == xs
    for nbytes in (32, 33):
        be_j = J_limbs.limbs_to_bytes_be(arr_j, nbytes)
        be_t = T_limbs.limbs_to_bytes_be(arr_t, nbytes)
        assert np.array_equal(be_j, be_t)
        assert np.array_equal(J_limbs.bytes_be_to_limbs(be_j, L),
                              T_limbs.bytes_be_to_limbs(be_t, L))


def test_bytetree_matches():
    rng = np.random.default_rng(3)
    elems = np.frombuffer(rng.bytes(40 * 33), np.uint8).reshape(40, 33)

    def build(bt):
        return bt.node(
            bt.leaf(b"\x01\x02"), bt.int_leaf(77), bt.string_leaf("vmn"),
            bt.signed_int_leaf(-(1 << 70)), bt.array_leaf_node(elems),
            bt.node(),
        )

    raw_j = build(J_bt).to_bytes()
    raw_t = build(T_bt).to_bytes()
    assert raw_j == raw_t
    tree = T_bt.lazy_from_bytes(raw_t)
    assert np.array_equal(T_bt.parse_uniform_array(tree[4]), elems)
    assert T_bt.ByteTree.from_bytes(raw_t).to_bytes() == raw_t


def test_prg_ro_and_seeded_source_match():
    seed = bytes(range(32))
    pj, pt = J_prg.PRGHeuristic(J_SHA256), T_prg.PRGHeuristic(T_SHA256)
    pj.set_seed(seed)
    pt.set_seed(seed)
    for n in (5, 40, 4096):  # short reads and the native expansion
        assert pj.read_bytes(n) == pt.read_bytes(n)
    for nbits in (1, 100, 256, 2050):
        ro_j, ro_t = J_ro.RandomOracle(J_SHA256, nbits), T_ro.RandomOracle(
            T_SHA256, nbits)
        assert ro_j.hash(seed) == ro_t.hash(seed)
    sj, st = J_rs.SeededSource(b"golden-party"), T_rs.SeededSource(
        b"golden-party")
    assert sj.read_bytes(100) == st.read_bytes(100)
    assert [sj.random_int_mod(1000003) for _ in range(20)] == [
        st.random_int_mod(1000003) for _ in range(20)
    ]


def test_jacobi_and_group_marshalling_match():
    from vmn_tpu.arith.pgroup import ModPGroup as JG
    from vmn_tpu.eio.marshal import marshal_hex as j_hex
    from vmn_tpu_torch.arith.pgroup import ModPGroup as TG
    from vmn_tpu_torch.eio.marshal import marshal_hex as t_hex

    rng = np.random.default_rng(5)
    raw = np.frombuffer(rng.bytes(300 * 33), np.uint8).reshape(300, 33).copy()
    raw[:, 0] = 0
    pb = TEST256_P.to_bytes(32, "big")
    assert np.array_equal(J_native.jacobi_batch(raw, pb),
                          T_native.jacobi_batch(raw, pb))
    # the marshalled group enters the Fiat–Shamir global prefix
    assert j_hex(JG.named("test256"), "ModPGroup") == t_hex(
        TG.named("test256", device="cpu"), "ModPGroup")


def test_port_imports_neither_jax_nor_vmn_tpu():
    """Every module of the port (found by walking the package, so a new
    one is covered at once) and chip_smoke.py import without jax or
    vmn_tpu; the modules named here must be among those walked."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vmn_tpu_torch\n"
        "names = {m.name for m in pkgutil.walk_packages("
        "vmn_tpu_torch.__path__, 'vmn_tpu_torch.')}\n"
        "need = {'vmn_tpu_torch.' + m for m in ("
        "'interop', 'kernel_timing', 'protocol.mixnet.party', "
        "'protocol.mixnet.verifier', 'crypto.naor_yung', "
        "'protocol.coinflip', 'protocol.distr.indgen', "
        "'protocol.distr.plainkeys', 'protocol.secretsharing.shamir', "
        "'protocol.hvzk.posc_tw', 'protocol.hvzk.ccpos_w', "
        "'protocol.hvzk.posc_multi', 'crypto.primes', 'crypto.provable', "
        "'crypto.signature', 'protocol.info', 'protocol.interfaces', "
        "'protocol.rear', 'protocol.com.http', 'cli.main', 'cli.vmni', "
        "'cli.vmn', 'cli.vmnd', 'cli.vmnv', 'cli.vmnc', 'cli.vre', "
        "'cli.vbt', 'cli.vog', 'cli.vhttp', 'cli.vdemo', 'cli.demos')}\n"
        "assert need <= names, sorted(need - names)\n"
        "for name in sorted(names):\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'vmn_tpu' or m.startswith('vmn_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)

"""The port's re-arrangement tool, object generator, primes and provable
primitives against `vmn_tpu`'s, on the CPU: port copies of
tests/test_rear.py, `vog` strings equal to `vmn_tpu`'s, and the Pedersen
hash, Merkle–Damgård, `PRGElGamal` and `PRGRandomSource` giving
`vmn_tpu`'s bytes.

Everything compared is bytes or integers, so every tolerance here is
exact equality.
"""

import contextlib
import hashlib
import io

import pytest

import torch_port_util  # noqa: F401 (torch thread count)
from vmn_tpu_torch.cli import vog, vre
from vmn_tpu_torch.eio.bytetree import ByteTree, leaf, node


def _ciphs(n, width):
    """A synthetic width-w ciphertext array byte tree ((u..),(v..))."""

    def arr(tag):
        comps = [
            node(*[leaf(bytes([tag, c, i])) for i in range(n)])
            for c in range(width)
        ]
        return node(*comps) if width > 1 else comps[0]

    return node(arr(1), arr(2))


def _vre(argv):
    return vre.main([str(a) for a in argv], device="cpu")


# ------------------------------------------- port copies of test_rear.py


def test_widths_split_then_cat_roundtrip(tmp_path):
    src = tmp_path / "in.bt"
    _ciphs(5, 3).write_file(src)
    parts = [tmp_path / f"p{i}.bt" for i in range(3)]
    assert _vre(["-ciphs", "-widths", "1,1,1", src, *parts]) == 0
    out = tmp_path / "joined.bt"
    assert _vre(["-ciphs", "-deep", *parts, out]) == 0
    assert ByteTree.read_file(out).to_bytes() == _ciphs(5, 3).to_bytes()


def test_shallow_equals_widths_ones(tmp_path):
    src = tmp_path / "in.bt"
    _ciphs(4, 2).write_file(src)
    a = [tmp_path / "a0.bt", tmp_path / "a1.bt"]
    b = [tmp_path / "b0.bt", tmp_path / "b1.bt"]
    assert _vre(["-ciphs", "-shallow", src, *a]) == 0
    assert _vre(["-ciphs", "-widths", "1,1", src, *b]) == 0
    for x, y in zip(a, b):
        assert (ByteTree.read_file(x).to_bytes()
                == ByteTree.read_file(y).to_bytes())


def test_sub_then_cat_roundtrip(tmp_path):
    src = tmp_path / "in.bt"
    _ciphs(6, 1).write_file(src)
    lo, hi = tmp_path / "lo.bt", tmp_path / "hi.bt"
    assert _vre(["-ciphs", "-sub", "0", "3", src, lo]) == 0
    assert _vre(["-ciphs", "-sub", "3", "6", src, hi]) == 0
    out = tmp_path / "cat.bt"
    assert _vre(["-ciphs", "-cat", lo, hi, out]) == 0
    assert ByteTree.read_file(out).to_bytes() == _ciphs(6, 1).to_bytes()


def test_project_component(tmp_path):
    src = tmp_path / "in.bt"
    _ciphs(3, 2).write_file(src)
    out = tmp_path / "proj.bt"
    assert _vre(["-ciphs", "-project", "1", src, out]) == 0
    want = _ciphs(3, 2)
    assert ByteTree.read_file(out).to_bytes() == node(
        want[0].children[1], want[1].children[1]).to_bytes()


def _vog(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def _port_vog(argv):
    return _vog(lambda a: vog.main(a, device="cpu"), argv)


def test_vog_roundtrips():
    """vog output unmarshals back to an equivalent object."""
    from vmn_tpu_torch.eio.marshal import unmarshal_hex

    prg = unmarshal_hex(_port_vog(["-gen", "PRGHeuristic"]).strip(), "cpu")
    assert prg.min_seed_bytes == 32
    hf = unmarshal_hex(
        _port_vog(["-gen", "HashfunctionHeuristic", "SHA-512"]).strip(),
        "cpu")
    assert hf.hash(b"x") == hashlib.sha512(b"x").digest()
    rd = unmarshal_hex(_port_vog(["-gen", "RandomDevice"]).strip(), "cpu")
    assert len(rd.read_bytes(8)) == 8
    names = _port_vog(["-list"]).split()
    assert "ModPGroup" in names and "ECqPGroup" in names


def test_format_language_select_and_product(tmp_path):
    """The (i,j) position mini-language: select components across
    sources, concatenate with 'x', multiple outputs with ':'."""
    from vmn_tpu_torch.protocol.rear import components_of

    a, b = tmp_path / "a.bt", tmp_path / "b.bt"
    _ciphs(4, 3).write_file(a)
    _ciphs(4, 2).write_file(b)
    out1, out2 = tmp_path / "o1.bt", tmp_path / "o2.bt"
    assert _vre(["-ciphs", "-format", "(0,1)x(1,0):(0,0-2)",
                 a, b, out1, out2]) == 0
    comps = components_of(ByteTree.read_file(out1), True)
    assert len(comps) == 2
    want_a = components_of(_ciphs(4, 3), True)
    want_b = components_of(_ciphs(4, 2), True)
    assert comps[0].to_bytes() == want_a[1].to_bytes()
    assert comps[1].to_bytes() == want_b[0].to_bytes()
    comps2 = components_of(ByteTree.read_file(out2), True)
    assert [c.to_bytes() for c in comps2] == [
        want_a[0].to_bytes(), want_a[1].to_bytes()]


def test_interval_language(tmp_path):
    src = tmp_path / "in.bt"
    _ciphs(6, 1).write_file(src)
    o1, o2 = tmp_path / "i1.bt", tmp_path / "i2.bt"
    assert _vre(["-ciphs", "-inter", "0-2:2-6", src, o1, o2]) == 0
    cat = tmp_path / "cat.bt"
    assert _vre(["-ciphs", "-cat", o1, o2, cat]) == 0
    assert ByteTree.read_file(cat).to_bytes() == _ciphs(6, 1).to_bytes()


class DummyPluginInterface:
    """Plug-in interface fixture for reflective loading."""

    def write_ciphertexts(self, ciphs, path):
        raise NotImplementedError

    def read_ciphertexts(self, group, path):
        raise NotImplementedError


def test_plugin_interface_loading():
    """Unknown interface names load user classes by dotted path, never
    from the JAX package."""
    from vmn_tpu_torch.protocol.interfaces import (
        InterfaceError,
        get_interface,
    )

    obj = get_interface("tests.test_torch_rear.DummyPluginInterface")
    assert type(obj).__name__ == "DummyPluginInterface"
    assert hasattr(obj, "read_ciphertexts")
    for name in ("no.such.module.Klass", "bogusname",
                 "vmn_tpu.protocol.interfaces.RawInterface"):
        with pytest.raises(InterfaceError):
            get_interface(name)


def test_primality_and_fresh_group():
    """Miller-Rabin, safe primes and a fresh group, equal to vmn_tpu's
    from the same seeded source."""
    from vmn_tpu.crypto.primes import random_safe_prime as j_safe_prime
    from vmn_tpu.crypto.randomsource import SeededSource as JSource
    from vmn_tpu_torch.crypto.primes import (
        is_safe_prime,
        miller_rabin,
        random_group,
        random_safe_prime,
    )
    from vmn_tpu_torch.crypto.randomsource import SeededSource

    rs = SeededSource(b"primes")
    assert miller_rabin(2**127 - 1, rs)
    assert not miller_rabin(2**128 - 1, rs)
    assert not miller_rabin(3825123056546413051, rs)
    assert is_safe_prime(23, rs)
    assert not is_safe_prime(29, rs)
    p = random_safe_prime(96, rs)
    assert p.bit_length() == 96 and is_safe_prime(p, rs)
    grp = random_group(96, rs, device="cpu")
    assert grp.p.bit_length() == 96
    assert pow(grp.g_int, grp.q, grp.p) == 1
    assert random_safe_prime(128, SeededSource(b"eq")) == j_safe_prime(
        128, JSource(b"eq"))


# ------------------------------------------------------ against vmn_tpu

VOG_CASES = [
    ["-gen", "ModPGroup", "-name", "modp2048"],
    ["-gen", "ModPGroup", "-name", "test256"],
    ["-gen", "ECqPGroup", "P-256"],
    ["-gen", "PRGHeuristic", "-hash", "SHA-512"],
    ["-gen", "PRGElGamal", "-name", "test256", "-width", "3"],
    ["-gen", "HashfunctionHeuristic", "SHA-384"],
    ["-gen", "HashfunctionPedersen", "-name", "test256"],
    ["-gen", "HashfunctionMerkleDamgaard", "-name", "test256"],
    ["-gen", "RandomDevice"],
    ["-list"],
]


@pytest.mark.parametrize("argv", VOG_CASES, ids=lambda a: "_".join(a[1:3]))
def test_vog_strings_equal_vmn_tpu(argv):
    from vmn_tpu.cli import vog as j_vog

    assert _port_vog(argv) == _vog(j_vog.main, argv)


def _groups():
    from vmn_tpu.arith.pgroup import ModPGroup as JGroup
    from vmn_tpu_torch.arith.pgroup import ModPGroup

    return (ModPGroup.named("test256", device="cpu"),
            JGroup.named("test256"))


def test_pedersen_and_merkle_damgaard_equal_vmn_tpu():
    import vmn_tpu.crypto.provable as J
    import vmn_tpu_torch.crypto.provable as T
    from vmn_tpu.eio.marshal import marshal_hex as j_marshal_hex
    from vmn_tpu_torch.eio.marshal import marshal_hex, unmarshal_hex

    tg, jg = _groups()
    tp, jp = T.HashfunctionPedersen(tg, 3), J.HashfunctionPedersen(jg, 3)
    assert tp.generators == jp.generators
    data = bytes(range(tp.input_bytes))
    assert tp.hash(data) == jp.hash(data)
    tm, jm = T.HashfunctionMerkleDamgaard(tp), J.HashfunctionMerkleDamgaard(jp)
    for msg in (b"", b"abc", bytes(range(200)) * 2):
        assert tm.hash(msg) == jm.hash(msg)
    d = tm.digest()
    d.update(b"ab")
    d.update(b"c")
    assert d.digest() == jm.hash(b"abc")
    hx = j_marshal_hex(jm)
    assert marshal_hex(tm) == hx
    assert unmarshal_hex(hx, "cpu").hash(b"xyz") == jm.hash(b"xyz")
    assert (T.resolve_hash("pedersen:test256:3", "cpu").hash(b"q")
            == J.resolve_hash("pedersen:test256:3").hash(b"q"))


def test_prg_elgamal_and_seed_file_source_equal_vmn_tpu(tmp_path):
    import vmn_tpu.crypto.provable as J
    import vmn_tpu_torch.crypto.provable as T
    from vmn_tpu.eio.marshal import marshal_hex as j_marshal_hex
    from vmn_tpu_torch.eio.marshal import marshal_hex, unmarshal_hex

    tg, jg = _groups()
    tprg, jprg = T.PRGElGamal(tg, 3, 100), J.PRGElGamal(jg, 3, 100)
    seed = hashlib.shake_256(b"elgamal").digest(tprg.min_seed_bytes)
    tprg.set_seed(seed)
    jprg.set_seed(seed)
    assert [tprg.read_bytes(n) for n in (1, 17, 100)] == [
        jprg.read_bytes(n) for n in (1, 17, 100)]
    hx = j_marshal_hex(jprg)
    assert marshal_hex(tprg) == hx
    assert repr(unmarshal_hex(hx, "cpu")) == repr(jprg)
    assert (repr(T.resolve_prg("elgamal:test256:3:100", "cpu"))
            == repr(J.resolve_prg("elgamal:test256:3:100")))

    # seed-file source: the stored seed is replaced before any output
    for tag in ("t", "j"):
        (tmp_path / tag).mkdir()
        (tmp_path / tag / "seed").write_bytes(
            hashlib.shake_256(b"seed").digest(tprg.min_seed_bytes))
    before = (tmp_path / "t" / "seed").read_bytes()
    ts = T.resolve_random_source("prg:elgamal:test256:3:100",
                                 directory=tmp_path / "t", device="cpu")
    js = J.resolve_random_source("prg:elgamal:test256:3:100",
                                 directory=tmp_path / "j")
    assert (tmp_path / "t" / "seed").read_bytes() != before
    assert ((tmp_path / "t" / "seed").read_bytes()
            == (tmp_path / "j" / "seed").read_bytes())
    assert ts.read_bytes(40) == js.read_bytes(40)
    assert ts.random_int_mod(tg.q) == js.random_int_mod(jg.q)
    assert ts.random_int(77) == js.random_int(77)


# (kind, operation arguments, inputs as (n, width), number of outputs)
VRE_CASES = {
    "ciphs_cat": (["-ciphs", "-cat"], [(3, 2), (4, 2)], 1),
    "ciphs_sub": (["-ciphs", "-sub", "1", "4"], [(5, 3)], 1),
    "ciphs_project": (["-ciphs", "-project", "2"], [(4, 3)], 1),
    "ciphs_widths": (["-ciphs", "-widths", "2,1"], [(4, 3)], 2),
    "ciphs_widths_one": (["-ciphs", "-widths", "1"], [(4, 1)], 1),
    "ciphs_shallow": (["-ciphs", "-shallow"], [(3, 3)], 3),
    "ciphs_deep": (["-ciphs", "-deep"], [(3, 1), (3, 1)], 1),
    "ciphs_format": (["-ciphs", "-format", "(0,1)x(1,0):(0,0-2)x(1,1)"],
                     [(4, 3), (4, 2)], 2),
    "ciphs_inter": (["-ciphs", "-inter", "0-2:1-5:5-6"], [(6, 2)], 3),
    "plain_cat": (["-plain", "-cat"], [(3, 2), (2, 2)], 1),
    "plain_sub": (["-plain", "-sub", "0", "2"], [(5, 2)], 1),
    "plain_project": (["-plain", "-project", "1"], [(3, 2)], 1),
    "plain_widths": (["-plain", "-widths", "1,2"], [(3, 3)], 2),
    "plain_shallow": (["-plain", "-shallow"], [(3, 2)], 2),
    "plain_deep": (["-plain", "-deep"], [(3, 1), (3, 1)], 1),
    "plain_format": (["-plain", "-format", "(0,1)x(0,0)"], [(3, 2)], 1),
    "pkeys_project": (["-pkeys", "-project", "0"], [(2, 1)], 1),
    "bad_format": (["-ciphs", "-format", "(0,9)"], [(3, 2)], 1),
    "bad_interval": (["-ciphs", "-inter", "3-1"], [(3, 2)], 1),
    "too_few_outputs": (["-ciphs", "-widths", "1,1,1"], [(3, 3)], 2),
}


def _plain(n, width):
    """A synthetic width-w plaintext array byte tree (c1..cw)."""
    comps = [node(*[leaf(bytes([3, c, i])) for i in range(n)])
             for c in range(width)]
    return node(*comps) if width > 1 else comps[0]


def _run_vre(main, d, ops, shapes, n_out, ciphs):
    """main's exit code (or its SystemExit text), its standard output
    and its output files' bytes, run in directory d."""
    d.mkdir()
    ins = []
    for i, (n, w) in enumerate(shapes):
        ins.append(d / f"in{i}.bt")
        (_ciphs(n, w) if ciphs else _plain(n, w)).write_file(ins[-1])
    outs = [d / f"out{i}.bt" for i in range(n_out)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            rc = main([*ops, *map(str, ins), *map(str, outs)])
        except SystemExit as e:
            rc = str(e.code)
    return rc, out.getvalue(), [o.read_bytes() if o.exists() else None
                                for o in outs]


@pytest.mark.parametrize("case", VRE_CASES)
def test_vre_equals_vmn_tpu(case, tmp_path):
    """The port's vre and vmn_tpu's on the same input files and
    arguments: the same exit (or error text), standard output and
    output bytes."""
    from vmn_tpu.cli import vre as j_vre

    ops, shapes, n_out = VRE_CASES[case]
    ciphs = ops[0] == "-ciphs"
    port = _run_vre(lambda a: vre.main(a, device="cpu"), tmp_path / "port",
                    ops, shapes, n_out, ciphs)
    jax_ = _run_vre(j_vre.main, tmp_path / "jax", ops, shapes, n_out, ciphs)
    assert port == jax_
    assert (port[0] == 0) == (not case.startswith(("bad", "too"))), port

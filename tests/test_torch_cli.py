"""The port's operator tools (`vmn_tpu_torch.cli`) against `vmn_tpu`'s,
on the CPU at test256: port copies of tests/test_cli.py and of the CLI
tests of tests/test_state.py, the two packages' CLI bytes for the same
info files and seed, each package's `vmnv` on the other's transcript,
the batched message encoding of `vmnd`, the private info checks (fault
F4, `arrays=file`) and the seed file's replacement at each `vmn`
invocation (fault F12).

Every tool is called as `main(argv, device="cpu")`.  Everything compared
is bytes or integers, so every tolerance here is exact equality.
"""

import contextlib
import io
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from torch_port_util import TV_NAMES, cuda_device, golden_files  # noqa: F401
from vmn_tpu_torch.cli import main as vtm
from vmn_tpu_torch.cli import vbt, vmn, vmnc, vmnd, vmni, vmnv, vre

GROUP = "named:test256"


def _cli(mod, argv, device="cpu"):
    return mod.main(argv, device=device)


def _seed_priv(tmp_path, seed=b"cli-seed"):
    """Point privInfo.xml's seed at a file of fixed bytes."""
    (tmp_path / "seed").write_bytes(seed)
    priv = (tmp_path / "privInfo.xml").read_text()
    priv = priv.replace("<seed />", f"<seed>{tmp_path}/seed</seed>")
    priv = priv.replace("<seed></seed>", f"<seed>{tmp_path}/seed</seed>")
    (tmp_path / "privInfo.xml").write_text(priv)


def _cli_protinfo(tmp_path, extra=(), sid="CliTest", seed=b"cli-seed"):
    """vmni protocol+party+merge with a deterministic seed."""
    assert _cli(vmni, [
        "-prot", "-sid", sid, "-nopart", "1", "-thres", "1",
        "-pgroup", GROUP, "-stub", "stub.xml", *extra,
    ]) == 0
    assert _cli(vmni, [
        "-party", "-name", "Party01", "-stub", "stub.xml",
        "-dir", str(tmp_path / "p1"), "-seed", "",
        "-out", "localProtInfo.xml",
    ]) == 0
    assert _cli(vmni, [
        "-merge", "localProtInfo.xml", "-out", "protInfo.xml",
    ]) == 0
    _seed_priv(tmp_path, seed)


def _keygen_ciphs(n, *extra):
    assert _cli(vmn, ["-keygen", "privInfo.xml", "protInfo.xml",
                      "publicKey.bt"]) == 0
    assert _cli(vmnd, ["-ciphs", "publicKey.bt", "ciphertexts.bt",
                       "-N", str(n), "-pgroup", GROUP, *extra]) == 0


# ------------------------------------------- port copies of test_cli.py


def test_cli_full_flow(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _cli_protinfo(tmp_path)
    _keygen_ciphs(5)
    assert (tmp_path / "publicKey.bt").exists()

    # vmnc: convert ciphertexts raw -> json -> raw
    assert _cli(vmnc, ["-ciphs", "ciphertexts.bt", "ciphertexts.json",
                       "-ini", "raw", "-outi", "json",
                       "-pgroup", GROUP]) == 0
    assert _cli(vmnc, ["-ciphs", "ciphertexts.json", "ciphertexts2.bt",
                       "-ini", "json", "-outi", "raw",
                       "-pgroup", GROUP]) == 0
    assert ((tmp_path / "ciphertexts.bt").read_bytes()
            == (tmp_path / "ciphertexts2.bt").read_bytes())

    # vre: slice and concatenate
    assert _cli(vre, ["-ciphs", "-sub", "0", "3", "ciphertexts.bt",
                      "front.bt"]) == 0
    assert _cli(vre, ["-ciphs", "-sub", "3", "5", "ciphertexts.bt",
                      "back.bt"]) == 0
    assert _cli(vre, ["-ciphs", "-cat", "front.bt", "back.bt",
                      "rejoined.bt"]) == 0
    assert ((tmp_path / "rejoined.bt").read_bytes()
            == (tmp_path / "ciphertexts.bt").read_bytes())

    assert _cli(vmn, ["-mix", "privInfo.xml", "protInfo.xml",
                      "ciphertexts.bt", "plaintexts.bt"]) == 0
    nizkp = str(tmp_path / "p1" / "nizkp.default")
    assert _cli(vmnv, ["protInfo.xml", nizkp, "-mix", "-v"]) == 0
    assert _cli(vbt, ["plaintexts.bt"]) == 0
    assert _cli(vtm, ["vbt", "plaintexts.bt"]) == 0
    assert _cli(vtm, ["bogus"]) == 2


def test_sact_lact_roundtrip(tmp_path, monkeypatch, capsys):
    """`vmn -sact` then `-lact` report the persisted active set."""
    monkeypatch.chdir(tmp_path)
    assert _cli(vmni, [
        "-prot", "-sid", "ActTest", "-nopart", "3", "-thres", "2",
        "-pgroup", GROUP, "-stub", "stub.xml",
    ]) == 0
    locals_ = []
    for i in (1, 2, 3):
        assert _cli(vmni, [
            "-party", "-name", f"Party{i:02d}", "-stub", "stub.xml",
            "-dir", str(tmp_path / f"p{i}"), "-seed", "",
            "-out", f"local{i}.xml",
            "-http", f"http://127.0.0.1:{8040 + i}",
            "-hint", f"127.0.0.1:{4040 + i}",
        ]) == 0
        (tmp_path / "privInfo.xml").rename(tmp_path / f"priv{i}.xml")
        locals_.append(f"local{i}.xml")
    assert _cli(vmni, ["-merge", *locals_, "-out", "protInfo.xml"]) == 0

    assert _cli(vmn, ["-lact", "priv1.xml", "protInfo.xml"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == "1,2,3"
    assert _cli(vmn, ["-sact", "1,3", "priv1.xml", "protInfo.xml"]) == 0
    capsys.readouterr()
    assert _cli(vmn, ["-lact", "priv1.xml", "protInfo.xml"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == "1,3"


def test_forcedwidth_cli(tmp_path, monkeypatch):
    """-width on the vmn command line overrides the protInfo width."""
    monkeypatch.chdir(tmp_path)
    _cli_protinfo(tmp_path)
    _keygen_ciphs(5, "-width", "2")
    assert _cli(vmn, ["-mix", "privInfo.xml", "protInfo.xml",
                      "ciphertexts.bt", "plaintexts.bt",
                      "-width", "2"]) == 0
    nizkp = str(tmp_path / "p1" / "nizkp.default")
    assert _cli(vmnv, ["protInfo.xml", nizkp, "-mix", "-width", "2"]) == 0
    assert _cli(vmnv, ["protInfo.xml", nizkp, "-mix", "-width", "3"]) != 0


def test_forcedmaxciph_cli(tmp_path, monkeypatch):
    """-maxciph on the command line overrides the protInfo value."""
    monkeypatch.chdir(tmp_path)
    _cli_protinfo(tmp_path, extra=["-maxciph", "6"])
    assert _cli(vmn, ["-keygen", "privInfo.xml", "protInfo.xml",
                      "publicKey.bt"]) == 0
    assert _cli(vmn, ["-precomp", "privInfo.xml", "protInfo.xml",
                      "-maxciph", "12"]) == 0
    assert _cli(vmnd, ["-ciphs", "publicKey.bt", "ciphertexts.bt",
                       "-N", "10", "-pgroup", GROUP]) == 0
    assert _cli(vmn, ["-mix", "privInfo.xml", "protInfo.xml",
                      "ciphertexts.bt", "plaintexts.bt",
                      "-maxciph", "12"]) == 0
    nizkp = str(tmp_path / "p1" / "nizkp.default")
    assert _cli(vmnv, ["protInfo.xml", nizkp, "-mix"]) == 0


def test_seq_interfaces_cli(tmp_path, monkeypatch):
    """seqhex input / seqjson output driven through vmnc + vmn."""
    monkeypatch.chdir(tmp_path)
    _cli_protinfo(tmp_path)
    _keygen_ciphs(5)
    assert _cli(vmnc, ["-ciphs", "ciphertexts.bt", "ciphertexts.seqhex",
                       "-ini", "raw", "-outi", "seqhex",
                       "-pgroup", GROUP]) == 0
    assert _cli(vmn, ["-mix", "privInfo.xml", "protInfo.xml",
                      "ciphertexts.seqhex", "plaintexts.seqjson",
                      "-ini", "seqhex", "-outi", "seqjson"]) == 0
    assert _cli(vmnc, ["-plain", "plaintexts.seqjson", "plaintexts.bt",
                       "-ini", "seqjson", "-outi", "raw",
                       "-pgroup", GROUP]) == 0
    nizkp = str(tmp_path / "p1" / "nizkp.default")
    assert _cli(vmnv, ["protInfo.xml", nizkp, "-mix"]) == 0


# ----------------------------- port copies of test_state.py's CLI tests


def test_precomp_survives_process_boundary(tmp_path, monkeypatch):
    """`vmn -precomp` then `vmn -mix` as separate invocations run the
    commitment-consistent (CCPoS) online path."""
    monkeypatch.chdir(tmp_path)
    _cli_protinfo(tmp_path, sid="StateTest", seed=b"state-seed")
    _keygen_ciphs(6)
    assert _cli(vmn, ["-precomp", "privInfo.xml", "protInfo.xml",
                      "-maxciph", "10"]) == 0
    state = tmp_path / "p1" / "state" / "session.default"
    assert (state / ".precomp").exists()
    assert (state / "ReencFactors.bt").exists()
    assert _cli(vmn, ["-mix", "privInfo.xml", "protInfo.xml",
                      "ciphertexts.bt", "plaintexts.bt"]) == 0
    proofs = tmp_path / "p1" / "nizkp.default" / "proofs"
    assert (proofs / "maxciph").exists(), "CCPoS path did not run"
    assert (proofs / "CCPoSCommitment01.bt").exists()
    assert (proofs / "KeepList01.bt").exists()
    assert _cli(vmnv, ["protInfo.xml",
                       str(tmp_path / "p1" / "nizkp.default"),
                       "-mix"]) == 0


def test_mix_resume_is_idempotent(tmp_path, monkeypatch):
    """A second `vmn -mix` reloads the recorded result; -delete resets
    the session and a fresh mix works again."""
    monkeypatch.chdir(tmp_path)
    _cli_protinfo(tmp_path, sid="StateTest", seed=b"state-seed")
    _keygen_ciphs(6)
    assert _cli(vmn, ["-mix", "privInfo.xml", "protInfo.xml",
                      "ciphertexts.bt", "plaintexts.bt"]) == 0
    first = (tmp_path / "plaintexts.bt").read_bytes()
    assert _cli(vmn, ["-mix", "privInfo.xml", "protInfo.xml",
                      "ciphertexts.bt", "plaintexts2.bt"]) == 0
    assert (tmp_path / "plaintexts2.bt").read_bytes() == first
    assert _cli(vmn, ["-delete", "privInfo.xml", "protInfo.xml"]) == 0
    assert _cli(vmn, ["-mix", "privInfo.xml", "protInfo.xml",
                      "ciphertexts.bt", "plaintexts3.bt"]) == 0


def test_keygen_idempotent_bytetree_state(tmp_path, monkeypatch):
    """keygen persists byte-tree key state and a rerun reloads it."""
    monkeypatch.chdir(tmp_path)
    _cli_protinfo(tmp_path, sid="StateTest", seed=b"state-seed")
    assert _cli(vmn, ["-keygen", "privInfo.xml", "protInfo.xml",
                      "publicKey.bt"]) == 0
    pk1 = (tmp_path / "publicKey.bt").read_bytes()
    state = tmp_path / "p1" / "state"
    assert (state / "KeyAndPoly.bt").exists()
    assert (state / "FullPublicKey.bt").exists()
    assert not (tmp_path / "p1" / ".vmn_state").exists()
    assert _cli(vmn, ["-keygen", "privInfo.xml", "protInfo.xml",
                      "publicKey2.bt"]) == 0
    assert (tmp_path / "publicKey2.bt").read_bytes() == pk1


# ------------------------------------------------ against vmn_tpu's CLI

OUTPUTS = ("publicKey.bt", "ciphertexts.bt", "plaintexts.bt")


def _quiet(fn, *args, **kw):
    """fn's return value and what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*args, **kw)
    return rc, out.getvalue()


def _tv_blocks(text: str) -> str:
    """The `-t` output of vmnv: its TEST VECTOR blocks."""
    return text[text.index("\nTEST VECTOR"):text.rindex("Proof is valid.")]


def _flow(root: Path, main_of, tools, precomp=False, seeds=None):
    """One operator flow in `root` over shared info files (relative
    directory and seed, so both packages read the same bytes):
    keygen, vmnd, (precomp), mix, vmnv -t; returns vmnv's output and the
    seed each `vmn` invocation read, by its mode.  The port replaces the
    seed file at each invocation (fault F12) and vmn_tpu does not, so a
    flow given `seeds` (vmn_tpu's) first gets, before each invocation,
    the seed that the port read at the same step."""
    cwd = os.getcwd()
    os.chdir(root)
    read = {}

    def vmn_(argv):
        if seeds is not None:
            (root / "seed").write_bytes(seeds[argv[0]])
        read[argv[0]] = (root / "seed").read_bytes()
        assert _quiet(main_of(tools["vmn"]), argv + ["-s"])[0] == 0

    try:
        vmn_(["-keygen", "privInfo.xml", "protInfo.xml", "publicKey.bt"])
        if precomp:
            vmn_(["-precomp", "privInfo.xml", "protInfo.xml", "-maxciph",
                  "6"])
        assert _quiet(main_of(tools["vmnd"]), [
            "-ciphs", "publicKey.bt", "ciphertexts.bt", "-N", "5",
            "-pgroup", GROUP])[0] == 0
        vmn_(["-mix", "privInfo.xml", "protInfo.xml", "ciphertexts.bt",
              "plaintexts.bt"])
    finally:
        os.chdir(cwd)
    return (_vmnv(main_of(tools["vmnv"]), root,
                  root / "p1" / "nizkp.default"), read)


def _vmnv(main, root: Path, nizkp: Path) -> str:
    rc, out = _quiet(main, [str(root / "protInfo.xml"), str(nizkp), "-mix",
                            "-t", ",".join(TV_NAMES)])
    assert rc == 0 and out.rstrip().endswith("Proof is valid."), out
    return out


def _shared_info(base: Path, sid: str, seed: bytes, tags) -> dict:
    """Info files with a relative party directory and seed file, made
    once in `base` and copied into base/<tag> for each tag."""
    cwd = os.getcwd()
    os.chdir(base)
    try:
        _cli(vmni, ["-prot", "-sid", sid, "-nopart", "1", "-thres", "1",
                    "-pgroup", GROUP, "-stub", "stub.xml"])
        _cli(vmni, ["-party", "-name", "Party01", "-stub", "stub.xml",
                    "-dir", "p1", "-seed", "seed",
                    "-out", "localProtInfo.xml"])
        _cli(vmni, ["-merge", "localProtInfo.xml", "-out", "protInfo.xml"])
    finally:
        os.chdir(cwd)
    (base / "seed").write_bytes(seed)
    roots = {}
    for tag in tags:
        roots[tag] = base / tag
        roots[tag].mkdir()
        for f in ("privInfo.xml", "protInfo.xml", "seed"):
            shutil.copy(base / f, roots[tag] / f)
    return roots


def _same_outputs(a: Path, b: Path) -> None:
    """Byte-equal nizkp directories and operator files of two flows."""
    na, nb = a / "p1" / "nizkp.default", b / "p1" / "nizkp.default"
    assert golden_files(na) == golden_files(nb)
    for rel in golden_files(na):
        assert (na / rel).read_bytes() == (nb / rel).read_bytes(), rel
    for f in OUTPUTS:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def _port_main(mod):
    return lambda argv: mod.main(argv, device="cpu")


def _jax_main(mod):
    return mod.main


@pytest.fixture(scope="module")
def both_flows(request, tmp_path_factory):
    """The same info files and seed through each package's CLI."""
    from vmn_tpu.cli import vmn as j_vmn
    from vmn_tpu.cli import vmnd as j_vmnd
    from vmn_tpu.cli import vmnv as j_vmnv

    roots = _shared_info(tmp_path_factory.mktemp("both"), "Both",
                         b"both-seed", ("port", "jax"))
    port = {"vmn": vmn, "vmnd": vmnd, "vmnv": vmnv}
    jax_ = {"vmn": j_vmn, "vmnd": j_vmnd, "vmnv": j_vmnv}
    outs, seeds = {}, {}
    outs["port"], seeds["port"] = _flow(roots["port"], _port_main, port,
                                        request.param)
    outs["jax"], seeds["jax"] = _flow(roots["jax"], _jax_main, jax_,
                                      request.param, seeds["port"])
    return (roots, outs, {"port": _port_main(vmnv), "jax": _jax_main(j_vmnv)},
            seeds)


@pytest.mark.parametrize("both_flows", [False], indirect=True,
                         ids=["plain"])
def test_cli_bytes_equal_vmn_tpu(both_flows):
    """Same info files and seed: byte-equal nizkp directories, public
    key, ciphertexts and plaintexts, and equal `vmnv -t` output."""
    roots, outs, _, _ = both_flows
    _same_outputs(roots["port"], roots["jax"])
    assert _tv_blocks(outs["port"]) == _tv_blocks(outs["jax"])


@pytest.mark.parametrize("both_flows", [False, True], indirect=True,
                         ids=["plain", "precomp"])
def test_vmnv_accepts_the_other_packages_transcript(both_flows):
    """Each package's vmnv on the other's CLI transcript: accepted, with
    the test vectors the other package's vmnv printed for it."""
    roots, outs, vmnvs, _ = both_flows
    for mine, other in (("port", "jax"), ("jax", "port")):
        out = _vmnv(vmnvs[mine], roots[other],
                    roots[other] / "p1" / "nizkp.default")
        assert _tv_blocks(out) == _tv_blocks(outs[other])


@pytest.mark.parametrize("both_flows", [True], indirect=True,
                         ids=["precomp"])
def test_cli_precomp_equals_one_process_run(both_flows, tmp_path):
    """`vmn -precomp` and `vmn -mix` as two invocations write the bytes
    of one party object that precomputes and then mixes (the session's
    source resumes at its saved position), keygen's and that object's
    sources seeded with what `-keygen` and `-precomp` read.  vmn_tpu's
    CLI restarts that source (fault F10), so its CCPoS blinders
    differ."""
    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.protocol.com.board import LocalBoardHub
    from vmn_tpu_torch.protocol.info import ProtocolInfo
    from vmn_tpu_torch.protocol.interfaces import RawInterface
    from vmn_tpu_torch.protocol.mixnet.party import MixNetParty

    roots, _, _, seeds = both_flows
    lib = tmp_path / "lib"
    lib.mkdir()
    params = ProtocolInfo.read(roots["port"] / "protInfo.xml") \
        .to_params("cpu")

    def party(mode):
        return MixNetParty(params, LocalBoardHub(1).board(1),
                           SeededSource(seeds["port"][mode]), str(lib / "p1"))

    raw = RawInterface()
    raw.write_public_key(party("-keygen").keygen(), lib / "publicKey.bt")
    p = party("-precomp")
    p.load_keys()
    session = p.session("default", 1)
    session.precomp(6)
    shutil.copy(roots["port"] / "ciphertexts.bt", lib / "ciphertexts.bt")
    ciphs = raw.read_ciphertexts(p.ctx.session("default").ciph_group(1),
                                 lib / "ciphertexts.bt")
    raw.write_plaintexts(session.mix(ciphs), lib / "plaintexts.bt")
    _same_outputs(roots["port"], lib)
    ccpos = Path("proofs") / "CCPoSCommitment01.bt"
    assert ((roots["jax"] / "p1" / "nizkp.default" / ccpos).read_bytes()
            != (lib / "p1" / "nizkp.default" / ccpos).read_bytes())


# conversion chains: (mode, input, output, input and output interfaces)
VMNC_CASES = {
    "pkey_json": [("-pkey", "publicKey.bt", "pk.json", "raw", "json"),
                  ("-pkey", "pk.json", "pk.bt", "json", "raw")],
    "pkey_native": [("-pkey", "publicKey.bt", "pk.nat", "raw", "native"),
                    ("-pkey", "pk.nat", "pk.bt", "native", "raw")],
    "ciphs_json": [("-ciphs", "ciphertexts.bt", "c.json", "raw", "json"),
                   ("-ciphs", "c.json", "c.bt", "json", "raw")],
    "ciphs_native": [("-ciphs", "ciphertexts.bt", "c.nat", "raw", "native"),
                     ("-ciphs", "c.nat", "c.bt", "native", "raw")],
    "ciphs_seqhex": [("-ciphs", "ciphertexts.bt", "c.sh", "raw", "seqhex"),
                     ("-ciphs", "c.sh", "c.bt", "seqhex", "raw")],
    "ciphs_seqjson": [("-ciphs", "ciphertexts.bt", "c.sj", "raw", "seqjson"),
                      ("-ciphs", "c.sj", "c.bt", "seqjson", "json")],
    "plain_json": [("-plain", "plaintexts.bt", "m.json", "raw", "json"),
                   ("-plain", "m.json", "m.bt", "json", "raw")],
    "plain_native": [("-plain", "plaintexts.bt", "m.nat", "raw", "native"),
                     ("-plain", "m.nat", "m.bt", "native", "raw")],
    "plain_seqjson": [("-plain", "plaintexts.bt", "m.sj", "raw", "seqjson"),
                      ("-plain", "m.sj", "m.bt", "seqjson", "raw")],
    "plain_seqhex": [("-plain", "plaintexts.bt", "m.sh", "raw", "seqhex")],
    "plain_jsondecode": [("-plain", "plaintexts.bt", "m.txt", "raw",
                          "jsondecode")],
    "unknown_interface": [("-ciphs", "ciphertexts.bt", "c.x", "raw",
                           "bogus")],
}


def _run_tool(main, argv):
    """(exit code or the raised error's class and text, stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = str(e.code)
        except Exception as e:  # noqa: BLE001 - compared across packages
            rc = f"{type(e).__name__}: {e}"
    return rc, out.getvalue()


@pytest.mark.parametrize("both_flows", [False], indirect=True,
                         ids=["plain"])
@pytest.mark.parametrize("case", VMNC_CASES)
def test_vmnc_equals_vmn_tpu(both_flows, case, tmp_path, monkeypatch):
    """The port's vmnc and vmn_tpu's on the same files and arguments,
    step by step through a conversion chain: the same exit (or error),
    standard output and output bytes."""
    from vmn_tpu.cli import vmnc as j_vmnc

    roots, _, _, _ = both_flows
    got = {}
    for tag, main in (("port", _port_main(vmnc)), ("jax", j_vmnc.main)):
        d = tmp_path / tag
        d.mkdir()
        for f in OUTPUTS:
            shutil.copy(roots["port"] / f, d / f)
        monkeypatch.chdir(d)
        got[tag] = []
        for mode, src, dst, ini, outi in VMNC_CASES[case]:
            rc, out = _run_tool(main, [mode, src, dst, "-ini", ini,
                                       "-outi", outi, "-pgroup", GROUP])
            got[tag].append((rc, out, (d / dst).read_bytes()
                             if (d / dst).exists() else None))
    assert got["port"] == got["jax"]
    assert all(rc == 0 for rc, _, _ in got["port"]) == (
        case != "unknown_interface"), got["port"]


@pytest.mark.parametrize("both_flows", [False], indirect=True,
                         ids=["plain"])
@pytest.mark.parametrize("argv", [["plaintexts.bt"], ["publicKey.bt"],
                                  ["-hex", "ciphertexts.hex"]],
                         ids=["plaintexts", "publicKey", "hex"])
def test_vbt_equals_vmn_tpu(both_flows, argv, monkeypatch):
    """The port's vbt and vmn_tpu's print the same dump."""
    from vmn_tpu.cli import vbt as j_vbt
    from vmn_tpu_torch.eio.bytetree import ByteTree

    roots, _, _, _ = both_flows
    monkeypatch.chdir(roots["port"])
    Path("ciphertexts.hex").write_text(
        ByteTree.read_file("ciphertexts.bt").to_bytes().hex() + "\n")
    port = _run_tool(_port_main(vbt), argv)
    assert port == _run_tool(j_vbt.main, argv)
    assert port[0] == 0 and port[1].count("\n") > 3


def test_vmnd_batched_encoding_matches_encode_message():
    """encode_messages gives vmn_tpu's encode_message element for each
    message, on messages that take both branches (m and p - m)."""
    from vmn_tpu.arith.pgroup import ModPGroup as JGroup
    from vmn_tpu_torch.arith.pgroup import ModPGroup

    rng = np.random.default_rng(9)
    msgs = [f"{i:08d}".encode() for i in range(40)]
    msgs += [rng.bytes(int(n)) for n in rng.integers(0, 28, 40)]
    jg = JGroup.named("test256")
    want = [jg.encode_message(m) for m in msgs]
    got = ModPGroup.named("test256", device="cpu").encode_messages(msgs)
    assert got.to_ints() == want
    padded = [int.from_bytes(len(m).to_bytes(4, "big")
                             + m.ljust(jg.nbits // 8 - 4, b"\0"), "big") + 1
              for m in msgs]
    branches = {w == m for w, m in zip(want, padded)}
    assert branches == {True, False}


def test_arrays_file_refused(tmp_path, monkeypatch):
    """A private info with arrays=file is no longer refused (the port has
    its out-of-core arrays, `arith/storage.py`): vmn -keygen runs and
    selects the file backend under <dir>/arrays, as vmn_tpu's vmn does
    (vmn_tpu/cli/vmn.py:64-70)."""
    from vmn_tpu_torch.arith import storage

    monkeypatch.setattr(storage, "_BACKEND", storage._BACKEND)
    monkeypatch.setattr(storage, "_SPILL_DIR", storage._SPILL_DIR)
    monkeypatch.chdir(tmp_path)
    _cli_protinfo(tmp_path, extra=[])
    priv = (tmp_path / "privInfo.xml").read_text()
    assert "<arrays>ram</arrays>" in priv
    (tmp_path / "privInfo.xml").write_text(
        priv.replace("<arrays>ram</arrays>", "<arrays>file</arrays>"))
    assert _cli(vmn, ["-keygen", "privInfo.xml", "protInfo.xml",
                      "publicKey.bt"]) == 0
    assert (tmp_path / "publicKey.bt").exists()
    assert storage.backend() == "file"
    assert storage._SPILL_DIR == tmp_path / "p1" / "arrays"
    assert storage._SPILL_DIR.is_dir()


def test_wrong_private_info_refused_f4(tmp_path, monkeypatch):
    """Fault F4: vmn_tpu's vmn accepts the mergeable stub
    (localProtInfo.xml, root <protocol>) as the private info and runs;
    the port's vmn refuses it, and a private info without its fields."""
    from vmn_tpu.cli import vmn as j_vmn

    monkeypatch.chdir(tmp_path)
    _cli_protinfo(tmp_path)
    stub = ["-keygen", "localProtInfo.xml", "protInfo.xml", "pk.bt", "-s"]
    assert j_vmn.main(stub) == 0  # the fault: keys land in ./state
    assert (tmp_path / "state" / "KeyAndPoly.bt").exists()
    with pytest.raises(SystemExit) as e:
        _cli(vmn, stub)
    assert "not a private info file" in str(e.value.code)
    assert "<protocol>" in str(e.value.code)
    (tmp_path / "bare.xml").write_text("<private><name>P</name></private>")
    with pytest.raises(SystemExit) as e:
        _cli(vmn, ["-keygen", "bare.xml", "protInfo.xml", "pk.bt"])
    assert "<dir>" in str(e.value.code) and "<skey>" in str(e.value.code)


def _session_seed(root: Path) -> bytes:
    return (root / "p1" / "state" / "session.default"
            / "session_seed").read_bytes()


def _keygen_mix(main, root: Path) -> dict:
    """vmn -keygen, the port's vmnd, vmn -mix in root through `main` (a
    vmn's entry point); the seed file's bytes before each vmn and at
    the end."""
    seen = {}
    for mode, argv in (
            ("-keygen", ["publicKey.bt"]),
            ("-mix", ["ciphertexts.bt", "plaintexts.bt"])):
        if mode == "-mix":
            assert _cli(vmnd, ["-ciphs", "publicKey.bt", "ciphertexts.bt",
                               "-N", "5", "-pgroup", GROUP]) == 0
        seen[mode] = (root / "seed").read_bytes()
        assert main([mode, "privInfo.xml", "protInfo.xml", *argv,
                     "-s"]) == 0
    seen["end"] = (root / "seed").read_bytes()
    return seen


def test_seed_file_advances_f12(tmp_path, monkeypatch):
    """Fault F12, repaired: the port's vmn replaces the seed file before
    each invocation draws anything, so -mix reads another seed than
    -keygen, and the session's seed is not the start of the stream that
    -keygen drew the secret key from."""
    from vmn_tpu_torch.crypto.randomsource import SeededSource

    monkeypatch.chdir(tmp_path)
    _cli_protinfo(tmp_path)
    seen = _keygen_mix(lambda a: _cli(vmn, a), tmp_path)
    assert seen["-keygen"] == b"cli-seed"
    assert len(set(seen.values())) == 3
    session = _session_seed(tmp_path)
    assert not SeededSource(seen["-keygen"]).read_bytes(4096).startswith(
        session)
    assert session == SeededSource(seen["-mix"]).read_bytes(32)


def test_vmn_tpu_replays_the_keygen_stream_f12(tmp_path, monkeypatch):
    """vmn_tpu's behaviour (fault F12), which stays as it is: its vmn
    leaves the seed file as it found it, so -mix restarts the stream of
    -keygen's seed and the session's seed is that stream's first 32
    bytes, the bytes -keygen drew first."""
    from vmn_tpu.cli import vmn as j_vmn
    from vmn_tpu.crypto.randomsource import SeededSource as JSeededSource

    monkeypatch.chdir(tmp_path)
    _cli_protinfo(tmp_path)
    seen = _keygen_mix(j_vmn.main, tmp_path)
    assert set(seen.values()) == {b"cli-seed"}
    assert _session_seed(tmp_path) == JSeededSource(b"cli-seed").read_bytes(
        32)


@pytest.mark.cuda
def test_cuda_cli_flow_bytes_equal_cpu(tmp_path, cuda_device):
    """The test256 CLI flow on the card writes the CPU flow's bytes."""
    roots = _shared_info(tmp_path, "Card", b"card-seed", ("cpu", "cuda"))
    tools = {"vmn": vmn, "vmnd": vmnd, "vmnv": vmnv}
    outs = {dev: _flow(roots[dev],
                       lambda mod, d=dev: (lambda a: mod.main(a, device=d)),
                       tools)[0]
            for dev in roots}
    _same_outputs(roots["cpu"], roots["cuda"])
    assert _tv_blocks(outs["cpu"]) == _tv_blocks(outs["cuda"])

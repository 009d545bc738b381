"""The port's DeviceSource: prover randomness expanded on the device by
ChaCha20 (ops/prf_kernels.py, crypto/randomsource.py), on the CPU.

`vmn_tpu`'s DeviceSource expands its draws with Threefry under a key of
64 bits (ROADMAP F1), so the port's device draws differ from it by
design.  What can be equal is held equal to `vmn_tpu`: the host stream
byte for byte, the limb layout and bit bounds of `_prf_limbs`, the
permutation of a mix (and so `Plaintexts.bt`), and each package's
verifier accepting the other's transcript.  The PRF itself is held to
RFC 8439 §2.3.2's test block and to `cryptography`'s ChaCha20 (OpenSSL),
an independent implementation.  `tests/test_devicesource.py` pins
`vmn_tpu`'s own source and stays as it is; its tests are ported below.

Tolerance: exact equality throughout (integer arithmetic and bytes).
"""

import struct
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401 (torch thread count)
from torch_port_util import cuda_device  # noqa: F401
from vmn_tpu_torch.arith.pgroup import ModPGroup
from vmn_tpu_torch.crypto import randomsource as R
from vmn_tpu_torch.crypto.hash import SHA256
from vmn_tpu_torch.crypto.prg import PRGHeuristic
from vmn_tpu_torch.crypto.randomsource import DeviceSource, SeededSource
from vmn_tpu_torch.ops import prf_kernels as P
from vmn_tpu_torch.protocol import elgamal
from vmn_tpu_torch.protocol.com.board import LocalBoardHub
from vmn_tpu_torch.protocol.context import ProtocolParams
from vmn_tpu_torch.protocol.mixnet.party import MixNetParty, MixSession
from vmn_tpu_torch.protocol.mixnet.verifier import FiatShamirVerifier

CPU = torch.device("cpu")
GROUP = ModPGroup.named("test256", device="cpu")

# RFC 8439 §2.3.2: key 00 01 .. 1f, nonce 00 00 00 09 00 00 00 4a 00 00
# 00 00, block counter 1; the serialized block.
RFC_BLOCK = bytes([
    0x10, 0xf1, 0xe7, 0xe4, 0xd1, 0x3b, 0x59, 0x15,
    0x50, 0x0f, 0xdd, 0x1f, 0xa3, 0x20, 0x71, 0xc4,
    0xc7, 0xd1, 0xf4, 0xc7, 0x33, 0xc0, 0x68, 0x03,
    0x04, 0x22, 0xaa, 0x9a, 0xc3, 0xd4, 0x6c, 0x4e,
    0xd2, 0x82, 0x64, 0x46, 0x07, 0x9f, 0xaa, 0x09,
    0x14, 0xc2, 0xd7, 0x05, 0xd9, 0x8b, 0x02, 0xa2,
    0xb5, 0x12, 0x9c, 0xd1, 0xde, 0x16, 0x4e, 0xb9,
    0xcb, 0xd0, 0x83, 0xe8, 0xa2, 0x50, 0x3c, 0x4e,
])


def keystream(key: bytes, nonce0: int, draw: int, counter: int,
              nbytes: int) -> bytes:
    """`cryptography`'s ChaCha20 keystream: its 16-byte nonce is the
    4-byte little-endian counter, then RFC 8439's 12-byte nonce."""
    algorithms = pytest.importorskip(
        "cryptography.hazmat.primitives.ciphers.algorithms")
    from cryptography.hazmat.primitives.ciphers import Cipher

    nonce = (struct.pack("<I", counter) + struct.pack("<I", nonce0)
             + draw.to_bytes(8, "little"))
    enc = Cipher(algorithms.ChaCha20(key, nonce), mode=None).encryptor()
    return enc.update(b"\0" * nbytes)


def layout_limbs(stream: bytes, n: int, bits: int) -> np.ndarray:
    """`vmn_tpu`'s `_prf_limbs` layout over a keystream: rows of nw
    little-endian words, split low half first, Lt limbs, top masked."""
    lt = -(-bits // 16)
    nw = (lt + 1) // 2
    words = np.frombuffer(stream[:4 * n * nw], "<u4").reshape(n, nw)
    limbs = np.stack([words & 0xFFFF, words >> 16], -1)
    limbs = limbs.reshape(n, 2 * nw)[:, :lt].astype(np.int64)
    limbs[:, -1] &= (1 << (bits - 16 * (lt - 1))) - 1
    return limbs


# ---------------------------------------------------------------- the PRF


def test_plain_block_matches_rfc8439():
    got = P.chacha20_limbs(bytes(range(32)), 0x4A000000, 1, 512,
                           device=CPU, counter=1, nonce0=0x09000000)
    assert got.shape == (1, 32) and got.dtype == torch.int32
    assert R.limbs_bytes(got) == RFC_BLOCK
    assert RFC_BLOCK[:8] == bytes.fromhex("10f1e7e4d13b5915")
    assert R.RFC_BLOCK == RFC_BLOCK


@pytest.mark.parametrize("draw", [0, 1, 7, (1 << 32) + 5, (1 << 64) - 1])
def test_plain_keystream_matches_cryptography(draw):
    """512 bits a row over 5 rows: blocks at counters 0..4; and rows of
    100 bits from counter 3 on (a row inside a block, blocks past the
    first)."""
    key = SHA256.hash(b"prf-key-%d" % draw)
    got = P.chacha20_limbs(key, draw, 5, 512, device=CPU)
    assert R.limbs_bytes(got) == keystream(key, 0, draw, 0, 5 * 64)
    got = P.chacha20_limbs(key, draw, 40, 100, device=CPU, counter=3)
    want = layout_limbs(keystream(key, 0, draw, 3, 40 * 16), 40, 100)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [100, 64, 356, 621, 2148, 17])
def test_random_limbs_layout_and_row_ranges(bits):
    """DeviceSource draws under `_prf_limbs`'s layout of the keystream of
    its key and draw index: odd Lt (100, 356, 621, 17 bits) and even (64,
    2148), top limbs masked or whole (64); every row range equal to
    those rows of the whole draw, ranges that start mid-block and empty
    ones included."""
    src = DeviceSource(b"layout")
    n = 23
    lt = -(-bits // 16)
    stream = keystream(src.key, 0, 0, 0, 4 * n * ((lt + 1) // 2) + 64)
    whole = src.random_limbs(n, bits, CPU)
    assert src.draws == 1 and src.position == 0
    assert whole.shape == (n, lt) and whole.dtype == torch.int32
    want = layout_limbs(stream, n, bits)
    assert np.array_equal(whole.numpy(), want)
    for a, b in [(0, n), (1, 2), (3, 17), (9, 9), (22, 23), (0, 0)]:
        part = P.chacha20_limbs(src.key, 0, n, bits, rows=(a, b),
                                device=CPU)
        assert np.array_equal(part.numpy(), want[a:b]), (a, b)
    second = src.random_limbs(n, bits, CPU)
    assert np.array_equal(second.numpy(), layout_limbs(
        keystream(src.key, 0, 1, 0, len(stream)), n, bits))


KERNEL_THREADS, STAGED_ROW = 256, 17  # csrc/prf_kernels.cu's kThreads


def kernel_store_walk(key: bytes, draw: int, n: int, bits: int,
                      rows=None) -> np.ndarray:
    """Rows [a, b) of a draw as `chacha_limbs_kernel`
    (csrc/prf_kernels.cu) stores them, its integer steps repeated in
    Python: the launch's blocks of KERNEL_THREADS ChaCha20 blocks, each
    block's keystream words staged in rows of STAGED_ROW words, then
    thread i of a block storing limbs o0 + i, o0 + i + KERNEL_THREADS,
    ... of its words' limbs [o0, o1), stepping (row, limb) as it does.
    Every limb must be stored exactly once."""
    a, b, lt, nw, top = P.layout(n, bits, rows)
    word0, word1 = a * nw, b * nw
    blk0 = word0 // 16
    nblk = (word1 + 15) // 16 - blk0
    top_mask = (1 << top) - 1
    out = np.full((b - a) * lt, -1, dtype=np.int64)
    if b == a:
        return out.reshape(b - a, lt)
    q, r = KERNEL_THREADS // lt, KERNEL_THREADS % lt
    for bx in range(-(-nblk // KERNEL_THREADS)):
        first_blk = blk0 + bx * KERNEL_THREADS
        nb = min(KERNEL_THREADS, nblk - bx * KERNEL_THREADS)
        words = P.chacha20_blocks_plain(
            key, (0, draw & 0xFFFFFFFF, draw >> 32),
            torch.arange(first_blk, first_blk + nb)).numpy()
        staged = np.zeros(KERNEL_THREADS * STAGED_ROW, dtype=np.int64)
        for t in range(nb):
            staged[t * STAGED_ROW:t * STAGED_ROW + 16] = words[t]
        base = first_blk * 16
        w0, w1 = max(base, word0), min(base + nb * 16, word1)
        if w0 >= w1:
            continue
        r0, r1 = (w0 - word0) // nw, (w1 - word0) // nw
        o0 = r0 * lt + 2 * (w0 - word0 - r0 * nw)
        o1 = r1 * lt + 2 * (w1 - word0 - r1 * nw)
        for t in range(KERNEL_THREADS):
            o = o0 + t
            row, c = o // lt, o % lt
            while o < o1:
                g = word0 + row * nw + (c >> 1) - base
                assert 0 <= g < nb * 16
                w = int(staged[(g >> 4) * STAGED_ROW + (g & 15)])
                mask = top_mask if c == lt - 1 else 0xFFFF
                assert out[o] == -1, o
                out[o] = ((w >> 16) if c & 1 else (w & 0xFFFF)) & mask
                o += KERNEL_THREADS
                c, row = c + r, row + q
                if c >= lt:
                    c, row = c - lt, row + 1
    return out.reshape(b - a, lt)


@pytest.mark.parametrize("n, bits, rows", [
    (70, 2147, None),       # modp2048's rows: two blocks of the launch
    (70, 2147, (3, 61)),    # a range from mid-block
    (300, 356, (7, 299)),   # P-256's rows, odd Lt
    (20, 4200, (1, 19)),    # Lt = 263 > the block's threads
    (40, 16, None),         # one limb a row, whole top limb
    (33, 17, (5, 32)),      # two limbs, a 1-bit top limb
])
def test_kernel_store_walk_equals_plain(n, bits, rows):
    """The kernel's store loop, walked on the CPU, stores every limb of
    rows [a, b) once, equal to the plain version's (the kernel itself is
    held to it on the card)."""
    key = SHA256.hash(b"walk")
    got = kernel_store_walk(key, 5, n, bits, rows)
    want = P.chacha20_limbs_plain(key, 5, n, bits, rows, CPU).numpy()
    assert np.array_equal(got, want)


def test_draw_past_the_block_counter_raises():
    with pytest.raises(ValueError, match="2\\^32"):
        P.layout(1 << 32, 512, None, counter=1)
    with pytest.raises(ValueError, match="rows"):
        P.layout(4, 64, (3, 5))
    assert P.layout(1 << 32, 512, (5, 6)) == (5, 6, 32, 16, 16)


# ----------------------------------------------------- the host stream


def test_read_bytes_equals_vmn_tpu():
    """Same seed, same host bytes; a device draw between reads reads no
    host byte in either package."""
    from vmn_tpu.crypto.randomsource import DeviceSource as JDevice

    mine, theirs = DeviceSource(b"host-seed"), JDevice(b"host-seed")
    for n in (1, 31, 32, 33, 500):
        assert mine.read_bytes(n) == theirs.read_bytes(n)
    mine.random_limbs(4, 100, CPU)
    theirs.random_limbs(4, 100)
    assert mine.read_bytes(64) == theirs.read_bytes(64)
    assert mine.position == 1 + 31 + 32 + 33 + 500 + 64
    assert mine.random_int(200) == theirs.random_int(200)


# --------------------------------------- tests/test_devicesource.py's


def test_determinism_and_independence():
    ring = GROUP.ring
    a = ring.random((64,), DeviceSource(b"s"), 128).to_ints()
    rs = DeviceSource(b"s")
    a2 = ring.random((64,), rs, 128).to_ints()
    b = ring.random((64,), rs, 128).to_ints()
    assert a == a2  # same seed, same draw index
    assert a != b  # the draw counter advances
    assert a != ring.random((64,), DeviceSource(b"t"), 128).to_ints()
    assert all(0 <= x < ring.q for x in a)


def test_bit_bounds():
    ring = GROUP.ring
    r = ring.random_bits(256, 100, DeviceSource(b"s")).to_ints()
    assert all(x < (1 << 100) for x in r)
    # not collapsing to narrow values
    assert max(x.bit_length() for x in r) > 90
    raw = ring.random_bits_raw(8, 100, DeviceSource(b"s"))
    assert raw.shape == (8, ring.L)  # padded to the field's limbs


def test_scalar_draw_is_one_row():
    """A scalar (shape ()) is one row of its own draw: the first row of
    a one-row draw under the next index."""
    rs = DeviceSource(b"scalar")
    x = GROUP.ring.random((), rs, 50)
    assert x.limbs.shape == (GROUP.ring.L,) and rs.draws == 1
    again = GROUP.ring.random((1,), DeviceSource(b"scalar"), 50)
    assert x.to_int() == again.to_ints()[0]


# ------------------------------------------------------- F1, F2, F3


def test_f1_key_has_256_bits():
    """Two hashed seeds that differ only past their first 8 bytes give
    different keys and different draws (vmn_tpu's Threefry key takes 64
    bits of them; ROADMAP F1); the key is SHA-256 over all 32."""
    def of_state(state):
        src = DeviceSource(b"")
        src._seed = state
        src.key = SHA256.hash(state + DeviceSource.KEY_TAG)
        return src

    state = SHA256.hash(b"f1")
    other = state[:8] + bytes(b ^ 0x5A for b in state[8:])
    a, b = of_state(state), of_state(other)
    assert len(a.key) == 32 and a.key != b.key
    assert a.key == DeviceSource(b"f1").key
    assert not torch.equal(a.random_limbs(16, 256, CPU),
                           b.random_limbs(16, 256, CPU))
    # and one flipped bit in the last byte is enough
    assert of_state(state[:31] + bytes([state[31] ^ 1])).key != a.key


def test_f2_prf_is_pinned(monkeypatch):
    """The PRF is named, and a device whose PRF does not give RFC 8439's
    block is refused at its first draw."""
    assert P.PRF == "ChaCha20/20, RFC 8439"
    monkeypatch.setattr(R, "_CHECKED", set())
    monkeypatch.setattr(P, "chacha20_limbs", lambda *a, **k: torch.zeros(
        (1, 32), dtype=torch.int32))
    with pytest.raises(RuntimeError, match="not ChaCha20/20"):
        DeviceSource(b"f2").random_limbs(1, 64, CPU)


def test_f3_no_marshal_form():
    from vmn_tpu_torch.eio.bytetree import ByteTreeError, leaf, node
    from vmn_tpu_torch.eio.marshal import marshal, unmarshal

    with pytest.raises(TypeError, match="F3"):
        marshal(DeviceSource(b"seed-bytes"))
    bt = node(leaf(DeviceSource.MARSHAL_NAME.encode()),
              leaf(SHA256.hash(b"seed-bytes")))
    with pytest.raises(ByteTreeError, match="unknown marshalled class"):
        unmarshal(bt, device="cpu")


def test_f3_vmn_tpu_round_trip_replays_draw_0():
    """vmn_tpu's marshal form is the hashed seed alone: a source restored
    after a draw draws draw 0 again."""
    from vmn_tpu.arith.pgroup import ModPGroup as JG
    from vmn_tpu.crypto.randomsource import DeviceSource as JDevice
    from vmn_tpu.eio.marshal import marshal, unmarshal

    ring = JG.named("test256").ring
    rs = JDevice(b"seed-bytes")
    first = ring.random((8,), rs, 64).to_ints()
    restored = unmarshal(marshal(rs))
    assert ring.random((8,), restored, 64).to_ints() == first


# ------------------------------------------------------------ sessions


def test_session_keeps_a_device_source():
    """A session over a state directory draws from a source seeded by its
    persisted secret: a DeviceSource for a DeviceSource party in the
    port, always a SeededSource in vmn_tpu (README port deviations)."""
    from vmn_tpu.arith.pgroup import ModPGroup as JG
    from vmn_tpu.crypto.randomsource import DeviceSource as JDevice
    from vmn_tpu.crypto.randomsource import SeededSource as JSeeded
    from vmn_tpu.protocol.com.board import LocalBoardHub as JHub
    from vmn_tpu.protocol.context import ProtocolParams as JParams
    from vmn_tpu.protocol.mixnet.party import MixNetParty as JParty

    with tempfile.TemporaryDirectory() as tmp:
        mine = MixNetParty(_params(), LocalBoardHub(1).board(1),
                           DeviceSource(b"p"), str(Path(tmp) / "port"))
        assert isinstance(mine.session("s", 1).rs, DeviceSource)
        seeded = MixNetParty(_params(), LocalBoardHub(1).board(1),
                             SeededSource(b"p"), str(Path(tmp) / "seeded"))
        assert isinstance(seeded.session("s", 1).rs, SeededSource)
        theirs = JParty(JParams(sid="DS", k=1, threshold=1,
                                pgroup=JG.named("test256")),
                        JHub(1).board(1), JDevice(b"p"),
                        str(Path(tmp) / "vmn_tpu"))
        assert type(theirs.session("s", 1).rs) is JSeeded


def _params(sid="DS"):
    return ProtocolParams(sid=sid, k=1, threshold=1, pgroup=GROUP)


def _encrypt(pk, n: int, tag: bytes):
    prg = PRGHeuristic(SHA256)
    prg.set_seed(SHA256.hash(tag + b"-msgs"))
    m = GROUP.random_array(n, prg, 100)
    return m, elgamal.encrypt(pk, m, GROUP.ring.random(
        (n,), SeededSource(tag + b"-ciphs"), 0))


def test_precomp_resumes_the_draw_count(tmp_path, monkeypatch):
    """A precomputation with a DeviceSource party, persisted, then the
    mix from a fresh party on the same directory: the restored session's
    source resumes its draw count (`SourceDraws` beside
    `SourcePosition`), so the online mix's draw indices are new, and its
    transcript equals the one-object run's byte for byte."""
    drawn = []
    kernel = P.chacha20_limbs

    def logged(key, draw, *args, **kw):
        drawn.append((key, draw))
        return kernel(key, draw, *args, **kw)

    monkeypatch.setattr(P, "chacha20_limbs", logged)

    def run(directory, fresh):
        del drawn[:]
        party = MixNetParty(_params("PC"), LocalBoardHub(1).board(1),
                            DeviceSource(b"pc-party"), str(directory))
        m, ciphs = _encrypt(party.keygen(), 5, b"pc")
        party.board = LocalBoardHub(1).board(1)
        session = party.session("pc", 1)
        session.precomp(8)
        pre = {k for k in drawn if k[0] == session.rs.key}
        if fresh:
            assert session.state.read_int("SourceDraws") == \
                session.rs.draws > 0
            party = MixNetParty(_params("PC"), LocalBoardHub(1).board(1),
                                DeviceSource(b"unused"), str(directory))
            party.keygen()  # reloads the cached key state
            session = party.session("pc", 1)
            assert session.rs.draws == 0
        del drawn[:]
        plain = session.mix(ciphs)
        assert sorted(plain.to_ints()) == sorted(m.to_ints())
        online = {k for k in drawn if k[0] == session.rs.key}
        return directory / "nizkp.pc", pre, online

    whole, _, _ = run(tmp_path / "one", False)
    nizkp, pre, online = run(tmp_path / "two", True)
    assert pre and online and not pre & online
    assert min(d for _, d in online) == max(d for _, d in pre) + 1
    files = sorted(p.relative_to(whole) for p in whole.rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(nizkp) for p in nizkp.rglob("*")
                           if p.is_file())
    for rel in files:
        assert (whole / rel).read_bytes() == (nizkp / rel).read_bytes(), rel
    assert FiatShamirVerifier(_params("PC"), nizkp).verify(
        expected_type="mixing").ok


@pytest.fixture(scope="module")
def both_mixes(tmp_path_factory):
    """The test256 k=1 mix of tests/test_devicesource.py with
    DeviceSource(b"p1") in both packages, each session drawing from the
    party's source (no state directory; the transcript in its nizkp
    directory): (port params, port nizkp, port messages, port
    plaintexts, vmn_tpu's params, nizkp, messages, plaintexts)."""
    from vmn_tpu.arith.pgroup import ModPGroup as JG
    from vmn_tpu.crypto.hash import SHA256 as JSHA
    from vmn_tpu.crypto.prg import PRGHeuristic as JPRG
    from vmn_tpu.crypto.randomsource import DeviceSource as JDevice
    from vmn_tpu.crypto.randomsource import SeededSource as JSeeded
    from vmn_tpu.protocol import elgamal as jelg
    from vmn_tpu.protocol.com.board import LocalBoardHub as JHub
    from vmn_tpu.protocol.context import ProtocolParams as JParams
    from vmn_tpu.protocol.mixnet.party import MixNetParty as JParty
    from vmn_tpu.protocol.mixnet.party import MixSession as JSession

    out = tmp_path_factory.mktemp("devicesource_mix")
    port = (GROUP, ProtocolParams, LocalBoardHub, MixNetParty, MixSession,
            DeviceSource, SeededSource, PRGHeuristic, SHA256, elgamal)
    jgrp = JG.named("test256")
    theirs = (jgrp, JParams, JHub, JParty, JSession, JDevice, JSeeded,
              JPRG, JSHA, jelg)
    res = []
    for name, (grp, Params, Hub, Party, Session, Device, Seeded, PRG, H,
               elg) in (("port", port), ("vmn_tpu", theirs)):
        params = Params(sid="DS", k=1, threshold=1, pgroup=grp)
        party = Party(params, Hub(1).board(1), Device(b"p1"))
        pk = party.keygen()
        prg = PRG(H)
        prg.set_seed(H.hash(b"m"))
        m = grp.random_array(8, prg, params.rbitlen)
        ciphs = elg.encrypt(pk, m, grp.ring.random((8,), Seeded(b"e"), 0))
        party.board = Hub(1).board(1)
        nizkp = out / name / "nizkp.d"
        plain = Session(party, "d", 1, nizkp).mix(ciphs)
        res += [params, nizkp, m.to_ints(), plain.to_ints()]
    return res


def test_both_mixes_preserve_the_multiset(both_mixes):
    _, _, m, plain, _, _, jm, jplain = both_mixes
    assert sorted(plain) == sorted(m) and sorted(jplain) == sorted(jm)
    assert m == jm  # the same seeded messages


def test_each_verifier_accepts_the_other_transcript(both_mixes):
    from vmn_tpu.protocol.mixnet.verifier import FiatShamirVerifier as JV

    params, nizkp, _, _, jparams, jnizkp, _, _ = both_mixes
    assert FiatShamirVerifier(params, nizkp).verify(
        expected_type="mixing").ok
    assert FiatShamirVerifier(params, jnizkp).verify(
        expected_type="mixing").ok
    assert JV(jparams, nizkp).verify(expected_type="mixing").ok


def test_permutation_from_the_shared_host_stream(both_mixes):
    """Plaintexts.bt is byte-equal: the permutation is drawn from the
    host stream, which both sources share byte for byte; the keys and
    the proofs, drawn from the two PRFs, differ."""
    _, nizkp, _, _, _, jnizkp, _, _ = both_mixes
    assert ((nizkp / "Plaintexts.bt").read_bytes()
            == (jnizkp / "Plaintexts.bt").read_bytes())
    for rel in ("FullPublicKey.bt", "proofs/PoSCommitment01.bt",
                "proofs/PoSReply01.bt", "proofs/DecrFactReply01.bt"):
        assert (nizkp / rel).read_bytes() != (jnizkp / rel).read_bytes(), \
            rel


# ------------------------------------------------------------ devices


def test_cuda_draw_raises_here_and_computes_nothing_on_the_host(
        monkeypatch):
    """A draw for a modulus on a CUDA device runs the kernel or raises
    (here: no card); the plain version is never taken for it, and a
    device with no kernel raises."""
    ran = []
    monkeypatch.setattr(P, "chacha20_limbs_plain",
                        lambda *args, **kw: ran.append(args))
    src = DeviceSource(b"cuda")
    with pytest.raises(Exception):
        src.random_limbs(4, 100, torch.device("cuda"))
    monkeypatch.setattr(R, "_CHECKED", {"cuda"})  # past the F2 check
    with pytest.raises(Exception):
        src.random_limbs(4, 100, torch.device("cuda"))
    assert not ran
    with pytest.raises(ValueError, match="no kernel for meta"):
        P.chacha20_limbs(src.key, 0, 4, 100, device="meta")


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_card(cuda_device):
    """chacha20_limbs on the card against its plain version on the card,
    exact: the RFC block, odd and even Lt, row ranges from mid-block,
    and a launch counted a non-empty range."""
    assert R.limbs_bytes(P.chacha20_limbs(
        bytes(range(32)), 0x4A000000, 1, 512, device=cuda_device,
        counter=1, nonce0=0x09000000)) == RFC_BLOCK
    key = SHA256.hash(b"card")
    for n, bits in ((1000, 2148), (4099, 356), (77, 100), (5, 17)):
        for rows in (None, (1, n), (n // 3, n - 1), (n, n)):
            before = P.LAUNCHES["chacha20_limbs"]
            got = P.chacha20_limbs(key, 9, n, bits, rows, cuda_device)
            want = P.chacha20_limbs_plain(key, 9, n, bits, rows,
                                          cuda_device)
            assert torch.equal(got, want), (n, bits, rows)
            a, b = rows or (0, n)
            assert P.LAUNCHES["chacha20_limbs"] - before == int(b > a)

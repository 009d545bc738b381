"""The port's signed HTTP bulletin board (`vmn_tpu_torch.protocol.com.http`)
and Schnorr signatures against `vmn_tpu`'s, on the CPU: port copies of
tests/test_board_http.py, signatures byte-equal from the same seeded
source and verified across the packages, and a k=3, t=2 test256 mix over
the port's HTTP board (three parties in threads of this process) whose
transcript both packages' `vmnv` accept.

Everything compared is bytes, so every tolerance here is exact equality.
"""

import contextlib
import io
import threading
import time

import pytest

from torch_port_util import run_parties
from vmn_tpu_torch.crypto.randomsource import SeededSource
from vmn_tpu_torch.crypto.signature import SignatureKeyPair, SignaturePKey
from vmn_tpu_torch.protocol.com.board import BoardError, LocalBoardHub
from vmn_tpu_torch.protocol.com.http import HTTPBulletinBoard, _Store
from vmn_tpu_torch.protocol.info import PartyInfo, PrivateInfo, ProtocolInfo


def _free_ports(n):
    import socket

    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _prot(keys, k, **kw):
    """Protocol info of k parties on free localhost ports."""
    ports = _free_ports(2 * k)
    return ProtocolInfo(nopart=k, **kw, parties=[
        PartyInfo(
            name=f"Party{j:02d}",
            pkey=keys[j].public.to_hex(),
            http=f"http://127.0.0.1:{ports[2 * (j - 1)]}",
            hint=f"127.0.0.1:{ports[2 * (j - 1) + 1]}",
        )
        for j in range(1, k + 1)
    ])


# ------------------------------------- port copies of test_board_http.py


def test_signature_roundtrip():
    rs = SeededSource(b"sig-test")
    kp = SignatureKeyPair.generate(rs, "test256")
    sig = kp.sign(b"hello", rs)
    assert kp.public.verify(b"hello", sig)
    assert not kp.public.verify(b"hellO", sig)
    bad = bytearray(sig)
    bad[-1] ^= 1
    assert not kp.public.verify(b"hello", bytes(bad))
    kp2 = SignatureKeyPair.from_hex(kp.to_hex())
    assert kp2.public.verify(b"hello", kp.sign(b"hello", rs))


def test_http_board(tmp_path):
    k = 3
    rs = SeededSource(b"board-test")
    keys = [None] + [
        SignatureKeyPair.generate(rs, "test256") for _ in range(k)
    ]
    prot = _prot(keys, k)
    privs = [None] + [
        PrivateInfo(name=f"P{j}", skey=keys[j].to_hex(),
                    dir=str(tmp_path / f"p{j}"))
        for j in range(1, k + 1)
    ]
    boards = [None] + [
        HTTPBulletinBoard(prot, privs[j], j) for j in range(1, k + 1)
    ]
    try:
        boards[1].publish("Hello", b"from-1")
        assert boards[2].wait_for(1, "Hello") == b"from-1"
        assert boards[3].wait_for(1, "Hello") == b"from-1"

        s2 = boards[2].scope("sess")
        s2.publish("Hello", b"scoped-2")
        assert boards[1].scope("sess").wait_for(2, "Hello") == b"scoped-2"

        result = {}

        def waiter():
            result["v"] = boards[3].wait_for(2, "Late")

        t = threading.Thread(target=waiter)
        t.start()
        boards[2].publish("Late", b"late-msg")
        t.join(timeout=30)
        assert result.get("v") == b"late-msg"

        from vmn_tpu_torch.eio.bytetree import leaf, node

        fake = node(leaf(b"evil"), leaf(b"\x00" * 288)).to_bytes()
        boards[1]._store.put("Forged", fake)
        with pytest.raises(BoardError):
            boards[2].wait_for(1, "Forged")

        assert boards[1].sent_bytes > 0
        assert boards[2].received_bytes > 0
        # the port's own accounting: signing and verifying seconds
        assert boards[1].sign_time > 0 and boards[2].verify_time > 0
    finally:
        for j in range(1, k + 1):
            boards[j].shutdown()


def test_board_persists_across_restart(tmp_path):
    """The disk-backed store re-serves published messages after a
    restart; an identical re-publish is a no-op, a changed one refused."""
    rs = SeededSource(b"persist-test")
    kp = SignatureKeyPair.generate(rs, "test256")
    priv = PrivateInfo(name="P1", skey=kp.to_hex(),
                       dir=str(tmp_path / "p1"))
    b1 = HTTPBulletinBoard(_prot([None, kp], 1), priv, 1)
    try:
        b1.publish("Durable", b"payload-1")
        b1.publish("Durable", b"payload-1")
        with pytest.raises(BoardError):
            b1.publish("Durable", b"payload-CHANGED")
    finally:
        b1.shutdown()
    b2 = HTTPBulletinBoard(_prot([None, kp], 1), priv, 1)
    try:
        assert b2.wait_for(1, "Durable") == b"payload-1"
    finally:
        b2.shutdown()


def test_store_scope_pruning(tmp_path):
    """`vmn -delete` prunes a session's spool, durably; other scopes
    stay."""
    st = _Store(tmp_path / "spool")
    st.put("session.aux/shuffle/Ciphertext1", b"a" * 10)
    st.put("session.other/shuffle/Ciphertext1", b"b" * 10)
    st.put("toplevel", b"c")
    st.delete_scope("session.aux")
    assert st.get("session.aux/shuffle/Ciphertext1") is None
    assert st.get("session.other/shuffle/Ciphertext1") == b"b" * 10
    assert st.get("toplevel") == b"c"
    st2 = _Store(tmp_path / "spool")
    assert st2.get("session.aux/shuffle/Ciphertext1") is None
    assert st2.get("session.other/shuffle/Ciphertext1") == b"b" * 10


def test_local_board_scope_pruning():
    hub = LocalBoardHub(2)
    b1 = hub.board(1)
    b1.scope("session.aux").publish("X", b"1")
    b1.scope("session.keep").publish("X", b"2")
    b1.delete_scope("session.aux")
    assert (1, "session.keep/X") in hub._messages
    assert (1, "session.aux/X") not in hub._messages


def test_closing_round_serves_until_peers_have_read(tmp_path):
    """Fault F11: vmn_tpu's board stops serving when its party's work
    ends, so a peer that has not yet fetched the last message waits in
    vain; the port's `close` keeps serving until every peer has read."""
    from vmn_tpu.crypto.signature import SignatureKeyPair as JPair
    from vmn_tpu.protocol.com.board import BoardError as JBoardError
    from vmn_tpu.protocol.com.http import HTTPBulletinBoard as JBoard
    from vmn_tpu.protocol.info import PartyInfo as JParty
    from vmn_tpu.protocol.info import PrivateInfo as JPriv
    from vmn_tpu.protocol.info import ProtocolInfo as JProt

    rs = SeededSource(b"close-test")
    keys = [None] + [SignatureKeyPair.generate(rs, "test256")
                     for _ in range(2)]
    prot = _prot(keys, 2)
    boards = {j: HTTPBulletinBoard(prot, PrivateInfo(
        name=f"P{j}", skey=keys[j].to_hex(), dir=str(tmp_path / f"p{j}")),
        j) for j in (1, 2)}
    try:
        boards[1].publish("Last", b"x")
        closing = threading.Thread(target=boards[1].close, args=("op",))
        closing.start()
        closing.join(timeout=1.0)
        assert closing.is_alive()  # party 2 has not read "Last" yet
        assert boards[2].wait_for(1, "Last") == b"x"
        boards[2].close("op")
        closing.join(timeout=30)
        assert not closing.is_alive()
    finally:
        for b in boards.values():
            b.shutdown()

    jkeys = [None] + [JPair.from_hex(keys[j].to_hex()) for j in (1, 2)]
    jprot = JProt(nopart=2, parties=[
        JParty(name=p.name, pkey=p.pkey, http=p.http, hint=p.hint)
        for p in _prot(keys, 2).parties])
    jb = {j: JBoard(jprot, JPriv(name=f"P{j}", skey=jkeys[j].to_hex(),
                                 dir=str(tmp_path / f"j{j}")), j)
          for j in (1, 2)}
    try:
        jb[1].publish("Last", b"x")
        jb[1].shutdown()  # vmn_tpu's vmn ends here
        jb[2].TIMEOUT = 1.0
        with pytest.raises(JBoardError):
            jb[2].wait_for(1, "Last")
    finally:
        jb[2].shutdown()


def _two_boards(tmp_path, keys, prot, tag=""):
    return {j: HTTPBulletinBoard(prot, PrivateInfo(
        name=f"P{j}", skey=keys[j].to_hex(),
        dir=str(tmp_path / f"p{j}{tag}")), j) for j in (1, 2)}


def test_closing_round_of_a_rerun_waits_for_the_slow_party(tmp_path):
    """An operation run to its end, its session deleted, then run again
    by new processes (boards on the same ports and spools): the fast
    party's closing round does not take the slow party's `Done` of the
    first run, and keeps serving until the slow party has read."""
    rs = SeededSource(b"rerun-test")
    keys = [None] + [SignatureKeyPair.generate(rs, "test256")
                     for _ in range(2)]
    prot = _prot(keys, 2)
    boards = _two_boards(tmp_path, keys, prot)
    try:
        for j in (1, 2):
            boards[j].scope("session.x").publish("Last", b"run-1")
        run_parties(2, lambda j: boards[j].close("mixing.x"))
        for j in (1, 2):
            boards[j].delete_scope("session.x")
    finally:
        for b in boards.values():
            b.shutdown()
    boards = _two_boards(tmp_path, keys, prot)
    try:
        boards[1].scope("session.x").publish("Last", b"run-2")
        closing = threading.Thread(target=boards[1].close,
                                   args=("mixing.x",))
        closing.start()
        closing.join(timeout=1.0)
        assert closing.is_alive()  # party 2 has not read "Last" yet
        assert boards[2].scope("session.x").wait_for(1, "Last") == b"run-2"
        boards[2].close("mixing.x")
        closing.join(timeout=30)
        assert not closing.is_alive()
    finally:
        for b in boards.values():
            b.shutdown()


def test_closing_round_ends_when_the_peer_has_moved_on(tmp_path):
    """A peer that left the closing round and whose next process already
    serves its port (without the closing messages, which live in memory
    only) counts as gone: the waiting party leaves at once instead of
    waiting for the timeout."""
    rs = SeededSource(b"moved-on-test")
    keys = [None] + [SignatureKeyPair.generate(rs, "test256")
                     for _ in range(2)]
    boards = _two_boards(tmp_path, keys, _prot(keys, 2))
    try:
        boards[1].TIMEOUT = 20.0
        mine = boards[2].scope("close.op")
        mine.publish("Done", b"", spool=False)
        closing = threading.Thread(target=boards[1].close, args=("op",))
        closing.start()
        assert mine.wait_for(1, "Exit") == b""  # party 1 is in round 2
        # party 2 leaves without its Exit, and its next process serves
        # the same port with the same spool
        boards[2]._store._data.clear()
        t0 = time.monotonic()
        closing.join(timeout=30)
        assert not closing.is_alive()
        assert time.monotonic() - t0 < 10.0
    finally:
        for b in boards.values():
            b.shutdown()


def test_cli_mix_with_an_inactive_party(tmp_path, monkeypatch):
    """k=3, t=2 through the port's `vmn` (parties in threads, each with
    its own HTTP and hint ports): all three generate the key, party 3
    is then deactivated (`-sact 1,2`) and never started again; both
    `vmn -mix` return 0 well inside the board timeout, their plaintexts
    agree and both packages' vmnv accept party 1's transcript."""
    from vmn_tpu.cli import vmnv as j_vmnv
    from vmn_tpu_torch.cli import vmn, vmnd, vmni, vmnv

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("VMN_BOARD_TIMEOUT", "60")
    assert vmni.main(["-prot", "-sid", "Inactive", "-nopart", "3",
                      "-thres", "2", "-pgroup", "named:test256",
                      "-stub", "stub.xml"], device="cpu") == 0
    ports = _free_ports(6)
    for j in (1, 2, 3):
        assert vmni.main([
            "-party", "-name", f"Party{j:02d}", "-stub", "stub.xml",
            "-dir", str(tmp_path / f"p{j}"), "-seed", "",
            "-http", f"http://127.0.0.1:{ports[2 * j - 2]}",
            "-hint", f"127.0.0.1:{ports[2 * j - 1]}",
            "-out", f"local{j}.xml"], device="cpu") == 0
        (tmp_path / "privInfo.xml").rename(tmp_path / f"priv{j}.xml")
    assert vmni.main(["-merge", "local1.xml", "local2.xml", "local3.xml",
                      "-out", "protInfo.xml"], device="cpu") == 0

    def vmn_of(j, *argv):
        return vmn.main([argv[0], f"priv{j}.xml", "protInfo.xml",
                         *argv[1:], "-s"], device="cpu")

    assert run_parties(3, lambda j: vmn_of(j, "-keygen", f"pk{j}.bt"))[1:] \
        == [0, 0, 0]
    assert vmnd.main(["-ciphs", "pk1.bt", "ciphertexts.bt", "-N", "5",
                      "-pgroup", "named:test256"], device="cpu") == 0
    for j in (1, 2):
        assert vmn.main(["-sact", "1,2", f"priv{j}.xml", "protInfo.xml"],
                        device="cpu") == 0
    t0 = time.monotonic()
    assert run_parties(2, lambda j: vmn_of(
        j, "-mix", "ciphertexts.bt", f"plain{j}.bt"))[1:] == [0, 0]
    assert time.monotonic() - t0 < 45.0
    assert ((tmp_path / "plain1.bt").read_bytes()
            == (tmp_path / "plain2.bt").read_bytes())
    argv = ["protInfo.xml", str(tmp_path / "p1" / "nizkp.default"), "-mix"]
    for main in (lambda a: vmnv.main(a, device="cpu"), j_vmnv.main):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(argv) == 0
        assert out.getvalue().rstrip().endswith("Proof is valid.")


# ------------------------------------------------------ against vmn_tpu


@pytest.mark.parametrize("group", ["test256", "modp2048"])
def test_signatures_equal_vmn_tpu(group):
    """Same seeded source: the same keys and signature bytes; each
    package verifies the other's signatures and rejects a flipped one."""
    from vmn_tpu.crypto.randomsource import SeededSource as JSource
    from vmn_tpu.crypto.signature import SignatureKeyPair as JPair
    from vmn_tpu.crypto.signature import SignaturePKey as JPKey

    tr, jr = SeededSource(b"sig-eq"), JSource(b"sig-eq")
    tk, jk = SignatureKeyPair.generate(tr, group), JPair.generate(jr, group)
    assert tk.to_hex() == jk.to_hex()
    assert tk.public.to_hex() == jk.public.to_hex()
    for msg in (b"", b"hello", bytes(range(256)) * 3):
        ts, js = tk.sign(msg, tr), jk.sign(msg, jr)
        assert ts == js
        assert JPKey.from_hex(tk.public.to_hex()).verify(msg, ts)
        assert SignaturePKey.from_hex(jk.public.to_hex()).verify(msg, js)
        bad = bytes([ts[0] ^ 1]) + ts[1:]
        assert not JPKey.from_hex(tk.public.to_hex()).verify(msg, bad)
        assert not SignaturePKey.from_hex(jk.public.to_hex()).verify(
            msg, bad)
    assert SignatureKeyPair.from_hex(jk.to_hex()).sign(
        b"m", SeededSource(b"k")) == jk.sign(b"m", JSource(b"k"))


def test_k3_mix_over_http_board_verified_by_both(tmp_path):
    """k=3, t=2 at test256: three parties (threads) keygen and mix over
    the port's signed HTTP board; the parties agree, the plaintexts are
    the messages, and both packages' vmnv accept party 1's transcript."""
    from vmn_tpu.cli import vmnv as j_vmnv
    from vmn_tpu_torch.cli import vmnv
    from vmn_tpu_torch.protocol import elgamal
    from vmn_tpu_torch.protocol.mixnet.party import MixNetParty

    k, n = 3, 6
    keys = [None] + [
        SignatureKeyPair.generate(SeededSource(f"sig-{j}".encode()),
                                  "test256")
        for j in range(1, k + 1)
    ]
    prot = _prot(keys, k, sid="HttpK3", thres=2, pgroup="named:test256")
    prot.write(tmp_path / "protInfo.xml")
    params = prot.to_params("cpu")
    boards = {
        j: HTTPBulletinBoard(prot, PrivateInfo(
            name=f"Party{j:02d}", skey=keys[j].to_hex(),
            dir=str(tmp_path / f"Party{j:02d}")), j)
        for j in range(1, k + 1)
    }
    try:
        parties = {
            j: MixNetParty(params, boards[j],
                           SeededSource(f"party-{j}".encode()),
                           str(tmp_path / f"Party{j:02d}"))
            for j in range(1, k + 1)
        }
        pks = run_parties(k, lambda j: parties[j].keygen())
        assert all(pks[j].to_bytetree().to_bytes()
                   == pks[1].to_bytetree().to_bytes() for j in (2, 3))
        group = params.pgroup
        m = group.encode_messages([b"m%d" % i for i in range(n)])
        r = group.ring.random((n,), SeededSource(b"enc"), 0)
        ciphs = elgamal.encrypt(pks[1], m, r)
        outs = run_parties(
            k, lambda j: parties[j].session("http", 1).mix(ciphs))
        assert sorted(outs[1].to_ints()) == sorted(m.to_ints())
        assert all(outs[j].equals(outs[1]) for j in (2, 3))
        assert all(boards[j].sign_time > 0 and boards[j].verify_time > 0
                   for j in boards)
        run_parties(k, lambda j: boards[j].close("mix"))
    finally:
        for b in boards.values():
            b.shutdown()
    nizkp = str(tmp_path / "Party01" / "nizkp.http")
    argv = [str(tmp_path / "protInfo.xml"), nizkp, "-mix"]
    for main in (lambda a: vmnv.main(a, device="cpu"), j_vmnv.main):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(argv) == 0
        assert out.getvalue().rstrip().endswith("Proof is valid.")

"""The port's multi-party modules against `vmn_tpu` on the CPU: Naor–Yung
encryption, the plain-key exchange, Shamir and Pedersen recovery, joint
coin flipping, the external-key mode and the interactive parameters.

Every input is made from a seed (`SeededSource`, or numpy for ring
elements) and handed to both packages.  Everything compared is integer
arithmetic or bytes, so every tolerance in these tests is exact equality.
"""

import numpy as np
import pytest

import torch_port_util  # noqa: F401 (torch thread count)
from torch_port_util import TEST256_P, rand_ints, run_parties
from vmn_tpu_torch.arith.pgroup import ModPGroup, PPGroup
from vmn_tpu_torch.crypto.naor_yung import (
    NaorYungError,
    NaorYungKeyPair,
    NaorYungPKey,
)
from vmn_tpu_torch.crypto.randomsource import SeededSource
from vmn_tpu_torch.eio.bytetree import ByteTree, node
from vmn_tpu_torch.protocol.com.board import LocalBoardHub
from vmn_tpu_torch.protocol.context import ProtocolContext, ProtocolParams

K, T = 3, 2
Q = (TEST256_P - 1) // 2
SEEDS = [f"mp-party{j}".encode() for j in range(1, K + 1)]


def _group():
    return ModPGroup.named("test256", device="cpu")


def _ctx(sid="MP", k=K, t=T):
    return ProtocolContext(ProtocolParams(sid=sid, k=k, threshold=t,
                                          pgroup=_group()))


def _j_ctx(sid="MP", k=K, t=T):
    from vmn_tpu.arith.pgroup import ModPGroup as JG
    from vmn_tpu.protocol.context import ProtocolContext as JCtx
    from vmn_tpu.protocol.context import ProtocolParams as JParams

    return JCtx(JParams(sid=sid, k=k, threshold=t,
                        pgroup=JG.named("test256")))


def _parties(hub, source, fn):
    """fn(j, board, source(SEEDS[j-1])) in one thread a party, over `hub`
    (either package's LocalBoardHub); 1-based results."""
    return run_parties(K, lambda j: fn(j, hub.board(j), source(SEEDS[j - 1])))


# ------------------------------------------------------------ Naor–Yung


def test_naor_yung_matches_vmn_tpu_and_round_trips():
    from vmn_tpu.arith.pgroup import ModPGroup as JG
    from vmn_tpu.crypto.naor_yung import NaorYungKeyPair as JKeyPair
    from vmn_tpu.crypto.randomsource import SeededSource as JSeeded

    kp = NaorYungKeyPair.generate(SeededSource(b"ny-key"), _group())
    jkp = JKeyPair.generate(JSeeded(b"ny-key"), JG.named("test256"))
    assert kp.z == jkp.z
    assert kp.pkey.to_bytetree().to_bytes() == \
        jkp.pkey.to_bytetree().to_bytes()
    # two chunks of the 28-byte test256 encoding, and the empty message
    for msg in (bytes(range(40)), b""):
        blob = kp.pkey.encrypt(msg, SeededSource(b"ny-enc"))
        assert blob == jkp.pkey.encrypt(msg, JSeeded(b"ny-enc"))
        assert kp.decrypt(blob) == msg
        assert jkp.decrypt(blob) == msg
    # a key read back from its byte tree encrypts to the same bytes
    pk2 = NaorYungPKey.from_bytetree(kp.pkey.to_bytetree(), device="cpu")
    assert pk2.encrypt(b"share", SeededSource(b"e")) == \
        kp.pkey.encrypt(b"share", SeededSource(b"e"))


def test_naor_yung_rejects_a_tampered_ciphertext():
    kp = NaorYungKeyPair.generate(SeededSource(b"ny-key"), _group())
    blob = kp.pkey.encrypt(b"secret share bytes", SeededSource(b"ny-enc"))
    chunk = ByteTree.from_bytes(blob)[0]
    # e (the masked message) with one bit flipped: the proof fails
    e = chunk[2].to_int_signed() ^ 1
    from vmn_tpu_torch.eio.bytetree import signed_int_leaf

    bad = node(node(chunk[0], chunk[1], signed_int_leaf(e), chunk[3],
                    chunk[4])).to_bytes()
    with pytest.raises(NaorYungError, match="proof"):
        kp.decrypt(bad)
    with pytest.raises(NaorYungError):
        kp.decrypt(blob[:-3])
    with pytest.raises(NaorYungError):
        kp.decrypt(node(node(chunk[0])).to_bytes())


def test_plainkeys_exchange_matches_vmn_tpu():
    """run_plainkeys at k=3: the keys every party collects, in bytes, are
    vmn_tpu's; a share encrypted by one party decrypts at another."""
    from vmn_tpu.crypto.randomsource import SeededSource as JSeeded
    from vmn_tpu.protocol.com.board import LocalBoardHub as JHub
    from vmn_tpu.protocol.distr.plainkeys import run_plainkeys as j_run
    from vmn_tpu_torch.protocol.distr.plainkeys import run_plainkeys

    ctx, jctx = _ctx(), _j_ctx()

    def port(j, board, rs):
        res = run_plainkeys(ctx, board, rs)
        blob = res.cipher(rs).encrypt(j % K + 1, b"share of %d" % j)
        return res, blob

    def ref(j, board, rs):
        return j_run(jctx, board, rs)

    got = _parties(LocalBoardHub(K), SeededSource, port)
    want = _parties(JHub(K), JSeeded, ref)
    for j in range(1, K + 1):
        res, _ = got[j]
        for l in range(1, K + 1):
            assert res.pkeys[l].to_bytetree().to_bytes() == \
                want[j].pkeys[l].to_bytetree().to_bytes()
        # party j's share for party j % K + 1 opens there
        _, blob = got[j]
        to = j % K + 1
        assert got[to][0].cipher(None).decrypt(blob) == b"share of %d" % j
        with pytest.raises(ValueError, match="undecryptable"):
            got[to][0].cipher(None).decrypt(
                blob[:-1] + bytes([blob[-1] ^ 1]))


def test_plainkeys_group_follows_the_protocol_group():
    from vmn_tpu_torch.arith.ec import ECqPGroup
    from vmn_tpu_torch.protocol.distr.plainkeys import default_group

    grp = _group()
    assert default_group(grp) is grp
    assert default_group(PPGroup(grp, 2)) is grp
    under_ec = default_group(ECqPGroup.named("P-256", device="cpu"))
    assert under_ec.nbits == 2048 and under_ec.device.type == "cpu"


# ------------------------------------------------- Shamir and Pedersen


def test_shamir_recover_matches_vmn_tpu():
    from vmn_tpu.arith.pgroup import PField as JField
    from vmn_tpu.arith.pgroup import PPRing as JPPRing
    from vmn_tpu.protocol.secretsharing import shamir as J
    from vmn_tpu_torch.arith.pgroup import PField, PPRing
    from vmn_tpu_torch.protocol.secretsharing import shamir as S

    rng = np.random.default_rng(7)
    assert S.lagrange_at_zero(Q, [1, 3]) == J.lagrange_at_zero(Q, [1, 3])
    field, jfield = PField(Q, device="cpu"), JField(Q)
    # P(x) = a + b x at x = 1..3; any two shares give a
    a, b = rand_ints(rng, 2, Q)
    vals = {i: (a + b * i) % Q for i in range(1, K + 1)}
    for idxs in ([1, 2], [1, 3], [2, 3], [1, 2, 3]):
        shares = {i: field.from_int(vals[i]) for i in idxs}
        jshares = {i: jfield.from_int(vals[i]) for i in idxs}
        got = S.shamir_recover(field, shares, T).to_int()
        assert got == J.shamir_recover(jfield, jshares, T).to_int() == a
    # product ring (width 2): componentwise
    ring, jring = PPRing(field, 2), JPPRing(jfield, 2)
    c = rand_ints(rng, 1, Q)[0]
    pairs = {i: ring.product(field.from_int(vals[i]),
                             field.from_int((c + 5 * i) % Q))
             for i in (2, 3)}
    jpairs = {i: jring.product(jfield.from_int(vals[i]),
                               jfield.from_int((c + 5 * i) % Q))
              for i in (2, 3)}
    got = S.shamir_recover(ring, pairs, T)
    want = J.shamir_recover(jring, jpairs, T)
    assert [x.to_int() for x in got.components] == \
        [x.to_int() for x in want.components] == [a, c]
    with pytest.raises(ValueError, match="too few"):
        S.shamir_recover(field, {1: field.from_int(1)}, T)


def test_recover_secret_matches_vmn_tpu():
    """Pedersen VSS dealt by party 1 at k=3, t=2, then recovered in the
    open: every party gets vmn_tpu's secret, whose power is the dealt
    constant."""
    from vmn_tpu.crypto.randomsource import SeededSource as JSeeded
    from vmn_tpu.protocol.com.board import LocalBoardHub as JHub
    from vmn_tpu.protocol.secretsharing.pedersen import (
        recover_secret as j_recover,
        run_pedersen as j_run,
    )
    from vmn_tpu_torch.protocol.secretsharing.pedersen import (
        recover_secret,
        run_pedersen,
    )

    ctx, jctx = _ctx(), _j_ctx()

    def port(j, board, rs):
        res = run_pedersen(ctx, board, rs, dealer=1)
        return (res.share.to_int(), res.constant_in_exp.to_ints()[0],
                recover_secret(ctx, board, res).to_int())

    def ref(j, board, rs):
        res = j_run(jctx, board, rs, dealer=1)
        return (res.share.to_int(), res.constant_in_exp.to_ints()[0],
                j_recover(jctx, board, res).to_int())

    got = _parties(LocalBoardHub(K), SeededSource, port)
    assert got == _parties(JHub(K), JSeeded, ref)
    share, const, secret = got[1]
    assert len({r[2] for r in got[1:]}) == 1
    assert pow(4, secret, TEST256_P) == const


# --------------------------------------------------------- coin flipping


def test_coinflip_k3_matches_vmn_tpu():
    """The first 64 coin bytes at k=3, t=2 over LocalBoardHub: every party
    agrees, and they are vmn_tpu's from the same seeds; the generators
    flipped from the next coins agree too."""
    from vmn_tpu.protocol.coinflip import CoinFlipPRingSource as JSource
    from vmn_tpu.crypto.randomsource import SeededSource as JSeeded
    from vmn_tpu.protocol.com.board import LocalBoardHub as JHub
    from vmn_tpu.protocol.distr.indgen import (
        independent_generators_i as j_gens,
    )
    from vmn_tpu_torch.protocol.coinflip import CoinFlipPRingSource
    from vmn_tpu_torch.protocol.distr.indgen import independent_generators_i

    ctx, jctx = _ctx(), _j_ctx()

    def port(j, board, rs):
        src = CoinFlipPRingSource(ctx, board.scope("coins"), rs)
        return (src.coin_bytes(64),
                independent_generators_i(ctx, src, 3).to_ints())

    def ref(j, board, rs):
        src = JSource(jctx, board.scope("coins"), rs)
        return src.coin_bytes(64), j_gens(jctx, src, 3).to_ints()

    got = _parties(LocalBoardHub(K), SeededSource, port)
    assert len({(c, tuple(g)) for c, g in got[1:]}) == 1
    assert got == _parties(JHub(K), JSeeded, ref)
    assert len(got[1][0]) == 64


def test_coinflip_per_coin_dealing_matches_vmn_tpu():
    """The per-coin path (one Pedersen instance of the pair homomorphism
    a coin, for groups whose commitments do not stack, as EC groups),
    forced on test256: the same coins as vmn_tpu's same path."""
    from vmn_tpu.crypto.randomsource import SeededSource as JSeeded
    from vmn_tpu.protocol.coinflip import CoinFlipPRingSource as JSource
    from vmn_tpu.protocol.com.board import LocalBoardHub as JHub
    from vmn_tpu_torch.protocol.coinflip import CoinFlipPRingSource

    ctx, jctx = _ctx(), _j_ctx()

    def flip(source_class, c):
        def party(j, board, rs):
            src = source_class(c, board.scope("coins"), rs)
            src._batched = False
            return src.coin_bytes(16)  # one coin
        return party

    got = _parties(LocalBoardHub(K), SeededSource, flip(CoinFlipPRingSource,
                                                        ctx))
    assert len(set(got[1:])) == 1
    assert got == _parties(JHub(K), JSeeded, flip(JSource, jctx))


def test_interactive_parameters_take_the_interactive_bit_lengths():
    par = ProtocolParams(sid="I", k=K, threshold=T, pgroup=_group(),
                         noninteractive=False, vbitlen=120, ebitlen=110)
    ctx = ProtocolContext(par)
    assert (ctx.vbitlen, ctx.ebitlen) == (120, 110)
    fs = ProtocolContext(ProtocolParams(sid="I", pgroup=_group()))
    assert (fs.vbitlen, fs.ebitlen) == (256, 256)
    # the global prefix hashes the RO lengths in both modes
    assert ctx.global_prefix == fs.global_prefix


# -------------------------------------------------------- external key


def test_external_key_mode_reloads_and_refuses_decryption(tmp_path):
    from vmn_tpu_torch.protocol import elgamal
    from vmn_tpu_torch.protocol.mixnet.party import MixNetParty, ProtocolError

    grp = _group()
    par = ProtocolParams(sid="Ext", k=1, threshold=1, pgroup=grp)
    y = grp.g.exp(grp.ring.from_int(123456789))
    pk = elgamal.ElGamalPublicKey(grp.g, y)
    p = MixNetParty(par, LocalBoardHub(1).board(1), SeededSource(b"x"),
                    str(tmp_path))
    p.set_public_key(pk)
    assert p.dkg is None
    assert p.full_public_key().to_bytetree().to_bytes() == \
        pk.to_bytetree().to_bytes()
    # a restarted party reads the key back from its state directory
    q = MixNetParty(par, LocalBoardHub(1).board(1), SeededSource(b"y"),
                    str(tmp_path))
    assert q.load_keys()
    assert q.full_public_key().y.equals(y)
    ciphs = elgamal.encrypt(pk, grp.from_ints([5, 7]),
                            grp.ring.from_ints([1, 2]))
    with pytest.raises(ProtocolError, match="externally set"):
        q.session("ext", 1).decrypt(ciphs)

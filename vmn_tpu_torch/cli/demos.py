"""Port of `vmn_tpu.cli.demos`: the same demos over test256, their
parties' arrays on `device`.

Per-protocol demo runners (reference: the 12 DEMO_CLASSNAMES run by
`make rundemos` in dependency order — Makefile.am:83-95, each demo
executing one protocol among k simulated parties and asserting
cross-party postconditions, e.g. DemoPedersen, DemoDKG,
DemoMixNetElGamal.java:80-150).

Each runner executes its protocol among k in-process parties over the
local board and raises on postcondition failure.  Dispatched by
`vdemo -protocol NAME`; NAME=all runs the full dependency-ordered
suite.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List

from vmn_tpu_torch.arith.pgroup import ModPGroup, Permutation
from vmn_tpu_torch.crypto.randomsource import SeededSource
from vmn_tpu_torch.protocol import elgamal
from vmn_tpu_torch.protocol.com.board import LocalBoardHub
from vmn_tpu_torch.protocol.context import ProtocolContext, ProtocolParams


def _params(k, t, device):
    return ProtocolParams(
        sid="Demo", k=k, threshold=t,
        pgroup=ModPGroup.named("test256", device),
    )


def _run_parties(k: int, fn):
    hub = LocalBoardHub(k)
    results = [None] * (k + 1)
    errors: List[str] = []

    def run(j):
        try:
            results[j] = fn(j, hub.board(j),
                            SeededSource(f"demo{j}".encode()))
        except Exception:  # noqa: BLE001
            import traceback

            errors.append(traceback.format_exc())

    threads = [
        threading.Thread(target=run, args=(j,), daemon=True)
        for j in range(1, k + 1)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors:
        raise AssertionError(errors[0])
    return results


def _agree(results):
    vals = {repr(r) for r in results[1:]}
    assert len(vals) == 1, "parties disagree"


# ------------------------------------------------------------- demos


def demo_plainkeys(k, t, device):
    ctx = ProtocolContext(_params(k, t, device))

    def party(j, board, rs):
        from vmn_tpu_torch.protocol.distr.plainkeys import run_plainkeys

        pk = run_plainkeys(ctx, board, rs)
        return sorted(pk.pkeys.keys())

    results = _run_parties(k, party)
    assert results[1] == list(range(1, k + 1))
    _agree(results)


def demo_pedersen(k, t, device):
    ctx = ProtocolContext(_params(k, t, device))

    def party(j, board, rs):
        from vmn_tpu_torch.protocol.secretsharing.pedersen import run_pedersen

        res = run_pedersen(ctx, board, rs, dealer=1)
        assert res.ok
        return res.poly_in_exp.to_ints()

    _agree(_run_parties(k, party))


def demo_pedersen_sequential(k, t, device):
    ctx = ProtocolContext(_params(k, t, device))

    def party(j, board, rs):
        from vmn_tpu_torch.protocol.secretsharing.pedersen import (
            run_pedersen_sequential,
        )

        seq = run_pedersen_sequential(
            ctx, board, rs, dealers=range(1, t + 1)
        )
        assert seq.qualified == list(range(1, t + 1))
        return seq.poly_in_exp.to_ints()

    _agree(_run_parties(k, party))


def demo_independent_generator(k, t, device):
    ctx = ProtocolContext(_params(k, t, device))

    def party(j, board, rs):
        from vmn_tpu_torch.protocol.distr.indgen import (
            run_independent_generator,
        )

        h, _ = run_independent_generator(ctx, board, rs)
        return h.to_ints()

    results = _run_parties(k, party)
    _agree(results)
    assert results[1][0] != ctx.pgroup.g_int


def demo_dkg(k, t, device):
    ctx = ProtocolContext(_params(k, t, device))

    def party(j, board, rs):
        from vmn_tpu_torch.protocol.distr.dkg import run_dkg

        res = run_dkg(ctx, board, rs, None)
        return res.joint_public_key.to_ints()

    _agree(_run_parties(k, party))


def demo_coinflip(k, t, device):
    ctx = ProtocolContext(_params(k, t, device))

    def party(j, board, rs):
        from vmn_tpu_torch.protocol.coinflip import CoinFlipPRingSource

        src = CoinFlipPRingSource(ctx, board.scope("coins"), rs)
        return src.coin_bytes(16)

    _agree(_run_parties(k, party))


def demo_independent_generators_i(k, t, device):
    ctx = ProtocolContext(_params(k, t, device))

    def party(j, board, rs):
        from vmn_tpu_torch.protocol.coinflip import CoinFlipPRingSource
        from vmn_tpu_torch.protocol.distr.indgen import (
            independent_generators_i,
        )

        src = CoinFlipPRingSource(ctx, board.scope("coins"), rs)
        gens = independent_generators_i(ctx, src, 5)
        assert gens.is_in_group()
        return gens.to_ints()

    _agree(_run_parties(k, party))


def demo_distr_elgamal(k, t, device):
    """Threshold keygen + distributed decryption round trip."""
    from vmn_tpu_torch.protocol.mixnet.party import MixNetParty

    import tempfile

    params = _params(k, t, device)
    group = params.pgroup
    with tempfile.TemporaryDirectory() as tmp:

        def party(j, board, rs):
            p = MixNetParty(params, board, rs, f"{tmp}/P{j}")
            pk = p.keygen()
            return p, pk

        results = _run_parties(k, party)
        pk = results[1][1]
        msgs = [group.encode_message(b"hello-%d" % i) for i in range(4)]
        m = group.from_ints(msgs)
        r = group.ring.random((4,), SeededSource(b"enc"), 0)
        ciphs = elgamal.encrypt(pk, m, r)

        hub = LocalBoardHub(k)
        outs = [None] * (k + 1)
        errs = []

        def dec(j):
            try:
                p = results[j][0]
                p.board = hub.board(j)
                outs[j] = p.session("dec", 1).decrypt(ciphs)
            except Exception:  # noqa: BLE001
                import traceback

                errs.append(traceback.format_exc())

        ths = [threading.Thread(target=dec, args=(j,), daemon=True)
               for j in range(1, k + 1)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=600)
        assert not errs, errs[0]
        assert sorted(outs[1].to_ints()) == sorted(msgs)


def demo_posctw(k, t, device):
    ctx = ProtocolContext(_params(k, t, device))
    n = 5

    def party(j, board, rs):
        from vmn_tpu_torch.arith.pgroup import Permutation
        from vmn_tpu_torch.protocol.hvzk.pos_tw import PoSParams
        from vmn_tpu_torch.protocol.hvzk.posc_multi import PoSCMulti
        from vmn_tpu_torch.eio.bytetree import ByteTree

        b = board.scope("posctw")
        gens = ctx.independent_generators("gens", n)
        g = ctx.pgroup.g
        field = ctx.pgroup.ring
        r = field.random((n,), rs, ctx.rbitlen)
        pi = Permutation.random(n, rs)
        u = gens.mul(g.exp(r)).permute(pi)
        b.publish(f"U{j}", u.to_bytetree().to_bytes())
        us = {}
        for l in range(1, k + 1):
            raw = (u.to_bytetree().to_bytes() if l == j
                   else b.wait_for(l, f"U{l}"))
            us[l] = ctx.pgroup.elem_from_bytetree(
                ByteTree.from_bytes(raw), n)
        par = PoSParams(ctx.vbitlen, ctx.ebitlen, ctx.rbitlen, ctx.prg)
        verdicts = PoSCMulti(ctx, b, rs, par).execute(g, gens, us, r, pi)
        assert all(verdicts.values())
        return sorted(verdicts)

    _agree(_run_parties(k, party))


def demo_permutation_commitment(k, t, device):
    """Precomputation phase alone: PoSC-backed commitments."""
    import tempfile

    from vmn_tpu_torch.protocol.mixnet.party import MixNetParty

    params = _params(k, t, device)
    with tempfile.TemporaryDirectory() as tmp:

        def party(j, board, rs):
            p = MixNetParty(params, board, rs, f"{tmp}/P{j}")
            p.keygen()
            return p

        results = _run_parties(k, party)
        hub = LocalBoardHub(k)
        errs = []

        def pre(j):
            try:
                p = results[j]
                p.board = hub.board(j)
                p.session("pc", 1).precomp(6)
            except Exception:  # noqa: BLE001
                import traceback

                errs.append(traceback.format_exc())

        ths = [threading.Thread(target=pre, args=(j,), daemon=True)
               for j in range(1, k + 1)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=600)
        assert not errs, errs[0]


def demo_shuffler(k, t, device):
    """Shuffle-only session (external public key mode postcondition:
    re-randomized permutation of the input)."""
    demo_mixnet(k, t, device, shuffle_only=True)


def demo_mixnet(k, t, device, shuffle_only: bool = False):
    import tempfile

    from vmn_tpu_torch.protocol.mixnet.party import MixNetParty

    params = _params(k, t, device)
    group = params.pgroup
    with tempfile.TemporaryDirectory() as tmp:

        def party(j, board, rs):
            p = MixNetParty(params, board, rs, f"{tmp}/P{j}")
            pk = p.keygen()
            return p, pk

        results = _run_parties(k, party)
        pk = results[1][1]
        msgs = [group.encode_message(b"m%d" % i) for i in range(5)]
        m = group.from_ints(msgs)
        r = group.ring.random((5,), SeededSource(b"enc"), 0)
        ciphs = elgamal.encrypt(pk, m, r)

        hub = LocalBoardHub(k)
        outs = [None] * (k + 1)
        errs = []

        def mix(j):
            try:
                p = results[j][0]
                p.board = hub.board(j)
                s = p.session("mx", 1)
                outs[j] = (
                    s.shuffle(ciphs) if shuffle_only else s.mix(ciphs)
                )
            except Exception:  # noqa: BLE001
                import traceback

                errs.append(traceback.format_exc())

        ths = [threading.Thread(target=mix, args=(j,), daemon=True)
               for j in range(1, k + 1)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=600)
        assert not errs, errs[0]
        if shuffle_only:
            # postcondition: all parties agree on the shuffled output
            # and it differs from the input (re-randomized)
            for j in range(2, k + 1):
                assert outs[j].equals(outs[1])
            assert not outs[1].equals(ciphs)
        else:
            assert sorted(outs[1].to_ints()) == sorted(msgs)


DEMOS: Dict[str, Callable] = {
    # reference dependency order (Makefile.am:83-95)
    "plainkeys": demo_plainkeys,
    "pedersen": demo_pedersen,
    "pedersensequential": demo_pedersen_sequential,
    "independentgenerator": demo_independent_generator,
    "dkg": demo_dkg,
    "distrelgamal": demo_distr_elgamal,
    "coinflip": demo_coinflip,
    "independentgeneratorsi": demo_independent_generators_i,
    "shuffler": demo_shuffler,
    "posctw": demo_posctw,
    "permutationcommitment": demo_permutation_commitment,
    "mixnet": demo_mixnet,
}


def run_demo(name: str, k: int = 3, t: int = 2, device="cuda") -> None:
    if name == "all":
        for nm, fn in DEMOS.items():
            print(f"demo {nm} ...", flush=True)
            fn(k, t, device)
            print(f"demo {nm} ok")
        return
    fn = DEMOS.get(name)
    if fn is None:
        raise SystemExit(
            f"unknown demo {name!r}; known: {', '.join(DEMOS)} or 'all'"
        )
    fn(k, t, device)
    print(f"demo {name} ok")

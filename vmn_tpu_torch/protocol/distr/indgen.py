"""Jointly generated independent generators (port of
`independent_generators_i` of `vmn_tpu.protocol.distr.indgen`; its
`run_independent_generator`, which no caller uses, stays out).

`independent_generators_i` makes an array of N generators from joint
coin flipping (reference: IndependentGeneratorsI.java:50 /
IndependentGeneratorsBasicI — the interactive counterpart of
IndependentGeneratorsRO, which lives in
ProtocolContext.independent_generators).
"""

from __future__ import annotations

from vmn_tpu_torch.crypto.prg import PRGHeuristic


def independent_generators_i(ctx, coinflip_source, n: int):
    """Array of N independent generators by joint coin flipping
    (reference: IndependentGeneratorsI.java:110-160 — flip a PRG seed,
    expand to group elements; unbiased if one party is honest)."""
    prg = PRGHeuristic(ctx.ro_hash)
    prg.set_seed(coinflip_source.coin_bytes(prg.min_seed_bytes))
    return ctx.pgroup.random_array(n, prg, ctx.rbitlen)

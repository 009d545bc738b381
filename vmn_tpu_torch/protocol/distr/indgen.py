"""Jointly generated independent generators (port of
`vmn_tpu.protocol.distr.indgen`).

* `run_independent_generator` — one generator h with no party knowing
  its discrete log (reference: IndependentGenerator.java:66 — each
  party contributes g^{e_l} and Pedersen-shares e_l for recoverability;
  h is the product of the qualified contributions).  Its caller is the
  `independentgenerator` demo (`cli.demos`).
* `independent_generators_i` makes an array of N generators from joint
  coin flipping (reference: IndependentGeneratorsI.java:50 /
IndependentGeneratorsBasicI — the interactive counterpart of
IndependentGeneratorsRO, which lives in
ProtocolContext.independent_generators).
"""

from __future__ import annotations

from vmn_tpu_torch.crypto.prg import PRGHeuristic
from vmn_tpu_torch.protocol.secretsharing.pedersen import (
    run_pedersen_sequential,
)


def run_independent_generator(ctx, board, randomsource, cipher=None):
    """Generate a single joint generator h = prod_l g^{e_l} via one VSS
    instance per party (reference: IndependentGenerator.java:66).

    Returns (h, SequentialResult) — the sequential sharing makes every
    contribution recoverable if its owner is later deactivated.
    """
    seq = run_pedersen_sequential(
        ctx,
        board.scope("indgen"),
        randomsource,
        dealers=range(1, board.k + 1),
        cipher=cipher,
    )
    # h = prod over qualified dealers of g^{e_l} = joint constant term
    return seq.poly_in_exp.get(0), seq


def independent_generators_i(ctx, coinflip_source, n: int):
    """Array of N independent generators by joint coin flipping
    (reference: IndependentGeneratorsI.java:110-160 — flip a PRG seed,
    expand to group elements; unbiased if one party is honest)."""
    prg = PRGHeuristic(ctx.ro_hash)
    prg.set_seed(coinflip_source.coin_bytes(prg.min_seed_bytes))
    return ctx.pgroup.random_array(n, prg, ctx.rbitlen)

"""Port of `vmn_tpu.protocol.hvzk.posc_multi`: one round of proofs of
shuffles of commitments over the bulletin board.

Rebuild of the reference `PoSCMulti` interface (reference:
hvzk/PoSCMulti.java:40: one round proving and verifying the permutation
commitments of all parties, returning an array of verdicts).

`execute` plays both roles: the calling party proves its own
commitment and verifies every other party's, as the per-party loop of
the precomputation phase does, behind one call with shared parameters.
"""

from __future__ import annotations

from typing import Dict

from vmn_tpu_torch.eio.bytetree import ByteTree, ByteTreeError
from vmn_tpu_torch.protocol.hvzk.posc_tw import (
    PoSCProver,
    PoSCVerifier,
    posc_challenge_data,
    posc_seed_data,
)


class PoSCMulti:
    """One round of PoSC proofs over the bulletin board."""

    def __init__(self, ctx, board, randomsource, pos_params):
        self.ctx = ctx
        self.board = board
        self.rs = randomsource
        self.par = pos_params

    def execute(
        self,
        g,
        generators,
        permutation_commitments: Dict[int, object],
        commitment_exponents=None,
        permutation=None,
    ) -> Dict[int, bool]:
        """Prove the own commitment, verify the others'.

        permutation_commitments: {party index l -> commitment array u_l}
        (own index included).  Returns {l: verdict}, the own entry True
        by construction (reference: boolean[] verdicts).
        """
        ctx = self.ctx
        b = self.board
        j = b.j
        verdicts: Dict[int, bool] = {}
        for l in sorted(permutation_commitments):
            u = permutation_commitments[l]
            seed_data = posc_seed_data(g, generators, u)
            if l == j:
                if commitment_exponents is None or permutation is None:
                    raise ValueError(
                        "own commitment requires exponents+permutation"
                    )
                P = PoSCProver(self.par, self.rs)
                P.set_instance(g, generators, u, commitment_exponents,
                               permutation)
                seed = ctx.challenger.challenge(
                    seed_data, 8 * ctx.prg.min_seed_bytes, ctx.rbitlen,
                )
                commitment = P.commit(seed)
                b.publish(f"MultiPoSCCommitment{l}", commitment.to_bytes())
                v_bytes = ctx.challenger.challenge(
                    posc_challenge_data(seed, commitment),
                    ctx.vbitlen, ctx.rbitlen,
                )
                reply = P.reply(int.from_bytes(v_bytes, "big"))
                b.publish(f"MultiPoSCReply{l}", reply.to_bytes())
                verdicts[l] = True
                continue
            V = PoSCVerifier(self.par)
            V.set_instance(g, generators, u)
            seed = ctx.challenger.challenge(
                seed_data, 8 * ctx.prg.min_seed_bytes, ctx.rbitlen,
            )
            V.set_batch_vector(seed)
            try:
                com_bt = ByteTree.from_bytes(
                    b.wait_for(l, f"MultiPoSCCommitment{l}")
                )
                commitment = V.set_commitment(com_bt)
                v_bytes = ctx.challenger.challenge(
                    posc_challenge_data(seed, commitment),
                    ctx.vbitlen, ctx.rbitlen,
                )
                reply_bt = ByteTree.from_bytes(
                    b.wait_for(l, f"MultiPoSCReply{l}")
                )
                verdicts[l] = V.verify(
                    reply_bt, int.from_bytes(v_bytes, "big")
                )
            except (ByteTreeError, ValueError):
                verdicts[l] = False
        return verdicts

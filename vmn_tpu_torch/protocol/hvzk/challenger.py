"""Port of `vmn_tpu.protocol.hvzk.challenger` (a host-only copy; byte-identical behaviour).

Challenge sources for the sigma protocols.

`ChallengerRO` is the non-interactive Fiat–Shamir challenger
(reference: ChallengerRO.java:96-116 — the challenge is
RO_{H,vbitlen}(globalPrefix || bytetree(data))).  The interactive variant
(`ChallengerI`, joint coin flipping) lives in
`vmn_tpu_torch.protocol.coinflip`.
"""

from __future__ import annotations

from vmn_tpu_torch.crypto.hash import Hashfunction
from vmn_tpu_torch.crypto.ro import RandomOracle
from vmn_tpu_torch.eio.bytetree import ByteTree


class ChallengerRO:
    """Random-oracle challenger with a global prefix."""

    def __init__(self, ro_hashfunction: Hashfunction, global_prefix: bytes):
        self.ro_hashfunction = ro_hashfunction
        self.global_prefix = bytes(global_prefix)

    def challenge(self, data: ByteTree, vbitlen: int, rbitlen: int = 0
                  ) -> bytes:
        """Derive `vbitlen` challenge bits.  `rbitlen` is unused by the RO
        challenger (it matters only for coin-flipping) but kept for
        interface parity (reference: Challenger.java:37)."""
        ro = RandomOracle(self.ro_hashfunction, vbitlen)
        d = ro.digest()
        d.update(self.global_prefix)
        d.update(data.to_bytes())
        return d.finalize()

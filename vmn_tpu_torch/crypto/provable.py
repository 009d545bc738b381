"""Port of the `SHA-*` resolvers of `vmn_tpu.crypto.provable`
(`resolve_hash`/`resolve_prg`, vmn_tpu/crypto/provable.py:306-341).

The provably secure Pedersen hash and El Gamal PRG of that module are
not ported yet (ROADMAP queue 1 item 6, the CLI); naming them raises.
"""

from __future__ import annotations

from vmn_tpu_torch.crypto.hash import Hashfunction
from vmn_tpu_torch.crypto.prg import PRGHeuristic


def resolve_hash(spec: str) -> Hashfunction:
    """Resolve a `rohash` info-field value ("SHA-256"/"SHA-384"/"SHA-512")."""
    if spec.startswith("SHA-"):
        return Hashfunction(spec)
    raise NotImplementedError(
        f"hash {spec!r}: only SHA-* is ported "
        "(Pedersen hash: ROADMAP queue 1 item 6)"
    )


def resolve_prg(spec: str) -> PRGHeuristic:
    """Resolve a `prg` info-field value ("SHA-*" -> PRGHeuristic)."""
    if spec.startswith("SHA-"):
        return PRGHeuristic(Hashfunction(spec))
    raise NotImplementedError(
        f"PRG {spec!r}: only SHA-* is ported "
        "(El Gamal PRG: ROADMAP queue 1 item 6)"
    )

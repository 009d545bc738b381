"""PlainKeys: CCA2 key establishment for point-to-point messages (port
of `vmn_tpu.protocol.distr.plainkeys`).

Rebuild of the reference PlainKeys protocol (reference:
PlainKeys.java:54 — each party generates a CCA2 keypair, publishes the
public key in the clear over the bulletin board, and collects everyone
else's; the resulting `pkeys[]`/`skey` protect secret shares inside
Pedersen VSS, Pedersen.java:355).

A party whose published key is malformed is marked; shares addressed to
it are sent in a deterministic garbage form (it cannot participate in
VSS anyway), mirroring the reference's deterministic-default handling.
"""

from __future__ import annotations

from typing import Dict, Optional

from vmn_tpu_torch.arith.pgroup import ModPGroup, PPGroup
from vmn_tpu_torch.crypto.naor_yung import (
    NaorYungError,
    NaorYungKeyPair,
    NaorYungPKey,
)
from vmn_tpu_torch.eio.bytetree import ByteTree, ByteTreeError


class PlainKeysResult:
    def __init__(self, pkeys: Dict[int, Optional[NaorYungPKey]],
                 keypair: NaorYungKeyPair):
        self.pkeys = pkeys  # l -> pkey (None if party l's key malformed)
        self.keypair = keypair

    def cipher(self, randomsource) -> "PlainKeysCipher":
        return PlainKeysCipher(self, randomsource)


class PlainKeysCipher:
    """Adapter with the share-cipher interface consumed by VSS/DKG
    (encrypt(to_party, data) / decrypt(data))."""

    def __init__(self, pk: PlainKeysResult, randomsource):
        self.pk = pk
        self.rs = randomsource

    def encrypt(self, to_party: int, data: bytes) -> bytes:
        pkey = self.pk.pkeys.get(to_party)
        if pkey is None:
            return b""  # party cannot decrypt anyway
        return pkey.encrypt(data, self.rs)

    def decrypt(self, data: bytes) -> bytes:
        try:
            return self.pk.keypair.decrypt(data)
        except NaorYungError as e:
            raise ValueError(f"undecryptable share: {e}") from e


def default_group(pgroup) -> ModPGroup:
    """The Naor–Yung group for a protocol group: its ModP base, or
    modp2048 on the protocol group's device under an EC group."""
    g = pgroup
    while isinstance(g, PPGroup):
        g = g.project(0)
    if isinstance(g, ModPGroup):
        return g
    return ModPGroup.named("modp2048", device=g.device)


def run_plainkeys(ctx, board, randomsource, group=None) -> PlainKeysResult:
    """Generate + exchange CCA2 public keys (reference:
    PlainKeys.generate:132).  `group` selects the Naor-Yung group
    (independent of the protocol group; defaults to `default_group`)."""
    group = group if group is not None else default_group(ctx.pgroup)
    kp = NaorYungKeyPair.generate(randomsource, group)
    b = board.scope("plainkeys")
    b.publish("PublicKey", kp.pkey.to_bytetree().to_bytes())
    pkeys: Dict[int, Optional[NaorYungPKey]] = {}
    for l in range(1, board.k + 1):
        if l == board.j:
            pkeys[l] = kp.pkey
            continue
        raw = b.wait_for(l, "PublicKey")
        try:
            pkeys[l] = NaorYungPKey.from_bytetree(ByteTree.from_bytes(raw),
                                                  device=group.device)
        except (ByteTreeError, ValueError, IndexError):
            pkeys[l] = None
    return PlainKeysResult(pkeys, kp)

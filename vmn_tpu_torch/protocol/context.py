"""Port of `vmn_tpu.protocol.context`: security parameters, groups and
the Fiat–Shamir prefix.  Only the non-interactive (Fiat–Shamir) mode is
ported; interactive challenges (joint coin flipping) raise.

The equivalent of the reference's ProtocolElGamal base-class state
(reference: ProtocolElGamal.java:73 — group/bit-length/PRG/RO-hash
configuration, key/plaintext/ciphertext groups :738-776, globalPrefix
:659-683) detached from any I/O so that live sessions and the standalone
verifier share one definition.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from vmn_tpu_torch import VCR_COMPAT_VERSION
from vmn_tpu_torch.arith.pgroup import ModPGroup, PPGroup
from vmn_tpu_torch.crypto.prg import PRGHeuristic
from vmn_tpu_torch.crypto.ro import RandomOracle
from vmn_tpu_torch.eio.bytetree import int_leaf, leaf, node, string_leaf
from vmn_tpu_torch.eio.marshal import marshal_hex
from vmn_tpu_torch.protocol.hvzk.challenger import ChallengerRO
from vmn_tpu_torch.protocol import elgamal


@dataclass
class ProtocolParams:
    """Shared protocol parameters (the protInfo surface relevant to
    proofs; reference: ProtocolElGamalGen.java:96-160)."""

    sid: str
    k: int = 1
    threshold: int = 1
    pgroup: object = None  # ModPGroup (or EC group)
    keywidth: int = 1
    vbitlen: int = 128
    vbitlenro: int = 256
    ebitlen: int = 128
    ebitlenro: int = 256
    rbitlen: int = 100  # statistical distance (statDist)
    prg_name: str = "SHA-256"
    rohash_name: str = "SHA-256"
    noninteractive: bool = True
    # Marshalled description strings hashed into the global prefix.
    # When parsing reference info files these are the verbatim hex
    # strings; when we generate them ourselves we marshal our own
    # descriptions (reference: ProtocolElGamal.java:352-434).
    prg_string: Optional[str] = None
    pgroup_string: Optional[str] = None
    rohash_string: Optional[str] = None

    def __post_init__(self):
        if not self.noninteractive:
            raise NotImplementedError(
                "interactive mode (coin-flipped challenges) is not ported"
            )
        if self.pgroup is None:
            self.pgroup = ModPGroup.named("modp2048")
        if self.prg_string is None:
            self.prg_string = self.prg_name
        if self.rohash_string is None:
            self.rohash_string = self.rohash_name
        if self.pgroup_string is None:
            self.pgroup_string = marshal_hex(
                self.pgroup, type(self.pgroup).__name__
            )


class ProtocolContext:
    """Derived state shared by every subprotocol of one session."""

    def __init__(self, par: ProtocolParams, rosid: Optional[str] = None):
        self.par = par
        self.pgroup = par.pgroup
        self.rosid = rosid if rosid is not None else par.sid
        from vmn_tpu_torch.crypto.provable import resolve_hash, resolve_prg

        self.ro_hash = resolve_hash(par.rohash_name)
        self.prg = resolve_prg(par.prg_name)
        self.global_prefix = self._global_prefix()
        self.challenger = ChallengerRO(self.ro_hash, self.global_prefix)

    # ------------------------------------------------------------ params

    @property
    def vbitlen(self) -> int:
        """Challenge bits (reference: ProtocolElGamal.vbitlen():620-626)."""
        return (
            self.par.vbitlenro if self.par.noninteractive else self.par.vbitlen
        )

    @property
    def ebitlen(self) -> int:
        return (
            self.par.ebitlenro if self.par.noninteractive else self.par.ebitlen
        )

    @property
    def rbitlen(self) -> int:
        return self.par.rbitlen

    # ------------------------------------------------------------ groups

    def key_group(self):
        """PPGroup(pgroup, keywidth) (reference:
        ProtocolElGamal.java:738-744)."""
        if self.par.keywidth == 1:
            return self.pgroup
        return PPGroup(self.pgroup, self.par.keywidth)

    def plain_group(self, width: int):
        return elgamal.plain_group(self.key_group(), width)

    def ciph_group(self, width: int) -> PPGroup:
        return elgamal.ciph_group(self.key_group(), width)

    # ----------------------------------------------------- global prefix

    def _global_prefix(self) -> bytes:
        """H(node(version, rosid, rbitlen, vbitlenro, ebitlenro, prg,
        pgroup, rohash)) (reference: ProtocolElGamal.initGlobalPrefix
        :659-683; verifier: ...FiatShamirSession.setGlobalPrefix:158-189)."""
        p = self.par
        bt = node(
            string_leaf(VCR_COMPAT_VERSION),
            string_leaf(self.rosid),
            int_leaf(p.rbitlen),
            int_leaf(p.vbitlenro),
            int_leaf(p.ebitlenro),
            string_leaf(p.prg_string),
            string_leaf(p.pgroup_string),
            string_leaf(p.rohash_string),
        )
        return self.ro_hash.hash(bt.to_bytes())

    # ------------------------------------------------------- generators

    def independent_generators(self, sid: str, n: int):
        """Derive n "independent" generators via the random oracle
        (reference: IndependentGeneratorsRO.java:110-130 — seed =
        RO_{H, 8*seedbytes}(globalPrefix || bytetree(leaf(sid))), then
        pGroup.randomElementArray(n, PRG(seed), rbitlen))."""
        prg = PRGHeuristic(self.ro_hash)
        ro = RandomOracle(self.ro_hash, 8 * prg.min_seed_bytes)
        d = ro.digest()
        d.update(self.global_prefix)
        d.update(leaf(sid.encode("utf-8")).to_bytes())
        seed = d.finalize()
        prg.set_seed(seed)
        return self.pgroup.random_array(n, prg, self.rbitlen)

    def session(self, auxsid: str) -> "ProtocolContext":
        """Child context for one mixing session: rosid = sid + '.' + auxsid
        (reference: ...FiatShamirSession.java:160)."""
        return ProtocolContext(self.par, f"{self.par.sid}.{auxsid}")

"""A mix-server: key generation, shuffling, decryption, proof export
(port of `vmn_tpu.protocol.mixnet.party`, plain PoS path).

Ported: `MixNetParty` (k=1 setup, `keygen`, `load_keys`,
`full_public_key`, `session`) and `MixSession.shuffle` without
precomputation, `_prove_pos`, `_verify_pos`, `decrypt` and `mix`.  The
precomputation / commitment-consistent chain (PoSC + CCPoS) raises
(ROADMAP queue 1 item 7); k > 1 needs the plain-key exchange (queue 9).

Proof-directory layout (reference: MixNetElGamalSession.java:381-446):

    nizkp/
      version auxsid type width
      FullPublicKey.bt
      Ciphertexts.bt ShuffledCiphertexts.bt Plaintexts.bt
      proofs/
        activethreshold
        PolynomialInExponent.bt
        Ciphertexts{l:02d}.bt            (intermediate shuffle outputs)
        PermutationCommitment{l:02d}.bt
        PoSCommitment{l:02d}.bt  PoSReply{l:02d}.bt
        DecryptionFactors{l:02d}.bt
        DecrFactCommitment{l:02d}.bt  DecrFactReply{l:02d}.bt
        CorrectIndices.bt
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from vmn_tpu_torch import VCR_COMPAT_VERSION
from vmn_tpu_torch.arith.pgroup import Permutation, PPArray, PPGroup
from vmn_tpu_torch.crypto.randomsource import SeededSource
from vmn_tpu_torch.eio.bytetree import (
    ByteTree, ByteTreeError, int_leaf, lazy_from_bytes, leaf, node,
)
from vmn_tpu_torch.protocol import elgamal
from vmn_tpu_torch.protocol.com.board import BulletinBoard
from vmn_tpu_torch.protocol.context import ProtocolContext, ProtocolParams
from vmn_tpu_torch.protocol.distr import dkg as dkg_mod
from vmn_tpu_torch.protocol.hvzk.pos_tw import (
    PoSParams,
    PoSProver,
    PoSVerifier,
    _all_checks,
    _batched_one_check,
    _eq_device,
    pos_challenge_data,
    pos_seed_data,
)
from vmn_tpu_torch.protocol.log import Log
from vmn_tpu_torch.protocol.state import StateDir


class ProtocolError(Exception):
    pass


def _write(path: Path, data) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(data, str):
        path.write_text(data)
    else:
        path.write_bytes(data)


class MixNetParty:
    """One mix-server (reference: MixNetElGamal.java:46)."""

    def __init__(
        self,
        params: ProtocolParams,
        board: BulletinBoard,
        randomsource,
        directory: Optional[str] = None,
        log=None,
    ):
        self.log = log if log is not None else Log.silent()
        self.par = params
        self.ctx = ProtocolContext(params)
        self.board = board
        self.j = board.j
        self.k = board.k
        self.rs = randomsource
        self.directory = Path(directory) if directory else None
        self.state = (
            StateDir(self.directory / "state")
            if self.directory is not None
            else None
        )
        self.dkg: Optional[dkg_mod.DKGResult] = None
        self.active = [True] * (self.k + 1)  # 1-based; [0] unused

    def setup(self) -> None:
        """Point-to-point CCA2 keys protect VSS shares for k > 1
        (reference: ProtocolElGamal.setup:807-832); k = 1 needs none."""
        if self.k > 1:
            raise NotImplementedError(
                "k > 1 needs the plain-key exchange (ROADMAP queue 9)"
            )

    def keygen(self) -> "elgamal.ElGamalPublicKey":
        """Run DKG; returns the full public key (g, y).  Idempotent: the
        result is cached on disk and reloaded on restart
        (reference: MixNetElGamal.generatePublicKey:195-209)."""
        if self.state is not None and self.load_keys(required=False):
            self.log.info("Read cached key state.")
            return self.full_public_key()
        self.setup()
        self.log.info("Generate public key (distributed key generation).")
        self.dkg = dkg_mod.run_dkg(self.ctx, self.board, self.rs)
        if self.state is not None:
            self.state.write_bytetree(
                "KeyAndPoly.bt",
                node(
                    self.dkg.secret_share.to_bytetree(),
                    self.dkg.poly_bytetree(),
                    int_leaf(self.dkg.k),
                ),
            )
            self.state.write_bytetree(
                "FullPublicKey.bt", self.full_public_key().to_bytetree()
            )
        return self.full_public_key()

    def load_keys(self, required: bool = True) -> bool:
        """Reload persisted DKG state (`KeyAndPoly.bt`, which `vmn_tpu`
        writes in the same format) from the working directory."""
        if self.state is not None:
            bt = self.state.read_bytetree("KeyAndPoly.bt")
            if bt is not None:
                group = self.ctx.key_group()
                self.dkg = dkg_mod.DKGResult(
                    group,
                    group.ring.from_bytetree(bt[0]),
                    group.elem_from_bytetree(bt[1], validate=False),
                    bt[2].to_u32(),
                )
                return True
        if required:
            raise ProtocolError(
                "no key state; run keygen or set a public key first"
            )
        return False

    def full_public_key(self) -> "elgamal.ElGamalPublicKey":
        g = self.ctx.key_group().g
        return elgamal.ElGamalPublicKey(g, self.dkg.joint_public_key)

    def active_threshold(self) -> int:
        """Smallest index L such that parties 1..L include `threshold`
        active ones (reference: ProtocolBBT.getActiveThreshold)."""
        t = 0
        for l in range(1, self.k + 1):
            if self.active[l]:
                t += 1
                if t == self.par.threshold:
                    return l
        raise ProtocolError("fewer than threshold active parties")

    def session(self, auxsid: str, width: int) -> "MixSession":
        nizkp = None
        if self.directory is not None:
            nizkp = self.directory / f"nizkp.{auxsid}"
        return MixSession(self, auxsid, width, nizkp)


class MixSession:
    """One mixing session (reference: MixNetElGamalSession.java:48)."""

    def __init__(self, party: MixNetParty, auxsid: str, width: int,
                 nizkp: Optional[Path]):
        self.party = party
        self.auxsid = auxsid
        self.width = width
        self.ctx = party.ctx.session(auxsid)
        self.board = party.board.scope(f"session.{auxsid}")
        self.state = (
            party.state.sub(f"session.{auxsid}")
            if party.state is not None
            else None
        )
        # Session randomness comes from a source seeded by a persisted
        # secret, so a restarted party regenerates identical
        # contributions (reference: PermutationCommitment.java:156-218).
        if self.state is not None:
            seed_file = self.state.file("session_seed")
            if seed_file.exists():
                seed = seed_file.read_bytes()
            else:
                seed = party.rs.read_bytes(32)
                self.state.path.mkdir(parents=True, exist_ok=True)
                seed_file.touch(mode=0o600)
                seed_file.write_bytes(seed)
            self.rs = SeededSource(seed)
        else:
            self.rs = party.rs
        self.nizkp = nizkp
        self.proofs = nizkp / "proofs" if nizkp else None
        if nizkp is not None:
            _write(nizkp / "version", VCR_COMPAT_VERSION)
            _write(nizkp / "auxsid", auxsid)
            _write(nizkp / "width", str(width))

    @property
    def j(self) -> int:
        return self.party.j

    def _pf(self, name: str, l: Optional[int] = None) -> Optional[Path]:
        if self.proofs is None:
            return None
        if l is None:
            return self.proofs / name
        return self.proofs / f"{name}{l:02d}.bt"

    def _export(self, path: Optional[Path], bt: ByteTree) -> None:
        if path is not None:
            _write(path, bt.to_bytes())

    def _wide_pk(self):
        """Wide public key as a ciphertext-group element."""
        return self.party.full_public_key().widen(self.width).as_ciph_elem()

    def _ciph_group(self) -> PPGroup:
        return self.ctx.ciph_group(self.width)

    def precomp(self, maxciph: int) -> None:
        raise NotImplementedError(
            "precomputation is not ported (ROADMAP queue 1 item 7)"
        )

    def committed_shuffle(self, ciphertexts, write_type: bool = True):
        raise NotImplementedError(
            "the commitment-consistent shuffle is not ported "
            "(ROADMAP queue 1 item 7)"
        )

    # ----------------------------------------------------------- shuffle

    def shuffle(self, ciphertexts: PPArray, write_type: bool = True
                ) -> PPArray:
        """Plain PoS shuffle chain (reference:
        ShufflerElGamalSession.shuffle:362-433 + performShuffling:250-352).
        One-shot per session (marker `.shuffle`): a re-run returns the
        recorded output."""
        if self.state is not None and self.state.has_marker(".shuffle"):
            out = self._reload_ciphertexts("ShuffledCiphertexts.bt",
                                           ciphertexts.size)
            if out is not None:
                return out
            raise ProtocolError("session already used for shuffling")
        party = self.party
        party.log.info(f"Shuffle {ciphertexts.size} ciphertexts.")
        ctx = self.ctx
        n = ciphertexts.size
        width = self.width
        b = self.board.scope("shuffle")

        if self.nizkp is not None and write_type:
            _write(self.nizkp / "type", "shuffling")
        if self.nizkp is not None:
            _write(self.nizkp / "FullPublicKey.bt",
                   party.full_public_key().to_bytetree().to_bytes())
            _write(self.nizkp / "Ciphertexts.bt",
                   ciphertexts.to_bytetree().to_bytes())

        wide_pk_elem = self._wide_pk()
        plain_ring = ctx.plain_group(width).ring
        generators = ctx.independent_generators("generators", n)
        g = ctx.pgroup.g

        active_threshold = party.active_threshold()
        if self.proofs is not None:
            _write(self.proofs / "activethreshold", str(active_threshold))

        pos_par = PoSParams(ctx.vbitlen, ctx.ebitlen, ctx.rbitlen, ctx.prg)

        prover = permutation = reenc_exponents = reenc_factors = None
        if self.j <= active_threshold and party.active[self.j]:
            reenc_exponents = plain_ring.random((n,), self.rs, ctx.rbitlen)
            reenc_factors = elgamal.reencryption_factors(
                party.full_public_key().widen(width), reenc_exponents
            )
            permutation = Permutation.random(n, self.rs)
            prover = PoSProver(pos_par, self.rs)
            prover.precompute(g, generators, permutation)

        inp = ciphertexts
        valid_proofs = 0
        for l in range(1, active_threshold + 1):
            if not party.active[l]:
                continue
            if l == self.j:
                out = inp.mul(reenc_factors).permute(permutation.inv())
                reenc_factors = None  # dead once the output exists
                b.publish(f"Ciphertext{l}", out.to_bytetree().to_bytes())
                party.log.child().info(
                    "Re-encrypt, permute and prove shuffle (PoS)."
                )
                self._prove_pos(
                    b, l, prover, wide_pk_elem, inp, out, reenc_exponents
                )
                valid_proofs += 1
                reenc_exponents = None
            else:
                out_bt = lazy_from_bytes(b.wait_for(l, f"Ciphertext{l}"))
                try:
                    out = self._ciph_group().elem_from_bytetree(out_bt, n)
                except (ByteTreeError, ValueError):
                    out = inp.copy_of_range(0, n)
                party.log.child().info(f"Verify shuffle of party {l} (PoS).")
                if self._verify_pos(b, l, pos_par, g, generators,
                                    wide_pk_elem, inp, out):
                    valid_proofs += 1
                else:
                    out = inp.copy_of_range(0, n)
            if self.nizkp is not None:
                if l == active_threshold:
                    _write(self.nizkp / "ShuffledCiphertexts.bt",
                           out.to_bytetree().to_bytes())
                else:
                    self._export(self._pf("Ciphertexts", l),
                                 out.to_bytetree())
            inp = out

        if valid_proofs < party.par.threshold:
            raise ProtocolError(f"too few valid proofs ({valid_proofs})")
        if self.state is not None:
            self.state.write_marker(".shuffle")
        return inp

    def _reload_ciphertexts(self, name: str, n: int):
        """Recorded transcript output for idempotent resume, or None."""
        if self.nizkp is None or not (self.nizkp / name).exists():
            return None
        bt = lazy_from_bytes((self.nizkp / name).read_bytes())
        return self._ciph_group().elem_from_bytetree(bt, n, validate=False)

    def _prove_pos(self, b, l, prover, pkey, w, wp, s):
        """Fiat–Shamir PoS prover side (reference: PoSTW.prove:94-165)."""
        ctx = self.ctx
        prover.set_instance(pkey, w, wp, s)
        u_bt = prover.u.to_bytetree()
        b.publish(f"PermutationCommitment{l}", u_bt.to_bytes())
        self._export(self._pf("PermutationCommitment", l), u_bt)

        seed = ctx.challenger.challenge(
            pos_seed_data(prover.g, prover.h, prover.u, pkey, w, wp),
            8 * ctx.prg.min_seed_bytes,
            ctx.rbitlen,
        )
        prover.u = None  # its bytes are memoized above
        commitment = prover.commit(seed)
        self._export(self._pf("PoSCommitment", l), commitment)
        b.publish(f"PoSCommitment{l}", commitment.to_bytes())

        v_bytes = ctx.challenger.challenge(
            pos_challenge_data(seed, commitment), ctx.vbitlen, ctx.rbitlen
        )
        reply = prover.reply(int.from_bytes(v_bytes, "big"))
        self._export(self._pf("PoSReply", l), reply)
        b.publish(f"PoSReply{l}", reply.to_bytes())

    def _verify_pos(self, b, l, pos_par, g, generators, pkey, w, wp) -> bool:
        """Fiat–Shamir PoS verifier side (reference: PoSTW.verify:176-272)."""
        ctx = self.ctx
        V = PoSVerifier(pos_par)
        V.precompute(g, generators)
        V.set_instance(pkey, w, wp)

        u_bt = lazy_from_bytes(b.wait_for(l, f"PermutationCommitment{l}"))
        V.set_permutation_commitment(u_bt)
        self._export(self._pf("PermutationCommitment", l), V.u.to_bytetree())

        seed = ctx.challenger.challenge(
            pos_seed_data(g, generators, V.u, pkey, w, wp),
            8 * ctx.prg.min_seed_bytes,
            ctx.rbitlen,
        )
        V.set_batch_vector(seed)
        V.compute_AF()

        com_bt = lazy_from_bytes(b.wait_for(l, f"PoSCommitment{l}"))
        commitment = V.set_commitment(com_bt)
        self._export(self._pf("PoSCommitment", l), commitment)

        v_bytes = ctx.challenger.challenge(
            pos_challenge_data(seed, commitment), ctx.vbitlen, ctx.rbitlen
        )
        reply_bt = lazy_from_bytes(b.wait_for(l, f"PoSReply{l}"))
        verdict = V.verify(reply_bt, int.from_bytes(v_bytes, "big"))
        if verdict:
            self._export(self._pf("PoSReply", l), reply_bt)
        return verdict

    # ----------------------------------------------------------- decrypt

    def decrypt(self, ciphertexts: PPArray, write_type: bool = True):
        """Distributed verifiable decryption
        (reference: DistrElGamalSession.decrypt:344-540)."""
        party = self.party
        ctx = self.ctx
        k = party.k
        threshold = party.par.threshold
        b = self.board.scope("decrypt")
        n = ciphertexts.size

        if self.state is not None and self.state.has_marker(".decrypt"):
            out = self._reload_plaintexts(n)
            if out is not None:
                return out
            raise ProtocolError("session already used for decryption")

        party.log.info(f"Perform distributed decryption of {n} ciphertexts.")
        is_active = [False] + [party.active[l] for l in range(1, k + 1)]
        if sum(is_active) < threshold:
            raise ProtocolError("fewer than threshold active parties")

        if self.nizkp is not None:
            if write_type:
                _write(self.nizkp / "type", "decryption")
                _write(self.nizkp / "Ciphertexts.bt",
                       ciphertexts.to_bytetree().to_bytes())
            _write(self.nizkp / "FullPublicKey.bt",
                   party.full_public_key().to_bytetree().to_bytes())
        poly_bt = party.dkg.poly_bytetree()
        self._export(self._pf("PolynomialInExponent.bt"), poly_bt)

        u = ciphertexts.project(0)
        v_comp = ciphertexts.project(1)
        field = ctx.pgroup.ring
        # The sigma protocol runs over the key group.
        key_group = ctx.key_group()
        key_ring = key_group.ring
        plain_group = ctx.plain_group(self.width)
        inv_factor = _inverse_factor(field, k)
        correct = list(is_active)

        # --- own factors: f_j = u^{-x_j * invFactor} -------------------
        exp_own = party.dkg.secret_share.neg().mul(field.from_int(inv_factor))
        f_own = u.exp(exp_own)
        if is_active[self.j]:
            b.publish(f"DecryptionFactors{self.j}",
                      f_own.to_bytetree().to_bytes())

        factors = [None] * (k + 1)
        for l in range(1, k + 1):
            if not is_active[l]:
                factors[l] = plain_group.one((n,))
            elif l == self.j:
                factors[l] = f_own
            else:
                bt = lazy_from_bytes(b.wait_for(l, f"DecryptionFactors{l}"))
                try:
                    factors[l] = plain_group.elem_from_bytetree(bt, n)
                except (ByteTreeError, ValueError):
                    factors[l] = plain_group.one((n,))
                    correct[l] = False
            self._export(self._pf("DecryptionFactors", l),
                         factors[l].to_bytetree())

        # --- seed: node(node(g, ciphs), node(poly, node(factors...))) --
        g_basic = key_group.g
        seed_data = node(
            node(g_basic.to_bytetree(), ciphertexts.to_bytetree()),
            node(poly_bt,
                 node(*[factors[l].to_bytetree() for l in range(1, k + 1)])),
        )
        seed = ctx.challenger.challenge(
            seed_data, 8 * ctx.prg.min_seed_bytes, ctx.rbitlen
        )
        e = _batch_vector(field, n, ctx.ebitlen, ctx.prg, seed)
        A = u.exp_prod(e, ctx.ebitlen)

        # --- commitments: yp = g^r, Bp = A^r ---------------------------
        r = key_ring.random((), self.rs, ctx.rbitlen)
        yp_own = g_basic.exp(r)
        Bp_own = A.exp(r)
        com_own = node(yp_own.to_bytetree(), Bp_own.to_bytetree())
        if is_active[self.j]:
            b.publish(f"DecrCommitment{self.j}", com_own.to_bytes())

        yps = [None] * (k + 1)
        Bps = [None] * (k + 1)
        for l in range(1, k + 1):
            if not is_active[l]:
                yps[l], Bps[l] = key_group.one(), plain_group.one()
                com_bt = node(yps[l].to_bytetree(), Bps[l].to_bytetree())
            elif l == self.j:
                yps[l], Bps[l] = yp_own, Bp_own
                com_bt = com_own
            else:
                com_bt = lazy_from_bytes(b.wait_for(l, f"DecrCommitment{l}"))
                try:
                    yps[l] = key_group.elem_from_bytetree(com_bt[0])
                    Bps[l] = plain_group.elem_from_bytetree(com_bt[1])
                except (ByteTreeError, ValueError, IndexError):
                    yps[l], Bps[l] = key_group.one(), plain_group.one()
                    correct[l] = False
                    com_bt = node(yps[l].to_bytetree(), Bps[l].to_bytetree())
            self._export(self._pf("DecrFactCommitment", l), com_bt)

        # --- challenge -------------------------------------------------
        all_coms = node(*[
            node(yps[l].to_bytetree(), Bps[l].to_bytetree())
            for l in range(1, k + 1)
        ])
        v_bytes = ctx.challenger.challenge(
            node(leaf(seed), all_coms), ctx.vbitlen, ctx.rbitlen
        )
        v_f = field.from_int(int.from_bytes(v_bytes, "big"))

        # --- replies: k_x = -x*invFactor*v + r -------------------------
        kx_own = exp_own.mul(v_f).add(r)
        if is_active[self.j]:
            b.publish(f"DecrReply{self.j}", kx_own.to_bytetree().to_bytes())
        kxs = [None] * (k + 1)
        for l in range(1, k + 1):
            if not is_active[l]:
                kxs[l] = key_ring.from_int(0)
            elif l == self.j:
                kxs[l] = kx_own
            else:
                bt = lazy_from_bytes(b.wait_for(l, f"DecrReply{l}"))
                try:
                    kxs[l] = key_ring.from_bytetree(bt)
                except (ByteTreeError, ValueError):
                    kxs[l] = key_ring.from_int(0)
                    correct[l] = False
            self._export(self._pf("DecrFactReply", l), kxs[l].to_bytetree())

        # --- optimistic combined verification --------------------------
        y_parties = [None] + [
            party.dkg.public_key_of(l) for l in range(1, k + 1)
        ]
        combined_f = _combine_factors(factors, correct, k, threshold, field)
        ok = _verify_combined(
            field, g_basic, A, party.dkg.joint_public_key, combined_f, e,
            ctx.ebitlen, yps, Bps, kxs, correct, k, threshold, v_f,
        )
        if not ok:
            for l in range(1, k + 1):
                if correct[l] and l != self.j:
                    correct[l] = _verify_party(
                        field, g_basic, A, y_parties[l], factors[l], e,
                        ctx.ebitlen, yps[l], Bps[l], kxs[l], inv_factor, v_f,
                    )
            combined_f = _combine_factors(factors, correct, k, threshold,
                                          field)

        plaintexts = v_comp.mul(combined_f)
        if self.proofs is not None:
            _write(self.proofs / "CorrectIndices.bt",
                   _bool_array_bt(correct).to_bytes())
        if self.nizkp is not None:
            _write(self.nizkp / "Plaintexts.bt",
                   plaintexts.to_bytetree().to_bytes())
        if self.state is not None:
            self.state.write_marker(".decrypt")
        return plaintexts

    def _reload_plaintexts(self, n: int):
        """Recorded plaintexts for idempotent resume, or None."""
        if self.nizkp is None or not (self.nizkp / "Plaintexts.bt").exists():
            return None
        bt = lazy_from_bytes((self.nizkp / "Plaintexts.bt").read_bytes())
        return self.ctx.plain_group(self.width).elem_from_bytetree(
            bt, n, validate=False
        )

    def mix(self, ciphertexts: PPArray):
        """Shuffle then decrypt (reference: MixNetElGamalSession.mix)."""
        if self.nizkp is not None:
            _write(self.nizkp / "type", "mixing")
            _write(self.nizkp / "Ciphertexts.bt",
                   ciphertexts.to_bytetree().to_bytes())
        shuffled = self.shuffle(ciphertexts, write_type=False)
        return self.decrypt(shuffled, write_type=False)


# --------------------------------------------------------------- helpers


def _batch_vector(field, n, ebitlen, prg, seed):
    prg.set_seed(seed)
    return field.random_bits_prg(n, ebitlen, prg)


def _prod_factor(k: int) -> int:
    """Square of the product of maximal prime powers <= k
    (reference: DistrElGamalSessionBasic.prodFactor:318-344)."""
    res = 1
    p = 2
    while p <= k:
        pw = 1
        while pw * p <= k:
            pw *= p
        res *= pw
        p = _next_prime(p)
    return res * res


def _next_prime(p: int) -> int:
    n = p + 1
    while not all(n % d for d in range(2, int(n ** 0.5) + 1)):
        n += 1
    return n


def _inverse_factor(field, k: int) -> int:
    return pow(_prod_factor(k), -1, field.q)


def _lagrange_ints(field, correct, k, threshold):
    """Modified Lagrange coefficients, smallest signed representatives
    (reference: DistrElGamalSessionBasic:358-452)."""
    pf = _prod_factor(k)
    q = field.q
    idxs = [l for l in range(1, k + 1) if correct[l]][:threshold]
    if len(idxs) < threshold:
        raise ProtocolError("too few correct decryption factors")
    out = []
    for i in idxs:
        res = pf % q
        for l in idxs:
            if l != i:
                res = res * l % q
                res = res * pow(l - i, -1, q) % q
        alt = res - q
        out.append(alt if abs(alt) < res else res)
    return idxs, out


def _exp_small(arr, lam: int, field):
    """arr^lam for a small signed host-known integer lam, with |lam|'s
    own bit length as the exponent bound."""
    if lam < 0:
        arr = arr.inv()
        lam = -lam
    if lam == 1:
        return arr
    return arr.exp_bits(field.from_int(lam), max(1, lam.bit_length()))


def _combine_factors(factors, correct, k, threshold, field):
    """prod_l f_l^(lambda_l) over the first `threshold` correct parties
    (reference: combineDecryptionFactors:465-503)."""
    idxs, lags = _lagrange_ints(field, correct, k, threshold)
    acc = None
    for i, lam in zip(idxs, lags):
        term = _exp_small(factors[i], lam, field)
        acc = term if acc is None else acc.mul(term)
    return acc


def _verify_combined(field, g, A, joint_y, combined_f, e, ebitlen,
                     yps, Bps, kxs, correct, k, threshold, v_f):
    """Combined sigma verification (reference: verifyCombined:693-700):
    both equations
        y^(-v) cyp g^(-ckx) == 1   and   B^v cBp A^(-ckx) == 1
    as one stacked multi-exponentiation against the identity."""
    idxs, lags = _lagrange_ints(field, correct, k, threshold)
    cyp = cBp = ckx = None
    for i, lam in zip(idxs, lags):
        typ = _exp_small(yps[i], lam, field)
        tBp = _exp_small(Bps[i], lam, field)
        cyp = typ if cyp is None else cyp.mul(typ)
        cBp = tBp if cBp is None else cBp.mul(tBp)
        term = kxs[i].mul(field.from_int(lam))
        ckx = term if ckx is None else ckx.add(term)
    combined_B = combined_f.exp_prod(e, ebitlen)
    one = field.from_int(1)
    return _all_checks([_batched_one_check(field, [
        [(joint_y, v_f.neg()), (cyp, one), (g, ckx.neg())],
        [(combined_B, v_f), (cBp, one), (A, ckx.neg())],
    ])])


def _verify_party(field, g, A, y_l, f_l, e, ebitlen, yp, Bp, kx,
                  inv_factor, v_f):
    """Per-party sigma verification (reference: verify:718-727)."""
    B_l = f_l.exp_prod(e, ebitlen)
    ivf = field.from_int(inv_factor)
    return _all_checks([
        _eq_device(y_l.inv().exp(ivf.mul(v_f)).mul(yp), g.exp(kx)),
        _eq_device(B_l.exp(v_f).mul(Bp), A.exp(kx)),
    ])


def _bool_array_bt(correct) -> ByteTree:
    """boolean[] -> leaf of 0/1 bytes."""
    return leaf(bytes(1 if c else 0 for c in correct))

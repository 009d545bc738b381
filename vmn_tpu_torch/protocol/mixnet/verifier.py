"""Standalone Fiat–Shamir verifier of a proof directory (port of
`vmn_tpu.protocol.mixnet.verifier`).

Verifies `mixing`, `shuffling` and `decryption` transcripts offline — no
network, no secrets (reference:
MixNetElGamalVerifyFiatShamirSession.verify:1318-1668), with the
reference's test-vector output (`test_vectors=`, `self.tv`) and its
skip-part switches (`check_pos`, `check_dec`, `sloppy`, and `check_posc`
/ `check_ccpos` for the precomputation mode).  A shuffle is checked as
a chain of PoS proofs, or, when the transcript holds `proofs/maxciph`,
as the precomputation mode's chain: PoSC, the keep-list shrink, CCPoS.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from vmn_tpu_torch import VCR_COMPAT_VERSION
from vmn_tpu_torch.arith.pgroup import deferred_membership
from vmn_tpu_torch.eio.bytetree import (
    ByteTree, ByteTreeError, lazy_from_bytes, leaf, node,
)
from vmn_tpu_torch.protocol import elgamal
from vmn_tpu_torch.protocol.context import ProtocolContext, ProtocolParams
from vmn_tpu_torch.protocol.distr.dkg import evaluate_poly_in_exp
from vmn_tpu_torch.protocol.hvzk.ccpos_w import (
    CCPoSVerifier,
    ccpos_challenge_data,
    ccpos_seed_data,
)
from vmn_tpu_torch.protocol.hvzk.pos_tw import (
    PoSParams,
    PoSVerifier,
    pos_challenge_data,
    pos_seed_data,
)
from vmn_tpu_torch.protocol.hvzk.posc_tw import (
    PoSCVerifier,
    posc_challenge_data,
    posc_seed_data,
)
from vmn_tpu_torch.protocol.mixnet.party import (
    _batch_vector,
    _combine_factors,
    _inverse_factor,
    _verify_combined,
    _verify_party,
)


class VerificationError(Exception):
    pass


@dataclass
class VerificationResult:
    type: str
    auxsid: str
    width: int
    active_threshold: int
    shuffle_ok: bool
    decrypt_ok: bool
    test_vectors: Dict[str, str]

    @property
    def ok(self) -> bool:
        return self.shuffle_ok and self.decrypt_ok


class FiatShamirVerifier:
    """Universal verifier for a nizkp directory."""

    def __init__(self, params: ProtocolParams, nizkp,
                 test_vectors: Optional[List[str]] = None):
        self.par = params
        self.nizkp = Path(nizkp)
        self.proofs = self.nizkp / "proofs"
        self.tv_names = set(test_vectors or [])
        self.tv: Dict[str, str] = {}

    def _tv(self, name: str, value) -> None:
        """Test-vector output.  A requested PREFIX (e.g. "PoS")
        activates every dotted name under it, exactly like the
        reference name check (reference:
        MixNetElGamalVerifyFiatShamir.checkTestVector:399-409,
        checkPrintTestVector:418-430).  `value` may be a zero-argument
        callable, called only when the name is requested (serializing
        an N-array costs a device-to-host copy)."""
        if name in self.tv_names or (
            "." in name and name.split(".", 1)[0] in self.tv_names
        ):
            if callable(value):
                value = value()
            self.tv[name] = str(value)

    def _fail(self, msg: str):
        raise VerificationError(msg)

    def _read(self, path: Path) -> bytes:
        if not path.exists():
            self._fail(f"missing file: {path}")
        return path.read_bytes()

    def _read_bt(self, path: Path) -> ByteTree:
        try:
            return lazy_from_bytes(self._read(path))
        except ByteTreeError as e:
            self._fail(f"malformed byte tree in {path}: {e}")

    # -------------------------------------------------------------- main

    def verify(self, expected_type: Optional[str] = None,
               expected_auxsid: Optional[str] = None,
               check_pos: bool = True,
               check_dec: bool = True,
               check_posc: bool = True,
               check_ccpos: bool = True,
               expected_width: Optional[int] = None,
               sloppy: bool = False) -> VerificationResult:
        """Optimistic verification: subgroup-membership checks (host
        Jacobi, or the device QR test for large CUDA arrays) are deferred
        to a worker and joined before the verdict; if any fails — only
        possible on a Byzantine transcript — the whole verification
        reruns with inline checks.  `check_pos`/`check_dec` skip the
        shuffle or the decryption part (reference:
        MixNetElGamalVerifyFiatShamirTool.java -nopos/-nodec/-sloppy,
        :540-641)."""
        kw = dict(
            expected_type=expected_type, expected_auxsid=expected_auxsid,
            check_pos=check_pos, check_dec=check_dec,
            check_posc=check_posc, check_ccpos=check_ccpos,
            expected_width=expected_width, sloppy=sloppy,
        )
        futures = []
        with ThreadPoolExecutor(max_workers=1) as pool:
            try:
                with deferred_membership(
                    lambda thunk: futures.append(pool.submit(thunk))
                ):
                    res = self._verify_inner(**kw)
            except VerificationError:
                if self._membership_ok(futures):
                    raise
                return self._verify_inner(**kw)
            if self._membership_ok(futures):
                return res
        return self._verify_inner(**kw)

    @staticmethod
    def _membership_ok(futures) -> bool:
        try:
            return all(f.result() for f in futures)
        except Exception:  # a failed check counts as a failed membership
            return False

    def _verify_inner(self, expected_type=None, expected_auxsid=None,
                      check_pos=True, check_dec=True, check_posc=True,
                      check_ccpos=True, expected_width=None,
                      sloppy=False) -> VerificationResult:
        nz = self.nizkp
        version = self._read(nz / "version").decode().strip()
        if version != VCR_COMPAT_VERSION:
            self._fail(f"incompatible proof version: {version}")
        ptype = self._read(nz / "type").decode().strip()
        auxsid = self._read(nz / "auxsid").decode().strip()
        width = int(self._read(nz / "width").decode().strip())
        if expected_type is not None and ptype != expected_type:
            self._fail(f"wrong proof type {ptype} != {expected_type}")
        if expected_auxsid is not None and auxsid != expected_auxsid:
            self._fail("wrong auxsid")
        if expected_width is not None and width != expected_width:
            self._fail(f"wrong width {width} != {expected_width}")
        do_pos = check_pos and ptype in ("mixing", "shuffling")
        do_dec = check_dec and ptype in ("mixing", "decryption")
        # Skip-part switches of the precomputation mode (reference:
        # -noposc / -noccpos / -sloppy).
        self._check_posc = check_posc
        self._check_ccpos = check_ccpos
        self._sloppy = sloppy

        ctx = ProtocolContext(self.par, f"{self.par.sid}.{auxsid}")
        # The reference's test-vector names (reference:
        # MixNetElGamalVerifyFiatShamirSession.java:162-1634).  Values
        # are hex byte trees / decimal ints in the canonical encodings.
        self._tv("par.sid", self.par.sid)
        self._tv("par.version", version)
        self._tv("par.k", self.par.k)
        self._tv("par.lambda", self.par.threshold)
        self._tv("par.n_e", self.par.ebitlenro)
        self._tv("par.n_r", self.par.rbitlen)
        self._tv("par.n_v", self.par.vbitlenro)
        self._tv("par.s_PRG", self.par.prg_string)
        self._tv("par.s_Gq", self.par.pgroup_string)
        self._tv("par.s_H", self.par.rohash_string)
        self._tv("par.omega", width)
        self._tv("der.rho", ctx.global_prefix.hex())

        # Full public key (g, y): the basic key must be the generator.
        key_group = ctx.key_group()
        fpk_bt = self._read_bt(nz / "FullPublicKey.bt")
        fpk = elgamal.ElGamalPublicKey.from_bytetree(key_group, fpk_bt)
        if not fpk.g.equals(key_group.g):
            self._fail("basic public key is not the standard generator")
        self._tv("bas.pk", fpk_bt.to_bytes().hex())
        self._tv("bas.C_omega", repr(ctx.ciph_group(width)))
        self._tv("bas.M_omega", repr(ctx.plain_group(width)))
        self._tv("bas.R_omega", repr(ctx.plain_group(width).ring))

        at_file = self.proofs / "activethreshold"
        active_threshold = (
            int(self._read(at_file).decode().strip())
            if at_file.exists() else self.par.threshold
        )
        if not (self.par.threshold <= active_threshold <= self.par.k):
            self._fail("bad active threshold")

        ciph_group = ctx.ciph_group(width)
        ciphs = None
        if do_pos or do_dec:
            if do_pos or ptype == "decryption":
                bt = self._read_bt(nz / "Ciphertexts.bt")
            else:
                # A mixing transcript without its shuffle part: the
                # decryption's input is the last shuffler's list, which
                # the parties write as ShuffledCiphertexts.bt (vmn_tpu
                # reads proofs/Ciphertexts{activethreshold}.bt only,
                # which no party writes: ROADMAP queue 3, F9).
                last = self.proofs / f"Ciphertexts{active_threshold:02d}.bt"
                bt = self._read_bt(
                    last if last.exists() else nz / "ShuffledCiphertexts.bt"
                )
            ciphs = ciph_group.elem_from_bytetree(bt)
            self._tv("bas.L_0", lambda bt=bt: bt.to_bytes().hex())
        n = ciphs.size if ciphs is not None else 0

        shuffle_ok = True
        if do_pos:
            ciphs, shuffle_ok = self._verify_shuffling(
                ctx, width, ciph_group, ciphs, n, active_threshold, fpk
            )
        decrypt_ok = True
        if do_dec:
            decrypt_ok = self._verify_decryption(ctx, width, ciphs, fpk)
        return VerificationResult(ptype, auxsid, width, active_threshold,
                                  shuffle_ok, decrypt_ok, self.tv)

    # ----------------------------------------------------------- shuffle

    def _verify_shuffling(self, ctx, width, ciph_group, ciphs, n,
                          active_threshold, fpk):
        """Per-party PoS chain, replacing an output by its input on
        failure (reference: ...FiatShamirSession.java:1397-1517), or the
        precomputation mode's chain when the transcript holds `maxciph`."""
        if (self.proofs / "maxciph").exists():
            return self._verify_shuffling_precomp(
                ctx, width, ciph_group, ciphs, n, active_threshold, fpk
            )
        generators = ctx.independent_generators("generators", n)
        self._tv("bas.h",
                 lambda: generators.to_bytetree().to_bytes().hex())
        g = ctx.pgroup.g
        wide_pk_elem = fpk.widen(width).as_ciph_elem()
        pos_par = PoSParams(ctx.vbitlen, ctx.ebitlen, ctx.rbitlen, ctx.prg)

        inp = ciphs
        valid = 0
        for l in range(1, active_threshold + 1):
            pc_file = self.proofs / f"PoSCommitment{l:02d}.bt"
            if not pc_file.exists():
                continue  # inactive party
            out_file = self.proofs / f"Ciphertexts{l:02d}.bt"
            if l == active_threshold and not out_file.exists():
                out_file = self.nizkp / "ShuffledCiphertexts.bt"
            out_bt = self._read_bt(out_file)
            try:
                out = ciph_group.elem_from_bytetree(out_bt, n)
            except (ByteTreeError, ValueError):
                self._fail(f"malformed output list of party {l}")
            self._tv("bas.L_l", lambda bt=out_bt: bt.to_bytes().hex())

            V = PoSVerifier(pos_par)
            V.precompute(g, generators)
            V.set_instance(wide_pk_elem, inp, out)
            u_file = self.proofs / f"PermutationCommitment{l:02d}.bt"
            V.set_permutation_commitment(
                self._read_bt(u_file) if u_file.exists() else None
            )
            self._tv("u", lambda: V.u.to_bytetree().to_bytes().hex())
            seed = ctx.challenger.challenge(
                pos_seed_data(g, generators, V.u, wide_pk_elem, inp, out),
                8 * ctx.prg.min_seed_bytes,
                ctx.rbitlen,
            )
            self._tv("PoS.s", seed.hex())
            V.set_batch_vector(seed)
            V.compute_AF()
            self._tv("PoS.A", lambda: V.A.to_bytetree().to_bytes().hex())
            self._tv("PoS.F", lambda: V.F.to_bytetree().to_bytes().hex())
            commitment = V.set_commitment(self._read_bt(pc_file))
            for name in ("B", "Ap", "Bp", "Cp", "Dp", "Fp"):
                self._tv(f"PoS.{name}",
                         lambda v=getattr(V, name):
                         v.to_bytetree().to_bytes().hex())
            v_bytes = ctx.challenger.challenge(
                pos_challenge_data(seed, commitment),
                ctx.vbitlen, ctx.rbitlen,
            )
            v = int.from_bytes(v_bytes, "big")
            self._tv("PoS.v", v)
            reply_file = self.proofs / f"PoSReply{l:02d}.bt"
            verdict = reply_file.exists() and V.verify(
                self._read_bt(reply_file), v
            )
            if verdict:
                for name in ("C", "D", "k_A", "k_B", "k_C", "k_D", "k_E",
                             "k_F"):
                    self._tv(f"PoS.{name}",
                             lambda v=getattr(V, name):
                             v.to_bytetree().to_bytes().hex())
            if verdict:
                valid += 1
            else:
                out = inp.copy_of_range(0, n)
            inp = out
        return inp, valid >= self.par.threshold

    def _verify_shuffling_precomp(self, ctx, width, ciph_group, ciphs, n,
                                  active_threshold, fpk):
        """Precomputation-mode chain: PoSC over the maxciph-sized
        commitments, the keep-list shrink, then a CCPoS per party
        (reference: ...FiatShamirSession.java:1404-1495).  The
        `check_posc`/`check_ccpos` switches skip their proofs."""
        maxciph = int(self._read(self.proofs / "maxciph").decode().strip())
        self._tv("par.N_0", maxciph)
        if maxciph < n:
            self._fail("maxciph smaller than number of ciphertexts")
        generators = ctx.independent_generators("generators", maxciph)
        self._tv("bas.h",
                 lambda: generators.to_bytetree().to_bytes().hex())
        shrunk_generators = generators.copy_of_range(0, n)
        g = ctx.pgroup.g
        wide_pk_elem = fpk.widen(width).as_ciph_elem()
        pos_par = PoSParams(ctx.vbitlen, ctx.ebitlen, ctx.rbitlen, ctx.prg)

        inp = ciphs
        valid = 0
        for l in range(1, active_threshold + 1):
            cc_file = self.proofs / f"CCPoSCommitment{l:02d}.bt"
            if not cc_file.exists():
                continue  # inactive party

            # PoSC over the full-size commitment
            u_file = self.proofs / f"PermutationCommitment{l:02d}.bt"
            try:
                perm_comm = ctx.pgroup.elem_from_bytetree(
                    self._read_bt(u_file), maxciph
                )
            except (ByteTreeError, ValueError):
                perm_comm = generators.copy_of_range(0, maxciph)
            self._tv("u",
                     lambda: perm_comm.to_bytetree().to_bytes().hex())
            posc_ok = True
            if self._check_posc:
                V = PoSCVerifier(pos_par)
                V.set_instance(g, generators, perm_comm)
                seed = ctx.challenger.challenge(
                    posc_seed_data(g, generators, perm_comm),
                    8 * ctx.prg.min_seed_bytes, ctx.rbitlen,
                )
                self._tv("PoSC.s", seed.hex())
                V.set_batch_vector(seed)
                commitment = V.set_commitment(
                    self._read_bt(self.proofs / f"PoSCCommitment{l:02d}.bt")
                )
                v_int = int.from_bytes(ctx.challenger.challenge(
                    posc_challenge_data(seed, commitment),
                    ctx.vbitlen, ctx.rbitlen,
                ), "big")
                self._tv("PoSC.v", v_int)
                reply_file = self.proofs / f"PoSCReply{l:02d}.bt"
                posc_ok = reply_file.exists() and V.verify(
                    self._read_bt(reply_file), v_int
                )
            if not posc_ok:
                perm_comm = generators.copy_of_range(0, maxciph)

            # the keep-list shrink
            kl_bt = self._read_bt(self.proofs / f"KeepList{l:02d}.bt")
            keep = np.frombuffer(kl_bt.data, np.uint8).astype(bool)
            if keep.shape[0] != maxciph or int(keep.sum()) != n:
                self._fail(f"bad keep list of party {l}")
            shrunk_comm = perm_comm.take(np.nonzero(keep)[0])

            # the output list and its CCPoS
            out_file = self.proofs / f"Ciphertexts{l:02d}.bt"
            if l == active_threshold and not out_file.exists():
                out_file = self.nizkp / "ShuffledCiphertexts.bt"
            out_bt = self._read_bt(out_file)
            try:
                out = ciph_group.elem_from_bytetree(out_bt, n)
            except (ByteTreeError, ValueError):
                self._fail(f"malformed output list of party {l}")
            self._tv("bas.L_l", lambda bt=out_bt: bt.to_bytes().hex())

            cc_ok = True
            if self._check_ccpos:
                CV = CCPoSVerifier(pos_par)
                CV.set_instance(g, shrunk_generators, shrunk_comm,
                                wide_pk_elem, inp, out)
                seed = ctx.challenger.challenge(
                    ccpos_seed_data(g, shrunk_generators, shrunk_comm,
                                    wide_pk_elem, inp, out),
                    8 * ctx.prg.min_seed_bytes, ctx.rbitlen,
                )
                self._tv("CCPoS.s", seed.hex())
                CV.set_batch_vector(seed)
                CV.compute_AB()
                commitment = CV.set_commitment(self._read_bt(cc_file))
                v_int = int.from_bytes(ctx.challenger.challenge(
                    ccpos_challenge_data(seed, commitment),
                    ctx.vbitlen, ctx.rbitlen,
                ), "big")
                self._tv("CCPoS.v", v_int)
                r_file = self.proofs / f"CCPoSReply{l:02d}.bt"
                cc_ok = r_file.exists() and CV.verify(
                    self._read_bt(r_file), v_int
                )
            if posc_ok and cc_ok:
                valid += 1
            else:
                out = inp.copy_of_range(0, n)
            inp = out
        return inp, valid >= self.par.threshold

    # ----------------------------------------------------------- decrypt

    def _verify_decryption(self, ctx, width, ciphs, fpk) -> bool:
        """Combined decryption-proof verification + plaintext match
        (reference: ...FiatShamirSession.java:1537-1667)."""
        k = self.par.k
        threshold = self.par.threshold
        field = ctx.pgroup.ring
        n = ciphs.size
        plain_grp = ctx.plain_group(width)

        poly_bt = self._read_bt(self.proofs / "PolynomialInExponent.bt")
        key_group = ctx.key_group()
        try:
            poly = key_group.elem_from_bytetree(poly_bt, threshold)
        except (ByteTreeError, ValueError):
            self._fail("malformed polynomial in exponent")
        if not fpk.y.equals(poly.get(0)):
            self._fail("mismatching public keys")
        y_parties = [None] + [
            evaluate_poly_in_exp(poly, l) for l in range(1, k + 1)
        ]
        self._tv("bas.y_l", lambda: ",".join(
            y_parties[l].to_bytetree().to_bytes().hex()
            for l in range(1, k + 1)))

        cr_bt = self._read_bt(self.proofs / "CorrectIndices.bt")
        correct = [bool(b) for b in cr_bt.data]
        if len(correct) != k + 1:
            self._fail("malformed correct-indices array")
        if sum(correct[1:]) < threshold:
            self._fail("fewer than threshold correct decryption factors")

        factors = [None] * (k + 1)
        for l in range(1, k + 1):
            f_file = self.proofs / f"DecryptionFactors{l:02d}.bt"
            try:
                factors[l] = plain_grp.elem_from_bytetree(
                    self._read_bt(f_file), n
                )
            except (ByteTreeError, ValueError):
                factors[l] = plain_grp.one((n,))

        u = ciphs.project(0)
        g_basic = key_group.g
        key_ring = key_group.ring
        combined_f = _combine_factors(factors, correct, k, threshold, field)

        seed_data = node(
            node(g_basic.to_bytetree(), ciphs.to_bytetree()),
            node(poly_bt,
                 node(*[factors[l].to_bytetree() for l in range(1, k + 1)])),
        )
        seed = ctx.challenger.challenge(
            seed_data, 8 * ctx.prg.min_seed_bytes, ctx.rbitlen
        )
        self._tv("Dec.s", seed.hex())
        e = _batch_vector(field, n, ctx.ebitlen, ctx.prg, seed)
        A = u.exp_prod(e, ctx.ebitlen)

        yps = [None] * (k + 1)
        Bps = [None] * (k + 1)
        kxs = [None] * (k + 1)
        for l in range(1, k + 1):
            com_bt = self._read_bt(
                self.proofs / f"DecrFactCommitment{l:02d}.bt"
            )
            try:
                yps[l] = key_group.elem_from_bytetree(com_bt[0])
                Bps[l] = plain_grp.elem_from_bytetree(com_bt[1])
            except (ByteTreeError, ValueError, IndexError):
                yps[l], Bps[l] = key_group.one(), plain_grp.one()
            r_bt = self._read_bt(self.proofs / f"DecrFactReply{l:02d}.bt")
            try:
                kxs[l] = key_ring.from_bytetree(r_bt)
            except (ByteTreeError, ValueError):
                kxs[l] = key_ring.from_int(0)

        all_coms = node(*[
            node(yps[l].to_bytetree(), Bps[l].to_bytetree())
            for l in range(1, k + 1)
        ])
        v_bytes = ctx.challenger.challenge(
            node(leaf(seed), all_coms), ctx.vbitlen, ctx.rbitlen
        )
        v_int = int.from_bytes(v_bytes, "big")
        self._tv("Dec.v", v_int)
        v_f = field.from_int(v_int)

        ok = _verify_combined(
            field, g_basic, A, fpk.y, combined_f, e, ctx.ebitlen,
            yps, Bps, kxs, correct, k, threshold, v_f,
        )
        if not ok:
            inv_factor = _inverse_factor(field, k)
            per = list(correct)
            for l in range(1, k + 1):
                if per[l]:
                    per[l] = _verify_party(
                        field, g_basic, A, y_parties[l], factors[l], e,
                        ctx.ebitlen, yps[l], Bps[l], kxs[l], inv_factor, v_f,
                    )
            if per[1:] != correct[1:] or sum(per[1:]) < threshold:
                return False

        computed = ciphs.project(1).mul(combined_f)
        try:
            published = plain_grp.elem_from_bytetree(
                self._read_bt(self.nizkp / "Plaintexts.bt"), n
            )
        except (ByteTreeError, ValueError):
            return False
        return computed.equals(published)

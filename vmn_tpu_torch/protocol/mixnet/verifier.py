"""Standalone Fiat–Shamir verifier of a proof directory (port of
`vmn_tpu.protocol.mixnet.verifier`, plain PoS path).

Verifies `mixing`, `shuffling` and `decryption` transcripts offline — no
network, no secrets (reference:
MixNetElGamalVerifyFiatShamirSession.verify:1318-1668).  A transcript of
the precomputation mode (`proofs/maxciph`, PoSC + CCPoS) raises
(ROADMAP queue 1 item 7); test-vector output is not ported yet.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from vmn_tpu_torch import VCR_COMPAT_VERSION
from vmn_tpu_torch.arith.pgroup import deferred_membership
from vmn_tpu_torch.eio.bytetree import (
    ByteTree, ByteTreeError, lazy_from_bytes, leaf, node,
)
from vmn_tpu_torch.protocol import elgamal
from vmn_tpu_torch.protocol.context import ProtocolContext, ProtocolParams
from vmn_tpu_torch.protocol.distr.dkg import evaluate_poly_in_exp
from vmn_tpu_torch.protocol.hvzk.pos_tw import (
    PoSParams,
    PoSVerifier,
    pos_challenge_data,
    pos_seed_data,
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

    @property
    def ok(self) -> bool:
        return self.shuffle_ok and self.decrypt_ok


class FiatShamirVerifier:
    """Universal verifier for a nizkp directory."""

    def __init__(self, params: ProtocolParams, nizkp):
        self.par = params
        self.nizkp = Path(nizkp)
        self.proofs = self.nizkp / "proofs"

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
               expected_width: Optional[int] = None) -> VerificationResult:
        """Optimistic verification: subgroup-membership checks (host
        Jacobi, or the device QR test for large CUDA arrays) are deferred
        to a worker and joined before the verdict; if any fails — only
        possible on a Byzantine transcript — the whole verification
        reruns with inline checks."""
        kw = dict(expected_type=expected_type,
                  expected_auxsid=expected_auxsid,
                  expected_width=expected_width)
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
                      expected_width=None) -> VerificationResult:
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
        do_pos = ptype in ("mixing", "shuffling")
        do_dec = ptype in ("mixing", "decryption")

        ctx = ProtocolContext(self.par, f"{self.par.sid}.{auxsid}")

        # Full public key (g, y): the basic key must be the generator.
        key_group = ctx.key_group()
        fpk = elgamal.ElGamalPublicKey.from_bytetree(
            key_group, self._read_bt(nz / "FullPublicKey.bt")
        )
        if not fpk.g.equals(key_group.g):
            self._fail("basic public key is not the standard generator")

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
                bt = self._read_bt(
                    self.proofs / f"Ciphertexts{active_threshold:02d}.bt"
                )
            ciphs = ciph_group.elem_from_bytetree(bt)
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
                                  shuffle_ok, decrypt_ok)

    # ----------------------------------------------------------- shuffle

    def _verify_shuffling(self, ctx, width, ciph_group, ciphs, n,
                          active_threshold, fpk):
        """Per-party PoS chain, replacing an output by its input on
        failure (reference: ...FiatShamirSession.java:1397-1517)."""
        if (self.proofs / "maxciph").exists():
            raise NotImplementedError(
                "precomputation transcripts (PoSC + CCPoS) are not ported "
                "(ROADMAP queue 1 item 7)"
            )
        generators = ctx.independent_generators("generators", n)
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

            V = PoSVerifier(pos_par)
            V.precompute(g, generators)
            V.set_instance(wide_pk_elem, inp, out)
            u_file = self.proofs / f"PermutationCommitment{l:02d}.bt"
            V.set_permutation_commitment(
                self._read_bt(u_file) if u_file.exists() else None
            )
            seed = ctx.challenger.challenge(
                pos_seed_data(g, generators, V.u, wide_pk_elem, inp, out),
                8 * ctx.prg.min_seed_bytes,
                ctx.rbitlen,
            )
            V.set_batch_vector(seed)
            V.compute_AF()
            commitment = V.set_commitment(self._read_bt(pc_file))
            v_bytes = ctx.challenger.challenge(
                pos_challenge_data(seed, commitment),
                ctx.vbitlen, ctx.rbitlen,
            )
            reply_file = self.proofs / f"PoSReply{l:02d}.bt"
            verdict = reply_file.exists() and V.verify(
                self._read_bt(reply_file), int.from_bytes(v_bytes, "big")
            )
            if verdict:
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
        v_f = field.from_int(int.from_bytes(v_bytes, "big"))

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

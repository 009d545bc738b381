"""Joint coin flipping over the ring, backed by Pedersen VSS (port of
`vmn_tpu.protocol.coinflip`; the same coins from the same seeds).

Rebuild of the reference construction (reference:
CoinFlipPRingSource.java:66, CoinFlipPRing.java:71): a coin is prepared
by every party dealing a random ring pair (s, t) through Pedersen
verifiable secret sharing with commitment polynomial c_m = g^{a_m}h^{b_m}
over an independent generator h (the BiExpProd homomorphism restricted
to (g, h), CoinFlipPRing.java:240-259); the instances are collapsed by
summation.  Collecting the coin publicly *recovers* the joint sharing
from any `threshold` valid shares and projects the first component —
so a party that mis-opens, goes silent, or deals garbage is
disqualified or reconstructed, and can neither block nor bias the coin.

The device work of a ModP group is batched over every coin of a dealing
or an opening: the commitments g^a h^b are two fixed-base powers of
(n·t,) exponents, and a Feldman check raises the stacked polynomials'
(n, t) coefficients to the powers i^m as one variable-base power of
(n·t, L) flattened limbs and multiplies each row out in one product
tree (MontCtx.exp / MontCtx.prod).

Used by `ChallengerI` for interactive proofs (reference:
ChallengerI.java:53-60).
"""

from __future__ import annotations

import torch

from vmn_tpu_torch.arith.pgroup import FArray, GArray, PPFArray, PPRing
from vmn_tpu_torch.eio.bytetree import ByteTree, ByteTreeError, node
from vmn_tpu_torch.protocol.distr.dkg import evaluate_poly_in_exp
from vmn_tpu_torch.protocol.secretsharing.pedersen import (
    _NullCipher,
    run_pedersen_sequential,
)
from vmn_tpu_torch.protocol.secretsharing.shamir import shamir_recover


class CoinFlipError(Exception):
    pass


class _CoinView:
    """Per-coin view of a batched collapsed dealing: the fields
    `_collect_many` consumes (share + polynomial in exponent)."""

    __slots__ = ("share", "poly_in_exp")

    def __init__(self, share, poly_in_exp):
        self.share = share
        self.poly_in_exp = poly_in_exp


def _pp_reshape(pp, shape):
    """Reshape the leading dims of a product-ring array."""
    return PPFArray(pp.parent, tuple(
        FArray(c.field, c.limbs.reshape(shape + c.limbs.shape[-1:]))
        for c in pp.components
    ))


def _eval_poly_batch(ring, coeffs, i: int):
    """Horner evaluation of n stacked degree-(t-1) polynomials at the
    scalar point i: coeffs (n, t) pair-ring array -> (n,) pairs."""
    t = coeffs.components[0].limbs.shape[1]
    x = ring.from_int(i)

    def col(m):
        return PPFArray(coeffs.parent, tuple(
            FArray(c.field, c.limbs[:, m]) for c in coeffs.components))

    acc = col(t - 1)
    for m in range(t - 2, -1, -1):
        acc = acc.mul(x).add(col(m))
    return acc


def _poly_eval_exp_limbs(grp, limbs, i: int, t: int):
    """prod_m C[c, m]^{i^m} for stacked polynomial limbs (n, t, L) at
    scalar i -> (n,) group elements: one power of the n·t flattened
    elements over the bits of i^(t-1) (the exponents are public and
    small), one product tree over m."""
    powers = [i ** m for m in range(t)]
    e = grp.ring.from_ints(powers)  # (t,)
    powed = grp.ctx.exp(limbs, e.limbs, max(1, powers[-1].bit_length()))
    return GArray(grp, grp.ctx.prod(powed, axis=1))


def _batch_share_check(hom, grp, poly, share, i: int, n: int, t: int) -> bool:
    """hom.g^share == poly(i) for all n coins at once (one device
    check instead of n)."""
    limbs = poly.limbs.reshape((n, t) + poly.limbs.shape[-1:])
    return hom.g.exp(share).equals(_poly_eval_exp_limbs(grp, limbs, i, t))


class _HomGenerator:
    """The restricted homomorphism (a, b) -> g^a h^b as a 'generator'
    consumed by the Pedersen machinery (reference: BiExpProd restricted
    to (g, h), CoinFlipPRing.java:254-259).  Commitments are plain
    base-group elements; shares/exponents are ring PAIRS."""

    def __init__(self, g, h):
        self._g = g
        self._h = h

    def exp(self, pair):
        a, b = pair.components
        return self._g.exp(a).mul(self._h.exp(b))


class _HomGroup:
    """Group adapter seen by `run_pedersen`: pair ring, hom generator,
    base-group commitments."""

    def __init__(self, base_group, h):
        self.base = base_group
        self.ring = PPRing(base_group.ring, base_group.ring)
        self.g = _HomGenerator(base_group.g, h)

    def one(self, shape=()):
        return self.base.one(shape)

    def elem_from_bytetree(self, bt, size=None, validate=True):
        return self.base.elem_from_bytetree(bt, size, validate)


class CoinFlipPRingSource:
    """Joint coin-flip source over a bulletin-board scope.

    `prepare_coins(n)` runs the VSS dealing phase ahead of time
    (reference: prepareCoins CoinFlipPRingSource.java:153); `coin_bytes`
    collects prepared coins (recovery) on demand.
    """

    def __init__(self, ctx, board, randomsource, cipher=None, h=None):
        self.ctx = ctx
        self.board = board
        self.rs = randomsource
        self.cipher = cipher
        base = ctx.pgroup
        if h is None:
            # Independent generator with unknown discrete log, derived
            # via the random oracle (reference seeds the source with the
            # jointly generated IndependentGenerator; an RO generator is
            # the non-interactive equivalent, IndependentGeneratorsRO).
            h = ctx.independent_generators("coinflipgen", 1).get(0)
        self.hom = _HomGroup(base, h)
        # ModP base groups have limb-array commitments that the batched
        # dealing/collection paths stack; EC groups take the per-coin
        # paths.
        self._batched = not hasattr(base, "from_affine")
        self._prepared = []  # (coin id, share + polynomial in exponent)
        self._counter = 0
        # When set, the first collect tops the prepared pool up to this
        # many coins in one dealing burst (reference: prepareCoins,
        # CoinFlipPRingSource.java:153).  Identical on every party, so
        # the dealing schedule stays in lockstep.
        self.pre_target = 0

    # ------------------------------------------------------------ prepare

    def prepare_coins(self, n: int) -> None:
        """Deal `n` coins ahead of use in ONE batched VSS instance per
        dealer: each dealer shares n random pairs at once — one
        Polynomial publish of n*t commitments, one n-share message per
        recipient, one complaint bit per dealer — and the instances
        collapse by summation.  A dealer that misbehaves on ANY coin of
        the batch is disqualified for the WHOLE batch (coins sum over
        the qualified dealers).  Reference: prepareCoins,
        CoinFlipPRingSource.java:153; PedersenSequential collapse."""
        if n <= 0:
            return
        if not self._batched:
            self._prepare_coins_generic(n)
            return
        first = self._counter
        self._counter += n
        ctx = self.ctx
        hom = self.hom
        ring = hom.ring
        grp = ctx.pgroup
        t = ctx.par.threshold
        k = self.board.k
        j = self.board.j
        b = self.board.scope(f"deal{first:03d}x{n:03d}")
        cipher = self.cipher or _NullCipher()

        share_sum = None  # (n,) ring pair
        poly_sum = None  # (n*t,) base-group commitments

        for d in range(1, k + 1):
            bd = b.scope(f"d{d:02d}")
            if j == d:
                coeffs = ring.random((n, t), self.rs, ctx.rbitlen)
                poly = hom.g.exp(_pp_reshape(coeffs, (n * t,)))
                bd.publish("Polynomial", poly.to_bytetree().to_bytes())
                for i in range(1, k + 1):
                    s_i = _eval_poly_batch(ring, coeffs, i)
                    bd.publish(f"Share{i:02d}", cipher.encrypt(
                        i, s_i.to_bytetree().to_bytes()))
                share = _eval_poly_batch(ring, coeffs, j)
                complain = False
            else:
                try:
                    poly = grp.elem_from_bytetree(
                        ByteTree.from_bytes(bd.wait_for(d, "Polynomial")),
                        n * t)
                except (ByteTreeError, ValueError):
                    bd.publish("Complaint", b"\x01")
                    for l in range(1, k + 1):
                        if l != j:
                            bd.wait_for(l, "Complaint")
                    continue  # dealer disqualified (malformed poly)
                try:
                    share = ring.from_bytetree(ByteTree.from_bytes(
                        cipher.decrypt(bd.wait_for(d, f"Share{j:02d}"))), n)
                    complain = not _batch_share_check(
                        hom, grp, poly, share, j, n, t)
                except Exception:  # malformed/undecryptable share
                    share = None
                    complain = True
            bd.publish("Complaint", b"\x01" if complain else b"\x00")
            complainers = []
            for l in range(1, k + 1):
                c = ((b"\x01" if complain else b"\x00") if l == j
                     else bd.wait_for(l, "Complaint"))
                if c and c[0] == 1 and l != d:
                    complainers.append(l)
            ok = True
            for i in complainers:
                if j == d:
                    opened = _eval_poly_batch(ring, coeffs, i)
                    bd.publish(f"OpenShare{i:02d}",
                               opened.to_bytetree().to_bytes())
                else:
                    try:
                        opened = ring.from_bytetree(ByteTree.from_bytes(
                            bd.wait_for(d, f"OpenShare{i:02d}")), n)
                    except (ByteTreeError, ValueError):
                        ok = False
                        continue
                if not _batch_share_check(hom, grp, poly, opened, i, n, t):
                    ok = False
                elif i == j:
                    share = opened
            if not ok or share is None:
                continue  # dealer disqualified for the batch
            share_sum = share if share_sum is None else share_sum.add(share)
            poly_sum = poly if poly_sum is None else poly_sum.mul(poly)
        if share_sum is None:
            raise CoinFlipError("no qualified coin dealers")

        poly_limbs = poly_sum.limbs.reshape((n, t) + poly_sum.limbs.shape[1:])
        for i in range(n):
            self._prepared.append((first + i, _CoinView(
                share_sum.get(i), GArray(grp, poly_limbs[i]))))

    def _prepare_coins_generic(self, n: int) -> None:
        """Per-coin sequential dealing (any group)."""
        for _ in range(n):
            cid = self._counter
            self._counter += 1
            seq = run_pedersen_sequential(
                self.ctx,
                self.board.scope(f"coin{cid:03d}"),
                self.rs,
                dealers=range(1, self.board.k + 1),
                cipher=self.cipher,
                group=self.hom,
                threshold=self.ctx.par.threshold,
            )
            self._prepared.append((cid, seq))

    # ------------------------------------------------------------ collect

    def _collect_many(self, ncoins: int):
        """Recover `ncoins` prepared coins in ONE board round: every
        party opens ALL its collapsed shares in a single message; any
        `threshold` Feldman-valid shares reconstruct each coin
        (reference: CoinFlipPRing.getCoin -> pedersen.recover;
        CoinFlipPRingSource.java:153-232)."""
        want = max(ncoins, self.pre_target)
        self.pre_target = 0  # one pre-dealt burst per session
        if len(self._prepared) < want:
            self.prepare_coins(want - len(self._prepared))
        batch = [self._prepared.pop(0) for _ in range(ncoins)]
        b = self.board.scope(f"open{batch[0][0]:03d}x{ncoins:03d}")
        t = self.ctx.par.threshold
        ring = self.hom.ring

        my_bytes = node(*[seq.share.to_bytetree() for _, seq in batch]
                        ).to_bytes()
        b.publish("Shares", my_bytes)
        grp = self.ctx.pgroup
        if self._batched:
            t_deg = batch[0][1].poly_in_exp.size
            poly_stack = torch.stack(
                [seq.poly_in_exp.limbs for _, seq in batch])  # (ncoins, t, L)
        shares = [dict() for _ in batch]
        for l in range(1, self.board.k + 1):
            if all(len(s) >= t for s in shares):
                break
            raw = my_bytes if l == self.board.j else b.wait_for(l, "Shares")
            try:
                kids = list(ByteTree.from_bytes(raw).children)
            except (ByteTreeError, ValueError):
                continue
            if len(kids) != ncoins:
                continue
            parsed = []
            for i in range(ncoins):
                try:
                    sp = ring.from_bytetree(kids[i])
                    # enforce SCALAR pairs: a malicious array-shaped
                    # share must not crash the batched stack below
                    if any(c.limbs.dim() != 1 for c in sp.components):
                        sp = None
                except (ByteTreeError, ValueError):
                    sp = None
                parsed.append(sp)
            idxs = [i for i, s in enumerate(parsed) if s is not None]
            if not idxs:
                continue
            if not self._batched:
                # per-coin Feldman check
                for i in idxs:
                    if len(shares[i]) < t and self.hom.g.exp(
                            parsed[i]).equals(evaluate_poly_in_exp(
                                batch[i][1].poly_in_exp, l)):
                        shares[i][l] = parsed[i]
                continue
            # ONE batched Feldman check for all of party l's opened
            # shares: hom.g^s_i == poly_i(l) componentwise.
            sb = PPFArray(ring, tuple(
                FArray(parsed[idxs[0]].components[c].field, torch.stack(
                    [parsed[i].components[c].limbs for i in idxs]))
                for c in range(2)))
            rows = torch.tensor(idxs, device=poly_stack.device)
            feld = _poly_eval_exp_limbs(grp, poly_stack[rows], l, t_deg)
            got = self.hom.g.exp(sb)
            ok_rows = (got.limbs == feld.limbs).all(dim=-1).tolist()
            for row, i in enumerate(idxs):
                if len(shares[i]) < t and ok_rows[row]:
                    shares[i][l] = parsed[i]
        out = []
        for i in range(ncoins):
            if len(shares[i]) < t:
                raise CoinFlipError("fewer than threshold valid coin shares")
            pair = shamir_recover(ring, shares[i], t)
            out.append(pair.components[0])  # project(0), ref getCoin
        return out

    def coin_bytes(self, n: int) -> bytes:
        """Concatenate recovered ring coins into n bytes.

        Each coin yields floor((qbits - rbitlen)/8) bytes to keep the
        statistical distance bound (reference: getCoinBytes
        CoinFlipPRingSource.java:232).  All coins for the request are
        recovered in one batched open round."""
        q = self.ctx.pgroup.ring.q
        per = max(1, (q.bit_length() - self.ctx.rbitlen) // 8)
        qbytes = (q.bit_length() + 7) // 8
        out = b"".join(
            coin.to_int().to_bytes(qbytes, "big")[-per:]
            for coin in self._collect_many(-(-n // per)))
        return out[:n]


class ChallengerI:
    """Interactive challenger: challenges are jointly flipped coins
    (reference: ChallengerI.java:53-60 — the data argument is unused,
    the prover's messages are already on the board when the flip
    happens)."""

    def __init__(self, source: CoinFlipPRingSource):
        self.source = source

    def challenge(self, data, vbitlen: int, rbitlen: int = 0) -> bytes:
        nbytes = (vbitlen + 7) // 8
        raw = bytearray(self.source.coin_bytes(nbytes))
        extra = 8 * nbytes - vbitlen
        if extra:
            raw[0] &= 0xFF >> extra
        return bytes(raw)

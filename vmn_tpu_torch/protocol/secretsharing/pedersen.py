"""Port of `vmn_tpu.protocol.secretsharing.pedersen`: Pedersen verifiable
secret sharing over the bulletin board, with the public recovery of a
dealt secret (`recover_secret`, through `shamir.shamir_recover`).

Original description:

Rebuild of the reference's VSS protocol (reference: Pedersen.java:77 —
`dealSecret` :355 publishes the polynomial in exponent and shares
encrypted to each party's CCA2 public key; `receiveShare` :820 runs a
complaint/accusation path where a disputed share is opened publicly;
`recover` :1057 reconstructs a dealer's secret from threshold shares;
PedersenSequential.java:47 runs one instance per dealer and collapses
them into a joint sharing — the substrate of DKG.java:141-215).

Determinism rule (mirrors the reference's Byzantine handling style):
any objectively-bad public contribution — malformed polynomial,
publicly-opened share failing the Feldman check — replaces the dealer's
sharing by the *trivial* sharing of 0 (polynomial 1, all shares 0), so
every honest party derives the same qualified set from board data alone.

Feldman check: g^{s_{l->i}} == prod_m c_{l,m}^{i^m}
(reference: PolynomialInExponent evaluation used by receiveShare).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from vmn_tpu_torch.eio.bytetree import ByteTree, ByteTreeError
from vmn_tpu_torch.protocol.secretsharing.shamir import shamir_recover


class PedersenError(Exception):
    pass


class _NullCipher:
    """Share 'encryption' for the in-process simulation harness."""

    def encrypt(self, to_party: int, data: bytes) -> bytes:
        return data

    def decrypt(self, data: bytes) -> bytes:
        return data


class PedersenResult:
    """Outcome of one VSS instance for this party."""

    def __init__(self, dealer: int, ok: bool, share, poly_in_exp):
        self.dealer = dealer
        self.ok = ok  # dealer qualified?
        self.share = share  # own share s_{dealer->j} (ring element)
        self.poly_in_exp = poly_in_exp  # (t, .) commitment g^{coeffs}

    @property
    def constant_in_exp(self):
        """g^{secret} — the dealt secret in the exponent."""
        return self.poly_in_exp.get(0)


def trivial_result(dealer: int, group, threshold: int) -> PedersenResult:
    """The deterministic default sharing of 0 substituted for a
    disqualified dealer (reference: deterministic-default style,
    SURVEY.md §5 failure handling)."""
    return PedersenResult(
        dealer,
        False,
        _ring_zero(group.ring),
        group.one((threshold,)),
    )


def run_pedersen(
    ctx,
    board,
    randomsource,
    dealer: int,
    cipher=None,
    secret=None,
    group=None,
    threshold: Optional[int] = None,
) -> PedersenResult:
    """One VSS instance with dealer `dealer` among board.k parties.

    As the dealer, deals `secret` (random if None).  Returns this
    party's verified share and the public polynomial in exponent
    (reference: Pedersen.dealSecret:355 / receiveShare:820).
    """
    from vmn_tpu_torch.protocol.distr.dkg import evaluate_poly_in_exp

    cipher = cipher or _NullCipher()
    group = group if group is not None else ctx.key_group()
    t = threshold if threshold is not None else ctx.par.threshold
    j = board.j
    k = board.k
    b = board.scope(f"ped{dealer:02d}")
    ring = group.ring

    my_coeffs = None
    if j == dealer:
        my_coeffs = ring.random((t,), randomsource, ctx.rbitlen)
        if secret is not None:
            my_coeffs = _set_constant(my_coeffs, secret)
        poly = group.g.exp(my_coeffs)
        b.publish("Polynomial", poly.to_bytetree().to_bytes())
        for i in range(1, k + 1):
            s = _eval_poly(ring, my_coeffs, i)
            b.publish(
                f"Share{i:02d}",
                cipher.encrypt(i, s.to_bytetree().to_bytes()),
            )

    # --- receive polynomial (public, objectively checkable) ------------
    if j == dealer:
        poly = group.g.exp(my_coeffs)
    else:
        raw = b.wait_for(dealer, "Polynomial")
        try:
            poly = group.elem_from_bytetree(ByteTree.from_bytes(raw), t)
        except (ByteTreeError, ValueError):
            return trivial_result(dealer, group, t)

    # --- own share + complaint round ------------------------------------
    if j == dealer:
        share = _eval_poly(ring, my_coeffs, j)
        complain = False
    else:
        try:
            share = ring.from_bytetree(
                ByteTree.from_bytes(
                    cipher.decrypt(b.wait_for(dealer, f"Share{j:02d}"))
                )
            )
            complain = not group.g.exp(share).equals(
                evaluate_poly_in_exp(poly, j)
            )
        except Exception:  # malformed/undecryptable share
            share = None
            complain = True
    b.publish("Complaint", bytes([1 if complain else 0]))

    complainers = []
    for l in range(1, k + 1):
        c = bytes([1 if complain else 0]) if l == j else b.wait_for(
            l, "Complaint"
        )
        if c and c[0] == 1 and l != dealer:
            complainers.append(l)

    # --- accusation resolution: dealer opens disputed shares ------------
    # (reference: Pedersen.java complaint path — the opened share is
    # public and objectively verifiable, so all parties agree.)
    ok = True
    for i in complainers:
        if j == dealer:
            s = _eval_poly(ring, my_coeffs, i)
            b.publish(f"OpenShare{i:02d}", s.to_bytetree().to_bytes())
            opened = s
        else:
            raw = b.wait_for(dealer, f"OpenShare{i:02d}")
            try:
                opened = ring.from_bytetree(ByteTree.from_bytes(raw))
            except (ByteTreeError, ValueError):
                ok = False
                continue
        if not group.g.exp(opened).equals(evaluate_poly_in_exp(poly, i)):
            ok = False
        elif i == j:
            share = opened  # adopt the publicly opened share

    if not ok:
        return trivial_result(dealer, group, t)
    if share is None:  # complained but dealer opened a valid share
        raise PedersenError("share unresolved after accusation round")
    return PedersenResult(dealer, True, share, poly)


def recover_secret(ctx, board, result: PedersenResult, group=None):
    """Jointly reconstruct a dealer's secret from published shares
    (reference: Pedersen.recover:1057 — each party opens its share, the
    first `threshold` Feldman-valid ones interpolate the secret)."""
    from vmn_tpu_torch.protocol.distr.dkg import evaluate_poly_in_exp

    group = group if group is not None else ctx.key_group()
    ring = group.ring
    t = result.poly_in_exp.size
    b = board.scope(f"rec{result.dealer:02d}")
    own = result.share.to_bytetree().to_bytes()
    b.publish("Share", own)
    shares = {}
    for l in range(1, board.k + 1):
        raw = own if l == board.j else b.wait_for(l, "Share")
        try:
            s = ring.from_bytetree(ByteTree.from_bytes(raw))
        except (ByteTreeError, ValueError):
            continue
        if group.g.exp(s).equals(evaluate_poly_in_exp(result.poly_in_exp, l)):
            shares[l] = s
        if len(shares) == t:
            break
    return shamir_recover(ring, shares, t)


class SequentialResult:
    """Collapsed joint sharing (reference: PedersenSequential.collapse)."""

    def __init__(self, results: List[PedersenResult], share, poly_in_exp):
        self.results = results  # per-dealer instances, dealt order
        self.share = share  # sum of shares of qualified dealers
        self.poly_in_exp = poly_in_exp  # product of qualified polys

    @property
    def qualified(self) -> List[int]:
        return [r.dealer for r in self.results if r.ok]


def run_pedersen_sequential(
    ctx,
    board,
    randomsource,
    dealers: Sequence[int],
    cipher=None,
    group=None,
    threshold: Optional[int] = None,
) -> SequentialResult:
    """One VSS instance per dealer, then collapse: share = sum of own
    shares, polynomial = elementwise product — a joint sharing of the
    sum of the dealt secrets (reference: PedersenSequential.java:47;
    consumed by DKG.generate DKG.java:141-215)."""
    group = group if group is not None else ctx.key_group()
    results = []
    for dealer in dealers:
        results.append(
            run_pedersen(
                ctx, board, randomsource, dealer,
                cipher=cipher, group=group, threshold=threshold,
            )
        )
    share = None
    poly = None
    for r in results:
        if not r.ok:
            continue
        share = r.share if share is None else share.add(r.share)
        poly = r.poly_in_exp if poly is None else poly.mul(r.poly_in_exp)
    if share is None:
        raise PedersenError("no qualified dealers")
    return SequentialResult(results, share, poly)


# --------------------------------------------------------------- helpers


def _eval_poly(ring, coeffs, i: int):
    """P(i) = sum_m coeffs_m i^m over the exponent ring."""
    acc = None
    power = 1
    t = _coeff_count(coeffs)
    for m in range(t):
        term = coeffs.get(m).mul(_ring_const(ring, power))
        acc = term if acc is None else acc.add(term)
        power *= i
    return acc


def _coeff_count(coeffs) -> int:
    from vmn_tpu_torch.arith.pgroup import FArray

    if isinstance(coeffs, FArray):
        return int(coeffs.limbs.shape[0])
    return _coeff_count(coeffs.components[0])


def _ring_const(ring, value: int):
    from vmn_tpu_torch.arith.pgroup import PField, PPFArray, PPRing

    if isinstance(ring, PPRing):
        return PPFArray(
            ring, tuple(_ring_const(f, value) for f in ring.factors)
        )
    assert isinstance(ring, PField)
    return ring.from_int(value)


def _ring_zero(ring):
    from vmn_tpu_torch.arith.pgroup import PPRing

    if isinstance(ring, PPRing):
        return ring.zeros(())
    return ring.from_int(0)


def _set_constant(coeffs, secret):
    """Replace coefficient 0 with `secret` (same container type)."""
    from vmn_tpu_torch.arith.pgroup import FArray, PPFArray

    if isinstance(coeffs, FArray):
        limbs = coeffs.limbs.clone()
        limbs[0] = secret.limbs
        return FArray(coeffs.field, limbs)
    return PPFArray(
        coeffs.parent,
        tuple(
            _set_constant(c, s)
            for c, s in zip(coeffs.components, secret.components)
        ),
    )

"""The plain versions' route on Python integers (`HOST_ROWS` rows of a
CPU tensor or fewer, `mont_kernels.HostField`) against their torch ops on
the same inputs: H1 (also on limbs of values in [m, R), where REDC's one
conditional subtraction leaves them above m), H2, H5 and H8 over the
ModP fields test256 and modp2048 and the curves P-224, P-256, P-384 and
P-521, with infinity, P + P, P + (-P), scalar 0 and scalar n - 1 among
the inputs, and the EC position combine (one point's chain) at each
curve.  The routes must give the same limbs.

Tolerance: exact equality of limbs.
"""

import numpy as np
import pytest
import torch

from torch_port_util import TEST256_P, limbs_np, modp2048_p, rand_ints
from vmn_tpu_torch.ops import ec_kernels as E
from vmn_tpu_torch.ops import mont_kernels as K


def _both(monkeypatch, fn):
    """fn() through the torch ops, then through the integer route."""
    monkeypatch.setattr(K, "HOST_ROWS", 0)
    want = fn()
    monkeypatch.setattr(K, "HOST_ROWS", 32)
    got = fn()
    want, got = ((t,) if isinstance(t, torch.Tensor) else t
                 for t in (want, got))
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and torch.equal(w, g)


def _limbs(ints, L):
    return torch.from_numpy(limbs_np(ints, L).astype(np.int32))


@pytest.mark.parametrize("m", [TEST256_P, modp2048_p()],
                         ids=["test256", "modp2048"])
def test_mont_mul_and_exp_routes_agree(monkeypatch, m):
    L = -(-m.bit_length() // 16)
    mod = K.Modulus.of(m, L, "cpu")
    rng = np.random.default_rng(L)
    a = rand_ints(rng, 6, m) + [0, m - 1]
    b = rand_ints(rng, 6, m) + [m - 1, 1]
    # above m: the plain REDC keeps its single conditional subtraction
    c = [m + 1, (1 << 16 * L) - 1] + rand_ints(rng, 6, m)
    e = rand_ints(rng, 7, 1 << 64) + [0]
    ta, tb, tc = _limbs(a, L), _limbs(b, L), _limbs(c, L)
    _both(monkeypatch, lambda: K.mont_mul_plain(ta, tb, mod))
    _both(monkeypatch, lambda: K.mont_mul_plain(tc, ta, mod))
    _both(monkeypatch, lambda: K.mont_mul_plain(ta[:1], tb, mod))
    _both(monkeypatch, lambda: K.mont_exp_plain(ta, _limbs(e, 4), mod, 64))


@pytest.mark.parametrize("curve", ["P-224", "P-256", "P-384", "P-521"])
def test_ec_routes_agree(monkeypatch, curve):
    from vmn_tpu_torch.arith.ec import ECqPGroup

    g = ECqPGroup.named(curve, device="cpu")
    mod = g.curve.ctx.mod
    P = g.g.exp_bits(g.ring.from_ints([3, 5, 0, 7, 9]), 4)
    ks = g.ring.from_ints([(1 << (g.n.bit_length() - 1)) + 5, 3, 7, 0,
                           g.n - 1]).limbs
    nbits = g.n.bit_length()
    _both(monkeypatch, lambda: E.ec_scalar_mul_plain(P.x, P.y, P.inf, ks,
                                                     mod, nbits))
    X, Y, Z = E.ec_scalar_mul_plain(P.x, P.y, P.inf, ks, mod, nbits)
    # rows: P + (-P), P + P, inf + Q, inf + inf, P + inf
    order = torch.tensor([0, 1, 4, 2, 3])
    negY = K.sub_mod(torch.zeros_like(Y), Y, mod.limbs)
    Y2 = torch.where(torch.tensor([[True]] + [[False]] * 4), negY, Y)
    _both(monkeypatch, lambda: E.ec_point_add_plain(
        X, Y, Z, X[order], Y2[order], Z[order], mod))


@pytest.mark.parametrize("curve", ["P-224", "P-256", "P-384", "P-521"])
def test_ec_combine_routes_agree(monkeypatch, curve):
    """The combine over 16 positions, one of them infinity."""
    from vmn_tpu_torch.arith.ec import ECqPGroup

    g = ECqPGroup.named(curve, device="cpu")
    mod = g.curve.ctx.mod
    P = g.g.exp_bits(g.ring.from_ints(list(range(3, 19))), 8)
    X, Y, Z = E.ec_scalar_mul_plain(P.x, P.y, P.inf, g.ring.from_ints(
        [2 * i + 1 for i in range(16)]).limbs, mod, 8)
    Z = Z.clone()
    Z[5] = 0
    _both(monkeypatch, lambda: E.ec_multiexp_combine_plain(X, Y, Z, mod))

"""Shared helpers of the `vmn_tpu_torch` port tests.

Inputs are made from a seed with numpy and handed to both packages; the
port's limbs come back as uint32 numpy arrays so that a comparison with
`vmn_tpu` is plain array equality.  Everything compared is integer
arithmetic, so every tolerance in these tests is exact equality.
"""

import numpy as np
import pytest
import torch

# Keep torch from starving the other test workers.
torch.set_num_threads(2)

TEST256_P = int(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff72ef", 16
)


def modp2048_p() -> int:
    from vmn_tpu_torch.arith.pgroup import _RFC3526_2048

    return _RFC3526_2048


def modulus(name: str) -> int:
    return TEST256_P if name == "test256" else modp2048_p()


def rand_ints(rng: np.random.Generator, n: int, bound: int) -> list:
    """n integers in [0, bound) from numpy bytes."""
    nbytes = (bound.bit_length() + 7) // 8 + 8
    return [int.from_bytes(rng.bytes(nbytes), "big") % bound
            for _ in range(n)]


def edge_values(m: int) -> list:
    return [0, 1, 2, m - 1, m - 2, m // 2, 3, m // 3]


def limbs_np(ints, L: int) -> np.ndarray:
    from vmn_tpu_torch.arith.limbs import ints_to_limbs

    return ints_to_limbs(list(ints), L)


def as_np(t) -> np.ndarray:
    """Port tensor or JAX array -> uint32 numpy limbs."""
    if isinstance(t, torch.Tensor):
        return t.cpu().numpy().astype(np.uint32)
    return np.asarray(t).astype(np.uint32)


def host_ec_add(p: int, a: int, P, Q):
    """Affine point addition on y^2 = x^3 + ax + b over Python ints;
    None is the point at infinity."""
    if P is None:
        return Q
    if Q is None:
        return P
    (x1, y1), (x2, y2) = P, Q
    if x1 == x2 and (y1 + y2) % p == 0:
        return None
    if P == Q:
        lam = (3 * x1 * x1 + a) * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    return x3, (lam * (x1 - x3) - y1) % p


def host_ec_mul(p: int, a: int, P, k: int):
    """k·P by double-and-add over Python ints."""
    acc, add = None, P
    while k:
        if k & 1:
            acc = host_ec_add(p, a, acc, add)
        add = host_ec_add(p, a, add, add)
        k >>= 1
    return acc


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100, see README)")
    return torch.device("cuda", 0)

"""Port of `vmn_tpu.crypto.primes` (a host-only copy; the same draws in the
same order, so a seeded source gives the same primes).

Primality testing and safe-prime group generation.

The gmpmee primality surface consumed by the reference `vog` when
generating fresh `ModPGroup`s of arbitrary bit length (reference:
SURVEY.md §2.3 — gmpmee Miller-Rabin/safe-prime tests; vog `-pGroup
ModPGroup -bitLen n`).

Miller-Rabin here is the standard probabilistic test with random bases
from the given RandomSource (error <= 4^-reps), preceded by a
small-prime sieve; safe-prime search sieves q and p = 2q+1 jointly so
one division pass filters both.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# Primes below 2^16 for sieving.
_SMALL: Optional[np.ndarray] = None


def _small_primes() -> np.ndarray:
    global _SMALL
    if _SMALL is None:
        n = 1 << 16
        sieve = np.ones(n, dtype=bool)
        sieve[:2] = False
        for i in range(2, int(n**0.5) + 1):
            if sieve[i]:
                sieve[i * i :: i] = False
        _SMALL = np.nonzero(sieve)[0].astype(np.int64)
    return _SMALL


def miller_rabin(n: int, randomsource, reps: int = 40) -> bool:
    """Probabilistic primality test (error <= 4^-reps)."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(reps):
        a = 2 + randomsource.random_int_mod(n - 3)
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def is_safe_prime(p: int, randomsource, reps: int = 40) -> bool:
    """p and (p-1)/2 both prime."""
    return (
        p % 2 == 1
        and miller_rabin(p, randomsource, reps)
        and miller_rabin((p - 1) // 2, randomsource, reps)
    )


def random_safe_prime(bits: int, randomsource, reps: int = 40) -> int:
    """Random safe prime p = 2q+1 with exactly `bits` bits.

    Joint sieve: a candidate q survives only if neither q nor 2q+1 has
    a small factor (2q+1 ≡ 0 mod s iff q ≡ (s-1)/2 mod s), which
    removes ~90% of candidates before any modular exponentiation."""
    if bits < 3:
        raise ValueError("need at least 3 bits")
    small = _small_primes()[1:]  # odd primes
    half = (small - 1) // 2  # q ≡ (s-1)/2 mod s  =>  s | 2q+1
    while True:
        q = randomsource.random_int(bits - 1) | (1 << (bits - 2)) | 1
        # sieve a window of candidates q, q+2, q+4, ...
        window = 1 << 12
        rem = np.array([q % int(s) for s in small], dtype=np.int64)
        for step in range(0, window, 2):
            cur = (rem + step) % small
            if (cur == 0).any() or (cur == half).any():
                continue
            cand = q + step
            if cand.bit_length() != bits - 1:
                break
            # cheap scan first, full confidence only on the survivor
            if miller_rabin(cand, randomsource, 8) and miller_rabin(
                2 * cand + 1, randomsource, 8
            ):
                if miller_rabin(cand, randomsource, reps) and miller_rabin(
                    2 * cand + 1, randomsource, reps
                ):
                    return 2 * cand + 1


def random_group(bits: int, randomsource, reps: int = 40, device="cuda"):
    """Fresh ModPGroup over a random `bits`-bit safe prime, built on
    `device` (reference: vog ModPGroup generation)."""
    from vmn_tpu_torch.arith.pgroup import ModPGroup

    p = random_safe_prime(bits, randomsource, reps)
    q = (p - 1) // 2
    # generator of the QR subgroup: square any g with g^2 != 1
    g = 4
    while pow(g, q, p) != 1 or g in (0, 1):
        g = (g + 1) * (g + 1) % p
    return ModPGroup(p, q, g, device=device)

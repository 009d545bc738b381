"""Live adversaries against the port's k=3, t=2 mix on the CPU: the
port's copies of three flows of `vmn_tpu`'s tests/test_adversarial.py
(test256, N = 5, `SeededSource(f"party{j}")`, `SeededSource(b"encr")`),
with `vmn_tpu`'s assertions.  The board proxies and the flows live in
tests/torch_port_util.py, which chip_smoke.py also runs on the card; the
tampered proof of shuffle is tests/test_torch_k3_slice.py's.

Tolerance: exact equality of plaintexts and bits.
"""

import torch_port_util  # noqa: F401 (torch thread count)
from torch_port_util import (
    adversary_coin_misopen, adversary_garbage_factors, adversary_restart,
)
from vmn_tpu_torch.protocol.mixnet.verifier import FiatShamirVerifier


def test_live_garbage_decryption_factors_isolated(tmp_path):
    """Party 2 publishes well-formed but wrong decryption factors (all
    ones): the combined proof fails, the per-party fallback isolates
    party 2, and the remaining threshold of factors decrypts (reference:
    DistrElGamalSession.java:488-515); CorrectIndices in party 1's
    transcript excludes party 2."""
    msgs, outs, bits = adversary_garbage_factors(tmp_path)
    assert sorted(outs[1].to_ints()) == sorted(msgs)
    assert outs[3].equals(outs[1])
    assert bits[1] == 1 and bits[2] == 0 and bits[3] == 1


def test_live_coinflip_misopen_recovers(tmp_path):
    """Interactive: party 3 mis-opens every coin share; each coin is
    recovered from the remaining threshold of valid shares and the mix
    completes (reference: CoinFlipPRing.java:71)."""
    msgs, outs = adversary_coin_misopen(tmp_path)
    assert sorted(outs[1].to_ints()) == sorted(msgs)
    for j in (2, 3):
        assert outs[j].equals(outs[1])


def test_kill_and_restart_mid_shuffle(tmp_path):
    """Party 2 crashes right after publishing its shuffled ciphertexts
    and restarts with a fresh RandomDevice: its persisted session
    randomness replays byte-identical messages, the board's idempotent
    put accepts them, and the mix completes and verifies (reference:
    PermutationCommitment.java:156-218,
    ShufflerElGamalSession.java:548-663)."""
    msgs, outs, params, nizkp, restarted = adversary_restart(tmp_path)
    assert restarted
    assert sorted(outs[1].to_ints()) == sorted(msgs)
    for j in (2, 3):
        assert outs[j].equals(outs[1])
    assert FiatShamirVerifier(params, nizkp).verify(
        expected_type="mixing").ok

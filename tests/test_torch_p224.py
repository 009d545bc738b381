"""The port's k=1 mix at the NIST curve P-224 (field and ring of L = 14
limbs, computed by the P-256 kernels at the inner width W' = 8) against
`vmn_tpu` on the CPU.

The port's golden mix (the inputs of tools/make_golden.py: P-224, n=3,
`SeededSource(b"golden-party")`, `SeededSource(b"golden-ciphs")`), run
once for the module, rewrites the transcript that `vmn_tpu` wrote
(tests/golden/nizkp_p224_k1, by tests/torch_make_wide_golden.py) byte for
byte (so that `vmn_tpu`'s verifier, which accepted its own transcript
when it wrote it with the 41 test vectors of
tests/golden/test_vectors_p224.json, accepts the port's) and preserves
the plaintext multiset; the kernel wrappers it calls are recorded, and
each is one whose kernel converts at a padded modulus.
The port's verifier on `vmn_tpu`'s transcript is
tests/test_torch_p224_verify.py (a file of its own, so that the test
workers run the two beside each other); the kernel boundary,
the plain versions against `vmn_tpu` and the carry-across of P-224 state
are tests/test_torch_p521_kernels.py, over both padded curves.  On a
CUDA device only (skipped here): the golden mix on the card.

Tolerance: exact equality of bytes.
"""

import pytest

from torch_port_util import (  # noqa: F401 (cuda_device: fixture)
    assert_same_transcript, cuda_device, curve_golden, curve_golden_mix,
    record_calls,
)
from vmn_tpu_torch.ops import mont_kernels as K

GOLDEN, _ = curve_golden("P-224")


@pytest.fixture(scope="module")
def port_mix(tmp_path_factory):
    """The golden mix run by the port on the CPU: (nizkp dir, messages,
    plaintext points, the kernel wrappers' calls in it)."""
    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        record_calls(mp, calls)
        mix = curve_golden_mix("P-224", "cpu",
                               tmp_path_factory.mktemp("port_golden_p224"))
    return (*mix, calls)


def test_port_rewrites_golden_p224_transcript(port_mix):
    assert_same_transcript(port_mix[0], GOLDEN)


def test_port_p224_mix_preserves_plaintext_multiset(port_mix):
    _, msgs, plain, _ = port_mix
    assert sorted(plain) == sorted(msgs)


def test_p224_mix_calls_only_converting_wrappers(port_mix):
    """The kernel wrappers the P-224 golden mix calls, recorded on the
    CPU: products and powers (H1, H2, on the field and the ring), scalar
    multiples (H5) and additions (H8), every one a wrapper whose kernel
    converts at a padded modulus (`CONVERTS`; H6 and the combine, also
    there, take the multi-exponentiations from 2^17 points up).  H3, H4,
    K7's combine and H7, whose wrappers raise at P-224 on the card, are
    not called."""
    calls = port_mix[3]
    assert {"mont_mul", "mont_exp", "ec_scalar_mul", "ec_point_add"} <= set(
        calls) <= K.CONVERTS


def test_p224_exp_clamp_and_exp_prod_floor_match_vmn_tpu(monkeypatch):
    """At 224-bit scalars (14 limbs, 56 digits, 64 digit positions after
    padding): `exp_bits` clamps the bits asked for (a 256-bit ebitlen) to
    the exponent's own limbs as vmn_tpu does (vmn_tpu/arith/ec.py:855-
    863), and `exp_prod` takes H6 with the position combine from
    MULTIEXP_MIN points (lowered to 2 here; below it, the scalar
    multiples and a product tree, vmn_tpu's route on the CPU): both give
    vmn_tpu's affine limbs, with n - 1 and 0 among the scalars."""
    import numpy as np
    from vmn_tpu.arith.ec import ECqPGroup as JGroup

    from torch_port_util import as_np
    from vmn_tpu_torch.arith import ec as TEC

    tg, jg = TEC.ECqPGroup.named("P-224", device="cpu"), JGroup.named("P-224")
    base, ks = [3, 5, 7, 11], [tg.n - 1, 0, (1 << 223) + 5, 12345]
    tp = tg.g.exp(tg.ring.from_ints(base))
    jp = jg.g.exp(jg.ring.from_ints(base))
    te, je = tg.ring.from_ints(ks), jg.ring.from_ints(ks)
    assert te.limbs.shape[-1] == 14 and K._ndig_pad(224) == 64

    def same(t, j):
        for a, b in ((t.x, j.x), (t.y, j.y), (t.inf, j.inf)):
            assert np.array_equal(as_np(a), as_np(np.asarray(b)))

    same(tp.exp_bits(te, 256), jp.exp_bits(je, 256))
    calls = {}
    record_calls(monkeypatch, calls)
    monkeypatch.setattr(TEC, "MULTIEXP_MIN", 2)
    same(tp.exp_prod(te), jp.exp_prod(je))
    assert calls["ec_multiexp_positions"] == calls["ec_multiexp_combine"] == 1


@pytest.mark.parametrize("batch_min", [1 << 30, 1])
def test_p224_random_array_matches_vmn_tpu(monkeypatch, batch_min):
    """Point derivation at P-224 (p = 1 mod 4): the sequential host
    Tonelli-Shanks (below SQRT_BATCH_MIN points) and the batched
    constant-time one on the device (from it; lowered to 1 here) derive
    vmn_tpu's points and leave the PRG where vmn_tpu's leaves it."""
    from vmn_tpu.arith.ec import ECqPGroup as JGroup
    from vmn_tpu.crypto.hash import SHA256 as JSHA
    from vmn_tpu.crypto.prg import PRGHeuristic as JPRG

    from vmn_tpu_torch.arith import ec as TEC
    from vmn_tpu_torch.crypto.hash import SHA256 as TSHA
    from vmn_tpu_torch.crypto.prg import PRGHeuristic as TPRG

    monkeypatch.setattr(TEC, "SQRT_BATCH_MIN", batch_min)
    jprg, tprg = JPRG(JSHA), TPRG(TSHA)
    jprg.set_seed(JSHA.hash(b"p224-points"))
    tprg.set_seed(TSHA.hash(b"p224-points"))
    tg = TEC.ECqPGroup.named("P-224", device="cpu")
    got = tg.random_array(6, tprg, 8)
    want = JGroup.named("P-224").random_array(6, jprg, 8)
    assert got.to_affine() == want.grp.to_affine(want)
    assert tprg.read_bytes(32) == jprg.read_bytes(32)


@pytest.mark.cuda
def test_cuda_p224_golden_mix_rewrites_the_transcript(tmp_path, cuda_device):
    """The golden mix on the card (the P-256 kernels at W' = 8 with the
    boundary conversion): vmn_tpu's transcript, byte for byte."""
    assert_same_transcript(
        curve_golden_mix("P-224", cuda_device, tmp_path)[0], GOLDEN)

"""The port's k=1 mix at the NIST curve P-521 (field and ring of L = 33
limbs, an odd count) against `vmn_tpu` on the CPU.

The port's golden mix (the inputs of tools/make_golden.py: P-521, n=3,
`SeededSource(b"golden-party")`, `SeededSource(b"golden-ciphs")`)
rewrites the transcript that `vmn_tpu` wrote (tests/golden/nizkp_p521_k1,
by tests/torch_make_wide_golden.py) byte for byte, preserves the
plaintext multiset, and `vmn_tpu`'s verifier accepts the port's
transcript with the 41 test vectors of tests/golden/test_vectors_p521.json.
The port's verifier on `vmn_tpu`'s transcript is
tests/test_torch_p521_verify.py (a file of its own, so that the test
workers run the two beside each other); the kernels are
tests/test_torch_p521_kernels.py.  On a CUDA device only (skipped here):
the golden mix on the card.

Tolerance: exact equality of bytes.
"""

import json

import pytest

from torch_port_util import (  # noqa: F401 (cuda_device: fixture)
    TV_NAMES, assert_same_transcript, cuda_device, curve_golden,
    curve_golden_mix,
)

GOLDEN, TV_FILE = curve_golden("P-521")


def _same_transcript(nizkp) -> None:
    assert_same_transcript(nizkp, GOLDEN)


@pytest.fixture(scope="module")
def port_mix(tmp_path_factory):
    """The golden mix run by the port on the CPU (about 130 s of plain
    521-bit scalar multiples)."""
    return curve_golden_mix("P-521", "cpu",
                            tmp_path_factory.mktemp("port_golden_p521"))


def test_port_rewrites_golden_p521_transcript(port_mix):
    _same_transcript(port_mix[0])


def test_port_p521_mix_preserves_plaintext_multiset(port_mix):
    _, msgs, plain = port_mix
    assert sorted(plain) == sorted(msgs)


def test_vmn_tpu_verifier_accepts_port_p521_transcript(port_mix):
    """vmn_tpu's verifier on the port's transcript: accepted, with the 41
    test vectors it froze for its own."""
    from vmn_tpu.arith.ec import ECqPGroup
    from vmn_tpu.protocol.context import ProtocolParams
    from vmn_tpu.protocol.mixnet.verifier import FiatShamirVerifier

    params = ProtocolParams(sid="Golden", k=1, threshold=1,
                            pgroup=ECqPGroup.named("P-521"))
    v = FiatShamirVerifier(params, port_mix[0], test_vectors=TV_NAMES)
    assert v.verify(expected_type="mixing").ok
    want = json.loads(TV_FILE.read_text())
    assert len(want) == 41 and v.tv == want


@pytest.mark.cuda
def test_cuda_p521_golden_mix_rewrites_the_transcript(tmp_path, cuda_device):
    """The golden mix on the card (the kernels at W' = 20): vmn_tpu's
    transcript, byte for byte."""
    _same_transcript(curve_golden_mix("P-521", cuda_device, tmp_path)[0])

"""The port's verifier at the NIST curve P-521 on the transcript that
`vmn_tpu` wrote (tests/golden/nizkp_p521_k1, by
tests/torch_make_wide_golden.py), on the CPU: accepted, with the 41 test
vectors of tests/golden/test_vectors_p521.json, and rejected with one
flipped reply byte.  (The port's own mix at P-521 is
tests/test_torch_p521.py.)
"""

import json

from torch_port_util import (
    TV_NAMES, curve_golden, curve_params, flipped_reply_copy,
)

GOLDEN, TV_FILE = curve_golden("P-521")


def _params():
    return curve_params("P-521")


def test_port_verifier_accepts_vmn_tpu_p521_transcript():
    from vmn_tpu_torch.protocol.mixnet.verifier import FiatShamirVerifier

    v = FiatShamirVerifier(_params(), GOLDEN, test_vectors=TV_NAMES)
    assert v.verify(expected_type="mixing").ok
    want = json.loads(TV_FILE.read_text())
    assert len(want) == 41 and v.tv == want


def test_port_verifier_rejects_flipped_p521_reply_byte(tmp_path):
    from vmn_tpu_torch.protocol.mixnet.verifier import FiatShamirVerifier

    nizkp = flipped_reply_copy(GOLDEN, tmp_path / "nizkp")
    assert not FiatShamirVerifier(_params(), nizkp).verify(
        expected_type="mixing").ok

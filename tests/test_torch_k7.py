"""`vmn_tpu`'s check-matrix configuration of seven mix-servers with
threshold 4 (tests/test_matrix.py's `thresholdlarge`; the reference's
demo/mixnet/.checkbaseconf NO_MIXSERVERS=7 THRESHOLD=4) run by the port
on the CPU and held to the golden `vmn_tpu` wrote for it
(tests/torch_make_wide_golden.py "test256-k7t4", party 1's
transcript): the checks of tests/test_torch_matrix.py, in a file of
their own so that the longest mix has a test worker to itself.

Tolerance: exact equality of every byte, plaintext and test vector.
"""

import pytest

from test_torch_matrix import (  # noqa: F401 (the same checks, collected here)
    run_matrix, test_matrix_parties_agree_and_preserve_the_multiset,
    test_port_rewrites_matrix_golden,
    test_port_verifier_accepts_vmn_tpu_matrix_golden,
    test_port_verifier_rejects_flipped_matrix_reply,
    test_vmn_tpu_verifies_port_matrix_transcript,
)


@pytest.fixture(scope="module")
def matrix_run(tmp_path_factory):
    return run_matrix("test256-k7t4", tmp_path_factory)

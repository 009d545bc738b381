"""The port's verifier on the modp4096 golden transcript that `vmn_tpu`
wrote (tests/torch_make_wide_golden.py): accepted with `vmn_tpu`'s test
vectors, and rejected with one byte of the full public key changed.  Its
own file, beside tests/test_torch_wide.py's modp3072 case, so that
pytest-xdist's `--dist loadfile` gives the longer verify its own worker.

Tolerance: exact equality of the test vectors.
"""

from test_torch_wide import verify_wide_golden


def test_port_verifier_accepts_vmn_tpu_modp4096_golden(tmp_path):
    verify_wide_golden("modp4096", tmp_path)

"""The port at RFC 3526's modp6144 (§6, group 17: W = 192 words, L = 384
limbs), on the CPU.

* The group file tests/golden/group_modp6144.json holds the RFC's prime,
  p = 2^b - 2^(b-64) - 1 + 2^64 (floor(2^(b-130) pi) + c), and the same
  formula gives vmn_tpu's three named RFC 3526 primes (modp2048,
  modp3072, modp4096).
* The slice: the port's verifier accepts the modp6144 golden transcript
  that `vmn_tpu` wrote (tests/torch_make_wide_golden.py), writes its
  test vectors, and rejects it with the full public key's generator
  changed (tests/test_torch_wide.py's `verify_wide_golden`).  Its own
  file, so that pytest-xdist's `--dist loadfile` gives the long verify
  its own worker.  modp8192's verify runs on the card
  (tests/test_torch_wide_8192.py).

Tolerance: exact equality of integers and test vectors.
"""

import pytest

from test_torch_wide import verify_wide_golden
from torch_make_wide_golden import RFC3526, RFC3526_NAMED, rfc3526_prime
from torch_port_util import group_file


def test_rfc3526_formula_gives_vmn_tpu_named_primes():
    from vmn_tpu.arith.pgroup import _NAMED_GROUPS

    for name, (b, c) in RFC3526_NAMED.items():
        assert rfc3526_prime(b, c) == _NAMED_GROUPS[name][0], name


@pytest.mark.parametrize("name", list(RFC3526))
def test_group_file_is_the_rfc_prime(name):
    b, c, source = RFC3526[name]
    f = group_file(name)
    assert f["p"] == rfc3526_prime(b, c)
    assert f["p"].bit_length() == f["bits"] == b
    assert f["q"] == (f["p"] - 1) // 2 and f["g"] == 4
    assert f["source"] == source
    assert hex(f["p"]).startswith("0xffffffffffffffffc90fdaa22168c234")
    assert f["p"] & ((1 << 64) - 1) == (1 << 64) - 1


def test_port_verifier_accepts_vmn_tpu_modp6144_golden(tmp_path):
    verify_wide_golden("modp6144", tmp_path)

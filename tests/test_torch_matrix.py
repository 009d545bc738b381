"""Three configurations of `vmn_tpu`'s check matrix (tests/test_matrix.py,
the reference's demo/mixnet/check) run by the port on the CPU and held
to the goldens `vmn_tpu` wrote for them
(tests/torch_make_wide_golden.py: "test256-kw2", keywidth 2;
"test256-kw2w2", keywidth 2 with width 2; "test256-prov", PRGElGamal
batching vectors and the Pedersen random-oracle hash), each with
test_matrix.py's `_run_mix` inputs (test256, N = 5,
`SeededSource(f"party{j}")`, `SeededSource(b"ciphertexts")`, auxsid
"mx"): the port rewrites party 1's transcript byte for byte, its
verifier accepts `vmn_tpu`'s transcript and writes `vmn_tpu`'s test
vectors, `vmn_tpu`'s verifier accepts the port's transcript, and a
flipped byte is rejected.  tests/test_torch_k7.py runs the same checks
at k = 7, t = 4.

Tolerance: exact equality of every byte, plaintext and test vector.
"""

import json

import pytest

import torch_make_wide_golden as W
import torch_port_util  # noqa: F401 (torch thread count)
from torch_port_util import (
    GOLDEN, TV_NAMES, assert_same_transcript, first_leaf, flipped_reply_copy,
    matrix_mix, matrix_params,
)
from vmn_tpu_torch.protocol.mixnet.verifier import FiatShamirVerifier

K1_CONFIGS = ("test256-kw2", "test256-kw2w2", "test256-prov")


def run_matrix(name: str, tmp_path_factory) -> dict:
    """The port's mix of check-matrix configuration `name` on the CPU,
    and the port's verifier on `vmn_tpu`'s golden transcript of it."""
    params, width = matrix_params(name)
    msgs, outs, nizkp = matrix_mix(
        tmp_path_factory.mktemp(name.replace("-", "_")), params, width)
    golden, tv_file = (GOLDEN / f for f in W.fixture_names(name))
    verifier = FiatShamirVerifier(params, golden, test_vectors=TV_NAMES)
    res = verifier.verify(expected_type="mixing")
    return {"name": name, "params": params, "width": width, "msgs": msgs,
            "outs": outs, "nizkp": nizkp, "golden": golden,
            "tv_file": tv_file, "ok": res.ok, "res_width": res.width,
            "tv": verifier.tv}


@pytest.fixture(scope="module", params=K1_CONFIGS)
def matrix_run(request, tmp_path_factory):
    return run_matrix(request.param, tmp_path_factory)


def test_port_rewrites_matrix_golden(matrix_run):
    assert_same_transcript(matrix_run["nizkp"], matrix_run["golden"])


def test_port_verifier_accepts_vmn_tpu_matrix_golden(matrix_run):
    """The port's verifier on `vmn_tpu`'s transcript: accepted, at the
    run's width, with `vmn_tpu`'s test vectors."""
    assert matrix_run["ok"]
    assert matrix_run["res_width"] == matrix_run["width"]
    want = json.loads(matrix_run["tv_file"].read_text())
    assert matrix_run["tv"] == want


def test_matrix_parties_agree_and_preserve_the_multiset(matrix_run):
    outs = matrix_run["outs"]
    assert sorted(first_leaf(outs[1]).to_ints()) == sorted(matrix_run["msgs"])
    for j in range(2, matrix_run["params"].k + 1):
        assert outs[j].equals(outs[1])


def test_vmn_tpu_verifies_port_matrix_transcript(matrix_run):
    """`vmn_tpu`'s verifier, with `vmn_tpu`'s parameters of the same
    configuration, accepts the transcript the port wrote."""
    from vmn_tpu.arith.pgroup import ModPGroup
    from vmn_tpu.protocol.context import ProtocolParams
    from vmn_tpu.protocol.mixnet.verifier import (
        FiatShamirVerifier as JVerifier,
    )

    kw, _ = W.MATRIX[matrix_run["name"]]
    params = ProtocolParams(pgroup=ModPGroup.named("test256"), **kw)
    res = JVerifier(params, matrix_run["nizkp"]).verify(
        expected_type="mixing")
    assert res.ok and res.width == matrix_run["width"]


def test_port_verifier_rejects_flipped_matrix_reply(matrix_run, tmp_path):
    bad = flipped_reply_copy(matrix_run["golden"], tmp_path / "bad")
    assert not FiatShamirVerifier(matrix_run["params"], bad).verify(
        expected_type="mixing").ok

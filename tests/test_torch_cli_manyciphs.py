"""Port copy of tests/test_cli.py::test_manyciphs_cli_e2e: N=10^4
through the port's CLI on the CPU at test256 (reference: `manyciphs`
config, .checkbaseconf NO_CIPHERTEXTS=10000).  It stands in a file of
its own so that the test workers run it beside tests/test_torch_cli.py;
it takes about four minutes here, nearly all of it the plain PyTorch
Montgomery products of the mix and the verify.
"""

import os

import pytest

import torch_port_util  # noqa: F401 (torch thread count)
from test_torch_cli import GROUP, _cli, _cli_protinfo
from vmn_tpu_torch.cli import vmn, vmnd, vmnv


@pytest.mark.skipif(os.environ.get("VMN_SKIP_SLOW") == "1",
                    reason="slow N=10^4 config")
def test_manyciphs_cli_e2e(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _cli_protinfo(tmp_path)
    assert _cli(vmn, ["-keygen", "privInfo.xml", "protInfo.xml",
                      "publicKey.bt"]) == 0
    assert _cli(vmnd, ["-ciphs", "publicKey.bt", "ciphertexts.bt",
                       "-N", "10000", "-pgroup", GROUP]) == 0
    assert _cli(vmn, ["-mix", "privInfo.xml", "protInfo.xml",
                      "ciphertexts.bt", "plaintexts.bt"]) == 0
    nizkp = str(tmp_path / "p1" / "nizkp.default")
    assert _cli(vmnv, ["protInfo.xml", nizkp, "-mix"]) == 0

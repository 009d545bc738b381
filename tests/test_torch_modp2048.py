"""modp2048 across the packages: the k=1 golden mix of
tools/make_golden.py (its seeds b"golden-party" and b"golden-ciphs",
five messages) over RFC 3526's 2048-bit group, run by the port on the
CPU and held to the golden `vmn_tpu` wrote
(tests/torch_make_wide_golden.py "modp2048": nizkp_modp2048_k1,
test_vectors_modp2048.json): the port rewrites the transcript byte for
byte, its verifier accepts `vmn_tpu`'s transcript and writes its test
vectors, and `vmn_tpu`'s verifier accepts the port's.

Tolerance: exact equality of every byte, plaintext and test vector.
"""

import json

import pytest

import torch_make_wide_golden as W
import torch_port_util  # noqa: F401 (torch thread count)
from torch_port_util import GOLDEN, TV_NAMES, assert_same_transcript, messages
from vmn_tpu_torch.arith.pgroup import ModPGroup
from vmn_tpu_torch.crypto.randomsource import SeededSource
from vmn_tpu_torch.protocol import elgamal
from vmn_tpu_torch.protocol.com.board import LocalBoardHub
from vmn_tpu_torch.protocol.context import ProtocolParams
from vmn_tpu_torch.protocol.mixnet.party import MixNetParty
from vmn_tpu_torch.protocol.mixnet.verifier import FiatShamirVerifier

NIZKP, TVS = (GOLDEN / f for f in W.fixture_names("modp2048"))
N = 5


@pytest.fixture(scope="module")
def port_mix(tmp_path_factory):
    """The golden mix by the port (nizkp dir, messages, plaintexts), and
    the port's verifier on `vmn_tpu`'s transcript (accepted, vectors)."""
    out = tmp_path_factory.mktemp("port_modp2048")
    params = ProtocolParams(sid="Golden", k=1, threshold=1,
                            pgroup=ModPGroup.named("modp2048", device="cpu"))
    group = params.pgroup
    party = MixNetParty(params, LocalBoardHub(1).board(1),
                        SeededSource(b"golden-party"), str(out))
    pk = party.keygen()
    msgs = messages(group, N)
    r = group.ring.random((N,), SeededSource(b"golden-ciphs"), 0)
    ciphs = elgamal.encrypt(pk, group.from_ints(msgs), r)
    party.board = LocalBoardHub(1).board(1)
    plain = party.session("golden", 1).mix(ciphs)
    verifier = FiatShamirVerifier(params, NIZKP, test_vectors=TV_NAMES)
    ok = verifier.verify(expected_type="mixing").ok
    return out / "nizkp.golden", msgs, plain.to_ints(), ok, verifier.tv


def test_port_rewrites_modp2048_golden(port_mix):
    assert_same_transcript(port_mix[0], NIZKP)


def test_port_modp2048_mix_preserves_the_multiset(port_mix):
    assert sorted(port_mix[2]) == sorted(port_mix[1])


def test_port_verifier_accepts_vmn_tpu_modp2048_golden(port_mix):
    assert port_mix[3]
    assert port_mix[4] == json.loads(TVS.read_text())


def test_vmn_tpu_verifies_port_modp2048_transcript(port_mix):
    from vmn_tpu.arith.pgroup import ModPGroup as JG
    from vmn_tpu.protocol.context import ProtocolParams as JParams
    from vmn_tpu.protocol.mixnet.verifier import (
        FiatShamirVerifier as JVerifier,
    )

    params = JParams(sid="Golden", k=1, threshold=1,
                     pgroup=JG.named("modp2048"))
    assert JVerifier(params, port_mix[0]).verify(expected_type="mixing").ok

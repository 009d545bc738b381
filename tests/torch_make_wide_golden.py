"""Write the golden fixtures of the port's tests with vmn_tpu.

The k=1 golden mix of tools/make_golden.py (its seeds b"golden-party"
and b"golden-ciphs") on the CPU: five messages over RFC 3526 modp3072
and modp4096, three over the NIST curves P-224, P-384 and P-521.  The
transcript goes to tests/golden/nizkp_{modp3072,modp4096,p224,p384,p521}_k1
and the verifier's test vectors (the same TV_NAMES) to
tests/golden/test_vectors_{modp3072,modp4096,p224,p384,p521}.json.
tests/test_torch_wide.py, tests/test_torch_wide_4096.py,
tests/test_torch_p224.py, tests/test_torch_p384.py and
tests/test_torch_p521.py hold the port to them on the CPU, and
chip_smoke.py's golden phase rewrites them byte for byte on the card.

Two more fixtures over P-224 with three mix-servers, threshold 2:
"P-224-k3", the k=3 golden mix of tools/make_golden.py (seeds
b"golden-party{j}" and b"golden-ciphs", width 1, three messages) to
tests/golden/nizkp_p224_k3 and test_vectors_p224_k3.json; and
"P-224-coins", the jointly flipped coins of vmn_tpu's EC coin-flipping
test (tests/test_mixnet_ec.py: session "ECCoin", interactive, seeds
b"ec{j}", eight coin bytes) to tests/golden/coinflip_p224_k3.json.
tests/test_torch_p224_k3.py holds the port to both.

Two fresh groups, as `vog -gen ModPGroup -bitlen n` makes them:
"vog1024" and "vog1000", vmn_tpu's `random_group` of 1024 and 1000 bits
from SeededSource(b"golden-group-1024") and (b"golden-group-1000") (a
1000-bit p has 63 limbs, an odd count), each with the k=1 golden mix
above (five messages) to tests/golden/nizkp_vog{1024,1000}_k1 and
test_vectors_vog{1024,1000}.json, and the group (p, q, g in hex, the
seed and the bit length) to tests/golden/group_vog{1024,1000}.json.
tests/test_torch_vog_groups.py holds the port to them.

Two RFC 3526 groups past 4096 bits: "modp6144" (section 6, group 17) and
"modp8192" (section 7, group 18), p from the RFC's formula
p = 2^b - 2^(b-64) - 1 + 2^64 (floor(2^(b-130) pi) + c), q = (p - 1)/2
and g = 4 as in vmn_tpu's named RFC 3526 groups, each with the k=1
golden mix above (five messages) to tests/golden/nizkp_modp{6144,8192}_k1
and test_vectors_modp{6144,8192}.json, and the group (p, q, g in hex, the
RFC's section and the bit length) to tests/golden/group_modp{6144,8192}.json.
tests/test_torch_wide_6144.py holds the port to the first on the CPU,
tests/test_torch_wide_8192.py to the second on a CUDA device.

Five configurations of vmn_tpu's check matrix (tests/test_matrix.py,
which mirrors the reference's demo/mixnet/check), each run with
test_matrix.py's `_run_mix` and its inputs (SeededSource(f"party{j}"),
SeededSource(b"ciphertexts"), five messages, auxsid "mx"):
"test256-kw2" (keywidth 2, session id "KW2"), "test256-kw2w2" (keywidth
2 and width 2, "KW32"), "test256-k7t4" (seven mix-servers, threshold 4,
"K7": party 1's transcript) and "test256-prov" (the provable
primitives: PRGElGamal "elgamal:test256:4:64" and the Pedersen random
oracle hash "pedersen:test256", "Prov"), each to
tests/golden/nizkp_test256_{kw2,kw2w2,k7t4,prov} and
test_vectors_test256_{kw2,kw2w2,k7t4,prov}.json; and "modp2048", the
k=1 golden mix above over RFC 3526's 2048-bit group, to
tests/golden/nizkp_modp2048_k1 and test_vectors_modp2048.json.
tests/test_torch_matrix.py and tests/test_torch_k7.py hold the port to
them on the CPU, and chip_smoke.py's golden phase rewrites them byte
for byte on the card.

Usage (from the repo root; minutes on one CPU core's worth of a
recent x86 server: about 2 for the two ModP groups, 1 for P-224, 1.5
for P-384, 2 for P-521, 1.5 for P-224-k3 and P-224-coins together, 1.5
for vog1024 and vog1000 together, their safe-prime searches included,
3 for modp6144, 7 for modp8192, 1 for the three test256 k=1 matrix
goldens together, 1 for test256-k7t4 and 1 for modp2048):
    JAX_PLATFORMS=cpu python tests/torch_make_wide_golden.py [GROUP ...]
"""

import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden"
# The check-matrix goldens: name -> (ProtocolParams' keywords, width),
# as tests/test_matrix.py runs them.
MATRIX = {
    "test256-kw2": (dict(sid="KW2", k=1, threshold=1, keywidth=2), 1),
    "test256-kw2w2": (dict(sid="KW32", k=1, threshold=1, keywidth=2), 2),
    "test256-k7t4": (dict(sid="K7", k=7, threshold=4), 1),
    "test256-prov": (dict(sid="Prov", k=1, threshold=1,
                          prg_name="elgamal:test256:4:64",
                          rohash_name="pedersen:test256"), 1),
}
GROUPS = ("modp3072", "modp4096", "P-224", "P-384", "P-521", "P-224-k3",
          "P-224-coins", "vog1024", "vog1000", "modp6144", "modp8192",
          *MATRIX, "modp2048")
# The fresh groups: name -> (bits, seed of vmn_tpu's random_group).
VOG = {"vog1024": (1024, b"golden-group-1024"),
       "vog1000": (1000, b"golden-group-1000")}
# The RFC 3526 groups past 4096 bits: name -> (b, c, the RFC's section);
# the three of vmn_tpu (RFC3526_NAMED) check the formula.
RFC3526 = {"modp6144": (6144, 929484, "RFC 3526 §6 (group 17)"),
           "modp8192": (8192, 4743158, "RFC 3526 §7 (group 18)")}
RFC3526_NAMED = {"modp2048": (2048, 124476), "modp3072": (3072, 1690314),
                 "modp4096": (4096, 240904)}
# The coin-flipping run of vmn_tpu's tests/test_mixnet_ec.py.
COIN_SID, COIN_K, COIN_T, COIN_BYTES = "ECCoin", 3, 2, 8
COINS_FILE = "coinflip_p224_k3.json"


def fixture_names(group: str):
    """(transcript directory, test-vector file) of a golden: "P-224-k3"
    is the k=3, t=2 mix over P-224, a MATRIX name its configuration's
    mix, every other name a k=1 mix."""
    if group in MATRIX:
        tag = group.replace("-", "_")
        return f"nizkp_{tag}", f"test_vectors_{tag}.json"
    if group.endswith("-k3"):
        tag = group[:-3].replace("-", "").lower()
        return f"nizkp_{tag}_k3", f"test_vectors_{tag}_k3.json"
    tag = group.replace("-", "").lower()
    return f"nizkp_{tag}_k1", f"test_vectors_{tag}.json"


def group_file(name: str) -> str:
    """The file of a fresh group's p, q, g (tests/golden/)."""
    return f"group_{name}.json"


def vog_group(name: str):
    """vmn_tpu's fresh group `name` (VOG), registered under that name
    with vmn_tpu's ModPGroup.named, as tools.make_golden.generate looks
    its groups up; its p, q, g written to tests/golden/group_{name}.json."""
    from vmn_tpu.arith.pgroup import ModPGroup
    from vmn_tpu.crypto.primes import random_group
    from vmn_tpu.crypto.randomsource import SeededSource

    bits, seed = VOG[name]
    grp = random_group(bits, SeededSource(seed))
    ModPGroup._NAMED[name] = grp
    (GOLDEN / group_file(name)).write_text(json.dumps(
        {"p": hex(grp.p), "q": hex(grp.q), "g": hex(grp.g_int),
         "seed": seed.decode(), "bits": bits}, indent=1) + "\n")
    return grp


def rfc3526_prime(b: int, c: int) -> int:
    """RFC 3526's MODP prime of b bits:
    2^b - 2^(b-64) - 1 + 2^64 (floor(2^(b-130) pi) + c)."""
    import mpmath

    with mpmath.workprec(b + 64):
        frac = int(mpmath.floor(mpmath.ldexp(mpmath.pi, b - 130)))
    return (1 << b) - (1 << (b - 64)) - 1 + (1 << 64) * (frac + c)


def rfc_group(name: str):
    """vmn_tpu's ModPGroup over the RFC 3526 group `name` (RFC3526),
    registered under that name with vmn_tpu's ModPGroup.named; the
    formula is first held to vmn_tpu's three named RFC 3526 primes and p
    and q = (p - 1)/2 to Miller-Rabin.  Its p, q, g are written to
    tests/golden/group_{name}.json."""
    from vmn_tpu.arith.pgroup import _NAMED_GROUPS, ModPGroup
    from vmn_tpu.crypto.primes import miller_rabin
    from vmn_tpu.crypto.randomsource import SeededSource

    for named, (b, c) in RFC3526_NAMED.items():
        assert rfc3526_prime(b, c) == _NAMED_GROUPS[named][0], named
    b, c, source = RFC3526[name]
    p = rfc3526_prime(b, c)
    q, g = (p - 1) // 2, 4
    rs = SeededSource(f"rfc3526-{b}".encode())
    assert p.bit_length() == b
    assert miller_rabin(p, rs, 8) and miller_rabin(q, rs, 8), name
    grp = ModPGroup(p, q, g)
    ModPGroup._NAMED[name] = grp
    (GOLDEN / group_file(name)).write_text(json.dumps(
        {"p": hex(p), "q": hex(q), "g": hex(g), "source": source,
         "bits": b}, indent=1) + "\n")
    return grp


def write_coins(path: Path) -> None:
    """vmn_tpu's coins of the EC coin-flipping run, as hex, to `path`."""
    from torch_port_util import run_parties
    from vmn_tpu.arith.ec import ECqPGroup
    from vmn_tpu.crypto.randomsource import SeededSource
    from vmn_tpu.protocol.coinflip import CoinFlipPRingSource
    from vmn_tpu.protocol.com.board import LocalBoardHub
    from vmn_tpu.protocol.context import ProtocolContext, ProtocolParams

    params = ProtocolParams(sid=COIN_SID, k=COIN_K, threshold=COIN_T,
                            noninteractive=False,
                            pgroup=ECqPGroup.named("P-224"))
    hub = LocalBoardHub(COIN_K)

    def flip(j):
        src = CoinFlipPRingSource(ProtocolContext(params), hub.board(j),
                                  SeededSource(f"ec{j}".encode()))
        return src.coin_bytes(COIN_BYTES)

    coins = run_parties(COIN_K, flip)[1:]
    assert len(set(coins)) == 1, coins
    path.write_text(json.dumps({"coins": coins[0].hex()}, indent=1) + "\n")


def matrix_golden(name: str, tmp: Path):
    """vmn_tpu's mix of the check-matrix configuration `name` (MATRIX)
    with tests/test_matrix.py's `_run_mix`: (party 1's transcript, the
    verifier's test vectors on it)."""
    from test_matrix import _run_mix
    from tools.make_golden import TV_NAMES
    from vmn_tpu.arith.pgroup import ModPGroup
    from vmn_tpu.protocol.context import ProtocolParams
    from vmn_tpu.protocol.mixnet.verifier import FiatShamirVerifier

    kw, width = MATRIX[name]
    params = ProtocolParams(pgroup=ModPGroup.named("test256"), **kw)
    _, _, nizkp = _run_mix(tmp, params, width)
    v = FiatShamirVerifier(params, nizkp, test_vectors=TV_NAMES)
    assert v.verify(expected_type="mixing").ok
    return nizkp, v.tv


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    from tools.make_golden import generate

    for group in argv or GROUPS:
        if group not in GROUPS:
            raise SystemExit(f"unknown group {group}; one of {GROUPS}")
        if group == "P-224-coins":
            write_coins(GOLDEN / COINS_FILE)
            print(f"wrote {COINS_FILE}")
            continue
        if group in VOG:
            vog_group(group)
        if group in RFC3526:
            rfc_group(group)
        dirname, tvname = fixture_names(group)
        kw = {"k": 3, "threshold": 2} if group.endswith("-k3") else {}
        with tempfile.TemporaryDirectory() as tmp:
            if group in MATRIX:
                nizkp, tv = matrix_golden(group, Path(tmp))
            else:
                nizkp, tv = generate(Path(tmp), group.removesuffix("-k3"),
                                     **kw)
            dest = GOLDEN / dirname
            if dest.exists():
                shutil.rmtree(dest)
            shutil.copytree(nizkp, dest)
            (GOLDEN / tvname).write_text(
                json.dumps(tv, indent=1, sort_keys=True) + "\n")
        print(f"wrote {dest} and {tvname} ({len(tv)} vectors)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

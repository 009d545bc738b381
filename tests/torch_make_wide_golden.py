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

One group past RFC 3526, at NIST SP 800-57's 256-bit strength:
"ffc15360", p = c*q + 1 of exactly 15360 bits with q prime of 15328 bits
and c even below 2^32 (inside vmn_tpu's 64-bit co-order exponent), from
a seeded search (SHA-256 in counter mode over b"ffc15360" draws q's
start; q and then c step up past a sieve of the primes below 2^16 and
`openssl prime` where openssl is on PATH; vmn_tpu's miller_rabin
confirms p and q), g = h^c mod p for the smallest h >= 2 that gives
g != 1.  Its k=1 golden mix takes make_golden's seeds but five messages
from `random_array` (PRGHeuristic over SHA-256 of b"golden-msgs"):
`encode_message` is the safe-prime encoding and can give a non-member
at c > 2.  To tests/golden/nizkp_ffc15360_k1, test_vectors_ffc15360.json
and group_ffc15360.json (p, q, g, c, h in hex, the seed, the source).
"ffc1024" is the same shape at 1024 bits (q of 992), the same search and
golden from the seed b"ffc1024": tests/test_torch_wide_15360.py holds the
port to it on the CPU and to ffc15360's on a CUDA device.

Usage (from the repo root; minutes on one CPU core's worth of a
recent x86 server: about 2 for the two ModP groups, 1 for P-224, 1.5
for P-384, 2 for P-521, 1.5 for P-224-k3 and P-224-coins together, 1.5
for vog1024 and vog1000 together, their safe-prime searches included,
3 for modp6144, 7 for modp8192, 1 for the three test256 k=1 matrix
goldens together, 1 for test256-k7t4 and 1 for modp2048, and for
ffc15360 about 10 for the search and 50 for its golden, the mix about
20 and the verifier writing its test vectors about 30, and for ffc1024
half a minute):
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
          *MATRIX, "modp2048", "ffc15360", "ffc1024")
# The fresh groups: name -> (bits, seed of vmn_tpu's random_group).
VOG = {"vog1024": (1024, b"golden-group-1024"),
       "vog1000": (1000, b"golden-group-1000")}
# The RFC 3526 groups past 4096 bits: name -> (b, c, the RFC's section);
# the three of vmn_tpu (RFC3526_NAMED) check the formula.
RFC3526 = {"modp6144": (6144, 929484, "RFC 3526 §6 (group 17)"),
           "modp8192": (8192, 4743158, "RFC 3526 §7 (group 18)")}
RFC3526_NAMED = {"modp2048": (2048, 124476), "modp3072": (3072, 1690314),
                 "modp4096": (4096, 240904)}
# The seeded groups p = c*q + 1: name -> (bits of p, bits of q, the
# search's seed, source).
FFC = {"ffc15360": (15360, 15328, b"ffc15360",
                    "NIST SP 800-57 Pt1 Rev5 Table 2: FFC L=15360 (256-bit "
                    "strength); p = c*q + 1, seeded search"),
       "ffc1024": (1024, 992, b"ffc1024",
                   "ffc15360's shape (p = c*q + 1, c even below 2^32) at "
                   "1024 bits, seeded search: the CPU tests' stand-in")}
# Probable-prime tests run at once in the search (openssl processes).
PRIME_BATCH = 6
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


def _first_prime(xs, rs):
    """The first of the sieved candidates `xs` that a probable-prime test
    passes, and how many were tested: `openssl prime` in PRIME_BATCH
    processes at a time where openssl is on PATH (a 15360-bit composite
    costs it about a second, a Python pow eight), else one round of
    vmn_tpu's miller_rabin.  The order of `xs` decides, so the search is
    reproducible."""
    import itertools
    import subprocess

    from vmn_tpu.crypto.primes import miller_rabin

    openssl = shutil.which("openssl")
    xs, tested = iter(xs), 0
    while True:
        chunk = list(itertools.islice(xs, PRIME_BATCH))
        if not chunk:
            raise ValueError("candidates exhausted")
        if openssl:
            procs = [subprocess.Popen([openssl, "prime", "-hex", f"{x:x}"],
                                      stdout=subprocess.PIPE, text=True)
                     for x in chunk]
            prime = [" is prime" in p.communicate()[0] for p in procs]
        else:
            prime = [miller_rabin(x, rs, 1) for x in chunk]
        for i, (x, ok) in enumerate(zip(chunk, prime)):
            if ok:
                return x, tested + i + 1
        tested += len(chunk)


def ffc_group(name: str):
    """vmn_tpu's ModPGroup over the seeded group `name` (FFC), registered
    under that name with vmn_tpu's ModPGroup.named; p, q, g, c, h, the
    seed and the source are written to tests/golden/group_{name}.json."""
    import hashlib
    import itertools
    import math

    from vmn_tpu.arith.pgroup import ModPGroup
    from vmn_tpu.crypto.primes import _small_primes, miller_rabin
    from vmn_tpu.crypto.randomsource import SeededSource

    bits, qbits, seed, source = FFC[name]
    rs = SeededSource(seed)
    sieve = math.prod(int(s) for s in _small_primes())
    nbytes = (qbits + 7) // 8
    stream = b"".join(hashlib.sha256(seed + i.to_bytes(8, "big")).digest()
                      for i in range(-(-nbytes // 32)))
    # q's two top bits set, so every even c from the least that gives p
    # its `bits` bits stays below 2^(bits - qbits).
    start = (int.from_bytes(stream[:nbytes], "big") >> (8 * nbytes - qbits)
             | 3 << (qbits - 2) | 1)
    q, nq = _first_prime((x for x in itertools.count(start, 2)
                          if math.gcd(x, sieve) == 1), rs)
    c0 = -(-(1 << (bits - 1)) // q)
    c0 += c0 & 1
    p, np_ = _first_prime(
        (p for p in range(c0 * q + 1, (q << (bits - qbits)) + 1, 2 * q)
         if math.gcd(p, sieve) == 1), rs)
    c = (p - 1) // q
    assert p.bit_length() == bits and c % 2 == 0 and c < 1 << 32
    assert miller_rabin(q, rs, 8) and miller_rabin(p, rs, 8), name
    h = next(h for h in itertools.count(2) if pow(h, c, p) != 1)
    g = pow(h, c, p)
    print(f"{name}: q after {nq} tests, c = {c} after {np_}, h = {h}")
    grp = ModPGroup(p, q, g)
    ModPGroup._NAMED[name] = grp
    (GOLDEN / group_file(name)).write_text(json.dumps(
        {"p": hex(p), "q": hex(q), "g": hex(g), "c": hex(c), "h": hex(h),
         "seed": seed.decode(), "source": source, "bits": bits},
        indent=1) + "\n")
    return grp


def ffc_golden(outdir: Path, name: str):
    """make_golden's k=1 mix (its session id, seeds and five messages)
    over the seeded group `name`, the messages from `random_array`:
    (the transcript, the verifier's test vectors on it)."""
    from tools.make_golden import TV_NAMES
    from vmn_tpu.arith.pgroup import ModPGroup
    from vmn_tpu.crypto.hash import SHA256
    from vmn_tpu.crypto.prg import PRGHeuristic
    from vmn_tpu.crypto.randomsource import SeededSource
    from vmn_tpu.protocol import elgamal
    from vmn_tpu.protocol.com.board import LocalBoardHub
    from vmn_tpu.protocol.context import ProtocolParams
    from vmn_tpu.protocol.mixnet.party import MixNetParty
    from vmn_tpu.protocol.mixnet.verifier import FiatShamirVerifier

    group = ModPGroup.named(name)
    params = ProtocolParams(sid="Golden", k=1, threshold=1, pgroup=group)
    party = MixNetParty(params, LocalBoardHub(1).board(1),
                        SeededSource(b"golden-party"), str(outdir))
    party.keygen()
    pk = party.full_public_key()
    prg = PRGHeuristic(SHA256)
    prg.set_seed(SHA256.hash(b"golden-msgs"))
    m = group.random_array(5, prg, params.rbitlen)
    r = group.ring.random((5,), SeededSource(b"golden-ciphs"), 0)
    ciphs = elgamal.encrypt(pk, m, r)
    party.board = LocalBoardHub(1).board(1)
    out = party.session("golden", 1).mix(ciphs)
    assert sorted(out.to_ints()) == sorted(m.to_ints())
    nizkp = outdir / "nizkp.golden"
    v = FiatShamirVerifier(params, nizkp, test_vectors=TV_NAMES)
    assert v.verify(expected_type="mixing").ok
    return nizkp, v.tv


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
        if group in FFC:
            ffc_group(group)
        dirname, tvname = fixture_names(group)
        kw = {"k": 3, "threshold": 2} if group.endswith("-k3") else {}
        with tempfile.TemporaryDirectory() as tmp:
            if group in MATRIX:
                nizkp, tv = matrix_golden(group, Path(tmp))
            elif group in FFC:
                nizkp, tv = ffc_golden(Path(tmp), group)
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

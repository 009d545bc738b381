"""Write the wide-group golden fixtures of the port's tests with vmn_tpu.

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

Usage (from the repo root, about 2 minutes for the two ModP groups, 1 for
P-224, 1.5 for P-384 and 2 for P-521):
    JAX_PLATFORMS=cpu python tests/torch_make_wide_golden.py [GROUP ...]
"""

import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden"
GROUPS = ("modp3072", "modp4096", "P-224", "P-384", "P-521")


def fixture_names(group: str):
    """(transcript directory, test-vector file) of a wide group's golden."""
    tag = group.replace("-", "").lower()
    return f"nizkp_{tag}_k1", f"test_vectors_{tag}.json"


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    from tools.make_golden import generate

    for group in argv or GROUPS:
        if group not in GROUPS:
            raise SystemExit(f"unknown group {group}; one of {GROUPS}")
        dirname, tvname = fixture_names(group)
        with tempfile.TemporaryDirectory() as tmp:
            nizkp, tv = generate(Path(tmp), group)
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

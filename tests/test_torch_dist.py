"""The port's k=1 mix with its ciphertext axis split over ranks, on the
CPU (counterpart of tests/test_dist.py).

Processes of `python -m vmn_tpu_torch.parallel.dist_worker --golden`
(tools/make_golden.py's inputs and seeds), joined by the VMN_DIST_*
triplet over gloo with `--device cpu`, each under a time limit: test256
(n = 5) over 2 ranks (blocks of 3 and 2) and over 4 (2, 1, 1, 1), P-256
(n = 3) over 2 (2, 1) and over 4 (1, 1, 1, 0: an empty block).  Every
rank must preserve the plaintext multiset and print the same digest of
its nizkp directory, rank 0's transcript must rewrite the committed
golden (tests/golden/nizkp_{test256,p256}_k1) byte for byte, and
`vmn_tpu`'s FiatShamirVerifier must accept it.  One process without the
triplet (`init_from_env()` False) mixes the same inputs unsharded, to
the same digest.

Tolerance: exact equality of every transcript byte.
"""

import re

import pytest

from torch_port_util import (
    GOLDEN, assert_same_transcript, join_ranks, spawn_ranks,
)

RANK_TIMEOUT_S = 240
# (group, ranks): the golden's messages over that many ranks
CASES = [("test256", 2), ("test256", 4), ("P-256", 2), ("P-256", 4)]
ROWS = {("test256", 2): [3, 2], ("test256", 4): [2, 1, 1, 1],
        ("P-256", 2): [2, 1], ("P-256", 4): [1, 1, 1, 0]}
LINE = re.compile(r"^DIST pid=(\d+) ranks=(\d+) dist=(\w+) rows=(\d+) "
                  r"ok=(\w+) digest=(\w+)", re.M)


def golden_dir(group: str):
    return GOLDEN / f"nizkp_{group.replace('-', '').lower()}_k1"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(group, ranks) -> (workdir, [(pid, ranks, dist, rows, ok, digest)]
    by rank); ranks 0 is the one process without the triplet.  Every
    run starts at once."""
    started = {}
    for group, nranks in CASES + [("test256", 0)]:
        work = tmp_path_factory.mktemp(f"dist_{group}_{nranks}")
        argv = ["-m", "vmn_tpu_torch.parallel.dist_worker", str(work),
                "--group", group, "--golden", "--device", "cpu"]
        started[group, nranks] = work, spawn_ranks(
            argv, max(nranks, 1), triplet=nranks > 0)
    out = {}
    for key, (work, procs) in started.items():
        lines = []
        for rc, text in join_ranks(procs, RANK_TIMEOUT_S):
            assert rc == 0, text[-3000:]
            pid, ranks, joined, rows, ok, dig = LINE.search(text).groups()
            lines.append((int(pid), int(ranks), joined == "True",
                          int(rows), ok == "True", dig))
        out[key] = work, sorted(lines)
    return out


@pytest.mark.parametrize("case", CASES, ids=[f"{g}-{r}" for g, r in CASES])
def test_ranks_agree_on_their_blocks(runs, case):
    _, lines = runs[case]
    assert [ln[0] for ln in lines] == list(range(case[1]))
    assert all(ln[1] == case[1] and ln[2] and ln[4] for ln in lines), lines
    assert [ln[3] for ln in lines] == ROWS[case]
    assert len({ln[5] for ln in lines}) == 1, lines


@pytest.mark.parametrize("case", CASES, ids=[f"{g}-{r}" for g, r in CASES])
def test_sharded_mix_rewrites_golden(runs, case):
    work, _ = runs[case]
    for rank in range(case[1]):
        assert_same_transcript(work / f"proc{rank}" / "nizkp.golden",
                               golden_dir(case[0]))


def test_unsharded_run_without_triplet(runs):
    """No VMN_DIST_* triplet: `init_from_env()` returns False, one rank
    mixes the whole batch, to the sharded runs' digest."""
    (pid, ranks, joined, rows, ok, dig), = runs["test256", 0][1]
    assert (pid, ranks, joined, rows, ok) == (0, 1, False, 5, True)
    assert dig == runs["test256", 2][1][0][5]


def test_init_from_env_without_triplet(monkeypatch):
    from vmn_tpu_torch.parallel import dist
    from vmn_tpu_torch.parallel.mesh import ciph_mesh

    monkeypatch.delenv("VMN_DIST_COORD", raising=False)
    assert dist.init_from_env(device="cpu") is False
    assert not dist.is_multiprocess() and dist.process_index() == 0
    mesh = ciph_mesh(device="cpu")
    assert (mesh.size, mesh.rank) == (1, 0)


@pytest.mark.parametrize("group", ["test256", "P-256"])
def test_vmn_tpu_verifier_accepts_sharded_mix(runs, group):
    from vmn_tpu.arith.ec import ECqPGroup
    from vmn_tpu.arith.pgroup import ModPGroup
    from vmn_tpu.protocol.context import ProtocolParams
    from vmn_tpu.protocol.mixnet.verifier import FiatShamirVerifier

    grp = (ECqPGroup.named(group) if group.startswith("P-")
           else ModPGroup.named(group))
    params = ProtocolParams(sid="Golden", k=1, threshold=1, pgroup=grp)
    work, _ = runs[group, 2]
    res = FiatShamirVerifier(params, work / "proc0" / "nizkp.golden"
                             ).verify(expected_type="mixing")
    assert res.ok

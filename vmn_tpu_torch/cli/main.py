"""`vtm` — umbrella command dispatching the tool family (port of
`vmn_tpu.cli.main`).

Rebuild of the reference CLI surface (reference: VMNTool.java:50-70 and
SURVEY.md §2.2):

    vmni   info-file generator/merger       (vmn_tpu_torch.cli.vmni)
    vmn    mix-server operations            (vmn_tpu_torch.cli.vmn)
    vmnv   standalone proof verifier        (vmn_tpu_torch.cli.vmnv)
    vmnc   format converter                 (vmn_tpu_torch.cli.vmnc)
    vmnd   demo key/ciphertext generator    (vmn_tpu_torch.cli.vmnd)
    vre    key/ciphertext re-arrangement    (vmn_tpu_torch.cli.vre)
    vbt    byte-tree dump                   (vmn_tpu_torch.cli.vbt)
    vdemo  simulated multi-party demo       (vmn_tpu_torch.cli.vdemo)
    vhttp  standalone board HTTP server     (vmn_tpu_torch.cli.vhttp)
    vog    object generator                 (vmn_tpu_torch.cli.vog)

Usage: python -m vmn_tpu_torch.cli.main <command> [args...]
Each command is also runnable as python -m vmn_tpu_torch.cli.<command>.
Every command runs on the CUDA card.
"""

from __future__ import annotations

import sys

_COMMANDS = ("vmni", "vmn", "vmnv", "vmnc", "vmnd", "vre", "vbt",
             "vdemo", "vhttp", "vog")


def main(argv=None, device="cuda") -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    # Several processes of one party (the VMN_DIST_* triplet) join their
    # process group before first device use, each rank on its own device
    # (parallel/dist.py).
    from vmn_tpu_torch.parallel import dist

    dist.init_from_env(device=device)
    cmd = argv[0]
    if cmd not in _COMMANDS:
        print(f"unknown command: {cmd}; one of {', '.join(_COMMANDS)}",
              file=sys.stderr)
        return 2
    import importlib

    mod = importlib.import_module(f"vmn_tpu_torch.cli.{cmd}")
    return mod.main(argv[1:], device=device)


if __name__ == "__main__":
    sys.exit(main())

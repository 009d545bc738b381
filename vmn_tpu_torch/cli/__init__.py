"""Operator command-line tools (port of `vmn_tpu.cli`; reference:
SURVEY.md §2.2 — vtm/vmn/vmni/vmnv/vmnc/vmnd/vre/vbt command family).

Every tool's `main(argv=None, device="cuda")` runs on the card; a caller
in Python (the tests) passes `device="cpu"`.  From the command line the
tools always run on the card."""

"""Hand-written Hopper kernels and their plain PyTorch versions (port of
`vmn_tpu.ops`)."""

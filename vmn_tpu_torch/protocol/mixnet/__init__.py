"""Mix-net sessions and the standalone verifier (port of
`vmn_tpu.protocol.mixnet`)."""

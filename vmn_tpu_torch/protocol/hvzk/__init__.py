"""Zero-knowledge proofs (port of `vmn_tpu.protocol.hvzk`)."""

"""Pedersen VSS (port of `vmn_tpu.protocol.secretsharing`)."""

"""Distributed key generation (port of `vmn_tpu.protocol.distr`)."""

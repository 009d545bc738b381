"""Byte-tree serialization (port of `vmn_tpu.eio`)."""

"""Bulletin board (port of `vmn_tpu.protocol.com`)."""

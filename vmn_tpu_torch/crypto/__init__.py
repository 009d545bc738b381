"""Hashes, PRG, random oracle and random sources (port of
`vmn_tpu.crypto`)."""

"""Limb codec, Montgomery arithmetic and the group layer (port of
`vmn_tpu.arith`)."""

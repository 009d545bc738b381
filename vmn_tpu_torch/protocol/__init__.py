"""Protocol layer (port of `vmn_tpu.protocol`)."""

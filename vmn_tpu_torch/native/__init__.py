"""Host C++ helpers (port of `vmn_tpu.native`): byte-tree codec, SHA-256
PRG expansion, batch Jacobi and limb codec, built with g++ on first use."""

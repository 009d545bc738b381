"""vmn_tpu_torch — the PyTorch/CUDA port of `vmn_tpu`.

Ports the k=1 ModP mix path of `vmn_tpu` (keygen, re-encryption
shuffle, Terelius–Wikström proof of shuffle, verifiable decryption,
Fiat–Shamir transcript and the standalone verifier) to PyTorch.  Group
arithmetic on CUDA tensors runs through hand-written Hopper kernels
(`csrc/`, bound in `ops.mont_kernels`); on CPU tensors through their
plain PyTorch versions.  The package imports neither `jax` nor
`vmn_tpu`; the layout mirrors `vmn_tpu` module for module.
"""

# Version string embedded in proofs (port of vmn_tpu/__init__.py:108).
VCR_COMPAT_VERSION = "3.1.0"

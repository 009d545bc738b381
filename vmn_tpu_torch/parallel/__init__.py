"""The ciphertext axis split over ranks (port of `vmn_tpu.parallel`).

`vmn_tpu` splits N-element array ops over the devices of a
`jax.sharding.Mesh`; here N is split over the ranks of a process group,
one process and one device a rank (`dist`), each running the port's
kernels on its block of rows (`mesh`).  Reductions reduce each block and
combine the tiny per-rank partials through one transport function.
Inter-*party* communication never uses these collectives (trust
boundary): they only split one party's work.
"""

from vmn_tpu_torch.parallel.mesh import (  # noqa: F401
    ciph_mesh,
    make_mesh,
    replicate,
    shard_array,
    shard_garray,
    shard_limbs,
    sharded_exp_prod,
)

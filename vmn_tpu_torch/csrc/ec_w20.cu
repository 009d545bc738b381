// The EC kernels at W' = 20 (P-521: L = 33 limbs padded to 40, converted
// at the boundary, coop_rebase) but H6 (ec_mexp_w20.cu): the (W, TPI)
// pairs that the entry points of ec_kernels.cu reach.  H5, H8 and the
// combine at TPI 4 (kernel_timing.py --sweep: H8 at TPI 2 slower at every
// batch; H5 at TPI 2 would need 246 KB a block); H7 is off the path and
// not built.
#include "ec_kernels.cuh"

namespace vmn_ec {

template struct Add<20, 4>;
template struct Smul<20, 4>;
template struct Chain<20, 4>;

}  // namespace vmn_ec

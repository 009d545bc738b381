// The EC kernels at W = 12 (P-384, L = 24) but H6 (ec_mexp_w12.cu): the
// (W, TPI) pairs that the entry points of ec_kernels.cu reach.  TPI 8 does
// not divide 12; H5 and H8 at TPI 2 measured slower than at TPI 4 at every
// batch (COOP_TPI), and H5 at TPI 1 would need 288 KB a block.
#include "ec_kernels.cuh"

namespace vmn_ec {

template struct Add<12, 4>;
template struct Smul<12, 4>;
template struct Chain<12, 4>;
template struct Fb<12>;

}  // namespace vmn_ec

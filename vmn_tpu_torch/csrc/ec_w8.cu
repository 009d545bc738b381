// The EC kernels at W = 8 (P-256, L = 16) but H6 (ec_mexp_w8.cu): the
// (W, TPI) pairs that the entry points of ec_kernels.cu reach.
#include "ec_kernels.cuh"

namespace vmn_ec {

template struct Add<8, 2>;
template struct Add<8, 4>;
template struct Add<8, 8>;
template struct Smul<8, 2>;
template struct Smul<8, 4>;
template struct Chain<8, 8>;
template struct Fb<8>;

}  // namespace vmn_ec

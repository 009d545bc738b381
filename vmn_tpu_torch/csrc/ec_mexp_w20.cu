// H6 at W' = 20 (P-521), the cooperative form (groups of 4 lanes), in a
// source file of its own so that nvcc builds it beside the other EC
// kernels.
#include "ec_kernels.cuh"

namespace vmn_ec {

template struct Mexp<20>;

}  // namespace vmn_ec

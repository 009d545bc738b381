// H6 at W = 8 (P-256), in a source file of its own so that nvcc builds
// it beside the other EC kernels.
#include "ec_kernels.cuh"

namespace vmn_ec {

template struct Mexp<8>;

}  // namespace vmn_ec

// The launchers of the EC kernels, declared for the C entry points of
// ec_kernels.cu: one class template a kernel, defined in ec_kernels.cuh and
// instantiated at each (W, TPI) by the source file of its width (ec_w8.cu,
// ec_mexp_w8.cu, ec_w12.cu, ec_mexp_w12.cu, ec_w20.cu, ec_mexp_w20.cu).
// Each launches on stream s, does not synchronise, allocates nothing and
// returns cudaGetLastError(), or kBadShape for a launch shape the kernel
// cannot take.  c_in and c_out: the boundary conversion of a padded
// modulus (coop_rebase in mont_coop.cuh), NULL at every other.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace vmn_ec {

constexpr int kUnsupportedWidth = -1;
constexpr int kBadShape = -2;

// H8: batched Jacobian addition on TPI lanes a pair.
template <int W, int TPI>
struct Add {
  static int launch(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                    const int32_t* x2, const int32_t* y2, const int32_t* z2,
                    int32_t* ox, int32_t* oy, int32_t* oz, const int32_t* m,
                    uint32_t mp, const int32_t* c_in, const int32_t* c_out,
                    int64_t n, int threads, int64_t blocks, cudaStream_t s);
};

// H5: batched scalar multiple on TPI lanes a point.
template <int W, int TPI>
struct Smul {
  static int launch(const int32_t* x, const int32_t* y, const uint8_t* inf,
                    const int32_t* e, int32_t* ox, int32_t* oy, int32_t* oz,
                    const int32_t* m, const int32_t* one, uint32_t mp,
                    const int32_t* c_in, const int32_t* c_out, int64_t n,
                    int le, int ndig, int threads, int64_t blocks,
                    cudaStream_t s);
};

// K10's position combine: one chain on one warp.
template <int W, int TPI>
struct Chain {
  static int launch(const int32_t* px, const int32_t* py, const int32_t* pz,
                    int32_t* ox, int32_t* oy, int32_t* oz, const int32_t* m,
                    const int32_t* one, uint32_t mp, const int32_t* c_in,
                    const int32_t* c_out, int npos, cudaStream_t s);
};

// H6: the digit positions' partial sums over `blocks` blocks.
template <int W>
struct Mexp {
  static int launch(const int32_t* x, const int32_t* y, const uint8_t* inf,
                    const int32_t* e, int32_t* out, const int32_t* m,
                    const int32_t* one, uint32_t mp, const int32_t* c_in,
                    const int32_t* c_out, int64_t n, int le, int npos,
                    int subs, int blocks, cudaStream_t s);
};

// H7: fixed-base multiples from an affine table.
template <int W>
struct Fb {
  static int launch(const int32_t* tx, const int32_t* ty, const int32_t* e,
                    int32_t* ox, int32_t* oy, int32_t* oz, const int32_t* m,
                    const int32_t* one, uint32_t mp, int64_t n, int le,
                    int ndig, cudaStream_t s);
};

}  // namespace vmn_ec

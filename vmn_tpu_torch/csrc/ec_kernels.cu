// Hand-written Hopper kernels for batched elliptic-curve arithmetic,
// bound to Python through a plain C interface (ctypes; see
// ops/ec_kernels.py).
//
//   H5 vmn_ec_smul      replaces K9  ec_scalar_mul_pallas  (ec_kernels.py:277-331)
//   H6 vmn_ec_mexp_tbl  replace both pallas_calls of K10 ec_multiexp_pallas
//      vmn_ec_mexp_acc                                      (:444-584)
//   H7 vmn_ec_fb        replaces K11 ec_fb_exp_pallas      (:667-719)
//   H8 vmn_ec_add       replaces K12 ec_point_add_pallas   (:747-773)
//
// One thread per point (H6's second launch: per lane and digit
// position), 128 threads a block, coordinates limb-major (L, n) int32
// 16-bit limbs as H1-H4 read them, point arithmetic from ec.cuh.  Each
// entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() (or kUnsupportedWidth
// for a width with no instantiation).
//
// Constant time (docs/DEVIATIONS.md #5): no kernel indexes a table with a
// secret digit or branches on one; every table entry is read and masked.
#include <cuda_runtime.h>

#include <cstdint>

#include "ec.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnsupportedWidth = -1;
constexpr int kEntries = 16;  // 4-bit windows

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <int W>
__device__ __forceinline__ void load_one(uint32_t* dst, const int32_t* one) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    dst[k] = (uint32_t)one[2 * k] | ((uint32_t)one[2 * k + 1] << 16);
  }
}

// ------------------------------------------------------------ H8: add
template <int W>
__global__ void __launch_bounds__(kThreads)
    ec_add_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                  const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
                  const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
                  int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                  int32_t* __restrict__ oz, const int32_t* __restrict__ m,
                  uint32_t mp, int64_t n) {
  __shared__ uint32_t sm[W];
  vmn::load_vec_shared<W>(sm, m);
  __syncthreads();
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const vmn::Field<W> F{sm, mp};
  uint32_t X1[W], Y1[W], Z1[W], X2[W], Y2[W], Z2[W];
  vmn::load_words<W>(X1, x1, n, e);
  vmn::load_words<W>(Y1, y1, n, e);
  vmn::load_words<W>(Z1, z1, n, e);
  vmn::load_words<W>(X2, x2, n, e);
  vmn::load_words<W>(Y2, y2, n, e);
  vmn::load_words<W>(Z2, z2, n, e);
  vmn::point_add<W>(F, X1, Y1, Z1, X1, Y1, Z1, X2, Y2, Z2);
  vmn::store_words<W>(ox, X1, n, e);
  vmn::store_words<W>(oy, Y1, n, e);
  vmn::store_words<W>(oz, Z1, n, e);
}

// ------------------------------------------------- H5: scalar multiple
// Per point: the 16 Jacobian multiples d·P (entry 0 is infinity: X = 0,
// Y = one, Z = 0) in local memory (16·3·W words, 1.5 KB at W = 8), then
// ndig windows from the most significant: 4 doublings, a masked select
// over all 16 entries, one addition.
template <int W>
__global__ void __launch_bounds__(kThreads)
    ec_smul_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                   const uint8_t* __restrict__ inf, const int32_t* __restrict__ e,
                   int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                   int32_t* __restrict__ oz, const int32_t* __restrict__ m,
                   const int32_t* __restrict__ one, uint32_t mp, int64_t n,
                   int le, int ndig) {
  __shared__ uint32_t sm[W];
  vmn::load_vec_shared<W>(sm, m);
  __syncthreads();
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const vmn::Field<W> F{sm, mp};
  uint32_t o[W], X1[W], Y1[W], Z1[W];
  load_one<W>(o, one);
  vmn::load_words<W>(X1, x, n, idx);
  vmn::load_words<W>(Y1, y, n, idx);
  const uint32_t pinf = 0u - (uint32_t)(inf[idx] != 0);
#pragma unroll
  for (int k = 0; k < W; ++k) Z1[k] = o[k] & ~pinf;

  uint32_t tx[kEntries][W], ty[kEntries][W], tz[kEntries][W];
  vmn::set_zero<W>(tx[0]);
  vmn::copy<W>(ty[0], o);
  vmn::set_zero<W>(tz[0]);
  vmn::copy<W>(tx[1], X1);
  vmn::copy<W>(ty[1], Y1);
  vmn::copy<W>(tz[1], Z1);
  uint32_t aX[W], aY[W], aZ[W];
  vmn::copy<W>(aX, X1);
  vmn::copy<W>(aY, Y1);
  vmn::copy<W>(aZ, Z1);
#pragma unroll 1
  for (int d = 2; d < kEntries; ++d) {
    vmn::point_add<W>(F, aX, aY, aZ, aX, aY, aZ, X1, Y1, Z1);
    vmn::copy<W>(tx[d], aX);
    vmn::copy<W>(ty[d], aY);
    vmn::copy<W>(tz[d], aZ);
  }

  vmn::set_zero<W>(aX);
  vmn::copy<W>(aY, o);
  vmn::set_zero<W>(aZ);
  uint32_t fX[W], fY[W], fZ[W];
#pragma unroll 1
  for (int j = ndig - 1; j >= 0; --j) {
#pragma unroll 1
    for (int s = 0; s < 4; ++s) vmn::point_double<W>(F, aX, aY, aZ, aX, aY, aZ);
    const uint32_t dig = vmn::digit<4>(e, le, n, idx, j);
    vmn::set_zero<W>(fX);
    vmn::set_zero<W>(fY);
    vmn::set_zero<W>(fZ);
#pragma unroll
    for (int d = 0; d < kEntries; ++d) {
      const uint32_t mask = 0u - (uint32_t)(dig == (uint32_t)d);
#pragma unroll
      for (int k = 0; k < W; ++k) {
        fX[k] |= tx[d][k] & mask;
        fY[k] |= ty[d][k] & mask;
        fZ[k] |= tz[d][k] & mask;
      }
    }
    vmn::point_add<W>(F, aX, aY, aZ, aX, aY, aZ, fX, fY, fZ);
  }
  vmn::store_words<W>(ox, aX, n, idx);
  vmn::store_words<W>(oy, aY, n, idx);
  vmn::store_words<W>(oz, aZ, n, idx);
}

// ------------------------------------------- H6: multi-exponentiation
// Launch 1: each point's 16 Jacobian multiples to device memory, packed
// words, layout (16, 3, W, n): neighbouring points are neighbours.
template <int W>
__global__ void __launch_bounds__(kThreads)
    ec_mexp_tbl_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                       const uint8_t* __restrict__ inf, uint32_t* __restrict__ tbl,
                       const int32_t* __restrict__ m,
                       const int32_t* __restrict__ one, uint32_t mp, int64_t n) {
  __shared__ uint32_t sm[W];
  vmn::load_vec_shared<W>(sm, m);
  __syncthreads();
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const vmn::Field<W> F{sm, mp};
  uint32_t o[W], X1[W], Y1[W], Z1[W], aX[W], aY[W], aZ[W];
  load_one<W>(o, one);
  vmn::load_words<W>(X1, x, n, idx);
  vmn::load_words<W>(Y1, y, n, idx);
  const uint32_t pinf = 0u - (uint32_t)(inf[idx] != 0);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    Z1[k] = o[k] & ~pinf;
    tbl[(int64_t)(0 * W + k) * n + idx] = 0;
    tbl[(int64_t)(1 * W + k) * n + idx] = o[k];
    tbl[(int64_t)(2 * W + k) * n + idx] = 0;
    tbl[(int64_t)(3 * W + k) * n + idx] = X1[k];
    tbl[(int64_t)(4 * W + k) * n + idx] = Y1[k];
    tbl[(int64_t)(5 * W + k) * n + idx] = Z1[k];
  }
  vmn::copy<W>(aX, X1);
  vmn::copy<W>(aY, Y1);
  vmn::copy<W>(aZ, Z1);
#pragma unroll 1
  for (int d = 2; d < kEntries; ++d) {
    vmn::point_add<W>(F, aX, aY, aZ, aX, aY, aZ, X1, Y1, Z1);
    uint32_t* row = tbl + (int64_t)d * 3 * W * n + idx;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      row[(int64_t)k * n] = aX[k];
      row[(int64_t)(W + k) * n] = aY[k];
      row[(int64_t)(2 * W + k) * n] = aZ[k];
    }
  }
}

// Launch 2: thread (lane t, digit position j) folds points t, t+lanes, ...
// into one Jacobian partial sum of d_ij·P_i.  The loop inside the thread
// takes the place of the TPU's sequential chunk axis; the caller joins
// the lanes (H8 tree) and combines the positions.  Output (3, L, cols)
// with cols = ndig_pad·lanes, column j·lanes + t.
template <int W>
__global__ void __launch_bounds__(kThreads)
    ec_mexp_acc_kernel(const uint32_t* __restrict__ tbl, const int32_t* __restrict__ e,
                       int32_t* __restrict__ out, const int32_t* __restrict__ m,
                       const int32_t* __restrict__ one, uint32_t mp, int64_t n,
                       int le, int lanes) {
  __shared__ uint32_t sm[W];
  vmn::load_vec_shared<W>(sm, m);
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= lanes) return;
  const int j = blockIdx.y;
  const int64_t cols = (int64_t)gridDim.y * lanes;
  const vmn::Field<W> F{sm, mp};
  uint32_t aX[W], aY[W], aZ[W], fX[W], fY[W], fZ[W];
  vmn::set_zero<W>(aX);
  load_one<W>(aY, one);
  vmn::set_zero<W>(aZ);
#pragma unroll 1
  for (int64_t i = t; i < n; i += lanes) {
    const uint32_t dig = vmn::digit<4>(e, le, n, i, j);
    vmn::set_zero<W>(fX);
    vmn::set_zero<W>(fY);
    vmn::set_zero<W>(fZ);
#pragma unroll 1
    for (int d = 0; d < kEntries; ++d) {
      const uint32_t mask = 0u - (uint32_t)(dig == (uint32_t)d);
      const uint32_t* row = tbl + (int64_t)d * 3 * W * n + i;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        fX[k] |= row[(int64_t)k * n] & mask;
        fY[k] |= row[(int64_t)(W + k) * n] & mask;
        fZ[k] |= row[(int64_t)(2 * W + k) * n] & mask;
      }
    }
    vmn::point_add<W>(F, aX, aY, aZ, aX, aY, aZ, fX, fY, fZ);
  }
  const int64_t col = (int64_t)j * lanes + t;
  const int64_t plane = (int64_t)2 * W * cols;
  vmn::store_words<W>(out, aX, cols, col);
  vmn::store_words<W>(out + plane, aY, cols, col);
  vmn::store_words<W>(out + 2 * plane, aZ, cols, col);
}

// --------------------------------------------------- H7: fixed base
// out = sum_j T[j][digit_j(e)] for the affine table T (ndig, 16, L) of
// d·2^(4j)·P shared by the batch: no doublings, one addition per digit
// with Z = one (Z = 0 for digit 0).  The block stages digit j's 16 rows of
// both coordinates (2·16·W words, 1 KB at W = 8) in shared memory; every
// thread masked-selects its row, a broadcast read for the warp.  This
// replaces the TPU's one-hot f32 MXU gather.
template <int W>
__global__ void __launch_bounds__(kThreads)
    ec_fb_kernel(const int32_t* __restrict__ tx, const int32_t* __restrict__ ty,
                 const int32_t* __restrict__ e, int32_t* __restrict__ ox,
                 int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                 const int32_t* __restrict__ m, const int32_t* __restrict__ one,
                 uint32_t mp, int64_t n, int le, int ndig) {
  constexpr int kL = 2 * W;
  __shared__ uint32_t sm[W];
  __shared__ uint32_t sx[kEntries * W];
  __shared__ uint32_t sy[kEntries * W];
  vmn::load_vec_shared<W>(sm, m);
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = idx < n;
  const vmn::Field<W> F{sm, mp};
  uint32_t o[W], aX[W], aY[W], aZ[W], fX[W], fY[W], fZ[W];
  load_one<W>(o, one);
  vmn::set_zero<W>(aX);
  vmn::copy<W>(aY, o);
  vmn::set_zero<W>(aZ);
#pragma unroll 1
  for (int j = 0; j < ndig; ++j) {
    __syncthreads();  // every reader of the previous digit's rows is done
    const int32_t* bx = tx + (int64_t)j * kEntries * kL;
    const int32_t* by = ty + (int64_t)j * kEntries * kL;
    for (int w = threadIdx.x; w < kEntries * W; w += blockDim.x) {
      sx[w] = (uint32_t)bx[2 * w] | ((uint32_t)bx[2 * w + 1] << 16);
      sy[w] = (uint32_t)by[2 * w] | ((uint32_t)by[2 * w + 1] << 16);
    }
    __syncthreads();
    if (live) {
      const uint32_t dig = vmn::digit<4>(e, le, n, idx, j);
      vmn::set_zero<W>(fX);
      vmn::set_zero<W>(fY);
#pragma unroll
      for (int d = 0; d < kEntries; ++d) {
        const uint32_t mask = 0u - (uint32_t)(dig == (uint32_t)d);
#pragma unroll
        for (int k = 0; k < W; ++k) {
          fX[k] |= sx[d * W + k] & mask;
          fY[k] |= sy[d * W + k] & mask;
        }
      }
      const uint32_t zero_digit = 0u - (uint32_t)(dig == 0u);
#pragma unroll
      for (int k = 0; k < W; ++k) fZ[k] = o[k] & ~zero_digit;
      vmn::point_add<W>(F, aX, aY, aZ, aX, aY, aZ, fX, fY, fZ);
    }
  }
  if (live) {
    vmn::store_words<W>(ox, aX, n, idx);
    vmn::store_words<W>(oy, aY, n, idx);
    vmn::store_words<W>(oz, aZ, n, idx);
  }
}

}  // namespace

// Instantiated width: W = 8 (L = 16), P-256.  P-224 (L = 14, W = 7) and
// P-384 (W = 12) get their case with the first cell or test that runs
// them; P-521 (L = 33) is odd and has no packed-word form.
#define VMN_EC_FOR_W(w, ...)                       \
  switch (w) {                                     \
    case 8: {                                      \
      constexpr int W = 8;                         \
      __VA_ARGS__;                                 \
    } break;                                       \
    default:                                       \
      return kUnsupportedWidth;                    \
  }

extern "C" {

int vmn_ec_add(int w, const int32_t* x1, const int32_t* y1, const int32_t* z1,
               const int32_t* x2, const int32_t* y2, const int32_t* z2,
               int32_t* ox, int32_t* oy, int32_t* oz, const int32_t* m,
               uint32_t mp, int64_t n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  VMN_EC_FOR_W(w, ec_add_kernel<W><<<blocks_for(n), kThreads, 0, s>>>(
                      x1, y1, z1, x2, y2, z2, ox, oy, oz, m, mp, n));
  return (int)cudaGetLastError();
}

int vmn_ec_smul(int w, const int32_t* x, const int32_t* y, const uint8_t* inf,
                const int32_t* e, int32_t* ox, int32_t* oy, int32_t* oz,
                const int32_t* m, const int32_t* one, uint32_t mp, int64_t n,
                int le, int ndig, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  VMN_EC_FOR_W(w, ec_smul_kernel<W><<<blocks_for(n), kThreads, 0, s>>>(
                      x, y, inf, e, ox, oy, oz, m, one, mp, n, le, ndig));
  return (int)cudaGetLastError();
}

int vmn_ec_mexp_tbl(int w, const int32_t* x, const int32_t* y,
                    const uint8_t* inf, uint32_t* tbl, const int32_t* m,
                    const int32_t* one, uint32_t mp, int64_t n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  VMN_EC_FOR_W(w, ec_mexp_tbl_kernel<W><<<blocks_for(n), kThreads, 0, s>>>(
                      x, y, inf, tbl, m, one, mp, n));
  return (int)cudaGetLastError();
}

int vmn_ec_mexp_acc(int w, const uint32_t* tbl, const int32_t* e, int32_t* out,
                    const int32_t* m, const int32_t* one, uint32_t mp,
                    int64_t n, int le, int ndig_pad, int lanes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(lanes), (unsigned)ndig_pad);
  VMN_EC_FOR_W(w, ec_mexp_acc_kernel<W><<<grid, kThreads, 0, s>>>(
                      tbl, e, out, m, one, mp, n, le, lanes));
  return (int)cudaGetLastError();
}

int vmn_ec_fb(int w, const int32_t* tx, const int32_t* ty, const int32_t* e,
              int32_t* ox, int32_t* oy, int32_t* oz, const int32_t* m,
              const int32_t* one, uint32_t mp, int64_t n, int le, int ndig,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  VMN_EC_FOR_W(w, ec_fb_kernel<W><<<blocks_for(n), kThreads, 0, s>>>(
                      tx, ty, e, ox, oy, oz, m, one, mp, n, le, ndig));
  return (int)cudaGetLastError();
}

}  // extern "C"

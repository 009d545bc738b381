// Hand-written Hopper kernels for batched Montgomery arithmetic, bound to
// Python through a plain C interface (ctypes; see ops/mont_kernels.py).
//
//   H1 vmn_mont_mul     replaces K2 mont_mul_pallas        (mont_kernels.py:182-216)
//   H2 vmn_mont_exp     replaces K3 mont_exp_pallas        (:222-286, :753-795)
//   H3 vmn_mont_fb_exp  replaces K4 mont_fb8_exp_pallas and K5 mont_fb_exp_pallas
//                                                          (:292-353, :361-527)
//   H4 vmn_ep_table +   replace both pallas_calls of K6 mont_expprod_positions
//      vmn_ep_acc                                          (:552-727)
//
// Every kernel runs one element per thread with the CIOS product of
// mont.cuh.  Each entry point launches on the caller's stream, does not
// synchronise, allocates nothing and returns cudaGetLastError() (or
// kUnsupportedWidth for a width with no instantiation).
#include <cuda_runtime.h>

#include <cstdint>

#include "mont.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnsupportedWidth = -1;

// ------------------------------------------------------------- H1: product
template <int W>
__global__ void __launch_bounds__(kThreads)
    mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                    int32_t* __restrict__ out, const int32_t* __restrict__ m,
                    uint32_t mp, int64_t n) {
  __shared__ uint32_t sm[W];
  vmn::load_vec_shared<W>(sm, m);
  __syncthreads();
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t x[W], y[W];
  vmn::load_words<W>(x, a, n, e);
  vmn::load_words<W>(y, b, n, e);
  vmn::mont_mul<W>(x, x, y, sm, mp);
  vmn::store_words<W>(out, x, n, e);
}

// -------------------------------------------------- H2: windowed power
// Per element: 16-entry table base^d (local memory), 4-bit fixed windows
// from the top digit, 4 squarings and one product per digit, the factor
// chosen by a masked select over all 16 entries (never an index by the
// secret digit).
template <int W>
__global__ void __launch_bounds__(kThreads)
    mont_exp_kernel(const int32_t* __restrict__ base, const int32_t* __restrict__ e,
                    int32_t* __restrict__ out, const int32_t* __restrict__ m,
                    const int32_t* __restrict__ one, uint32_t mp, int64_t n,
                    int le, int ndig) {
  __shared__ uint32_t sm[W];
  __shared__ uint32_t so[W];
  vmn::load_vec_shared<W>(sm, m);
  vmn::load_vec_shared<W>(so, one);
  __syncthreads();
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  uint32_t tbl[16][W];
#pragma unroll
  for (int k = 0; k < W; ++k) tbl[0][k] = so[k];
  vmn::load_words<W>(tbl[1], base, n, idx);
#pragma unroll 1
  for (int d = 2; d < 16; ++d) vmn::mont_mul<W>(tbl[d], tbl[d - 1], tbl[1], sm, mp);
  uint32_t acc[W], fac[W];
#pragma unroll
  for (int k = 0; k < W; ++k) acc[k] = so[k];
#pragma unroll 1
  for (int j = ndig - 1; j >= 0; --j) {
#pragma unroll 1
    for (int s = 0; s < 4; ++s) vmn::mont_mul<W>(acc, acc, acc, sm, mp);
    const uint32_t dig = vmn::digit<4>(e, le, n, idx, j);
#pragma unroll
    for (int k = 0; k < W; ++k) fac[k] = 0;
#pragma unroll
    for (int d = 0; d < 16; ++d) {
      const uint32_t mask = 0u - (uint32_t)(dig == (uint32_t)d);
#pragma unroll
      for (int k = 0; k < W; ++k) fac[k] |= tbl[d][k] & mask;
    }
    vmn::mont_mul<W>(acc, acc, fac, sm, mp);
  }
  vmn::store_words<W>(out, acc, n, idx);
}

// --------------------------------------------- H3: fixed-base power, 2^WB
// out = prod_j T[j][digit_j(e)] for a table T (ndig, 2^WB, L) shared by the
// batch.  The threads of a block stage digit j's 2^WB entries into shared
// memory (packed words), then each thread takes its factor by a masked
// select over every entry: all lanes of a warp read the same address, a
// broadcast.  This replaces the TPU's one-hot f32 MXU gather.
template <int W, int WB>
__global__ void __launch_bounds__(kThreads)
    mont_fb_exp_kernel(const int32_t* __restrict__ table,
                       const int32_t* __restrict__ e, int32_t* __restrict__ out,
                       const int32_t* __restrict__ m,
                       const int32_t* __restrict__ one, uint32_t mp, int64_t n,
                       int le, int ndig) {
  constexpr int kEntries = 1 << WB;
  constexpr int kL = 2 * W;
  extern __shared__ __align__(16) uint32_t stbl[];  // kEntries * W words
  __shared__ uint32_t sm[W];
  vmn::load_vec_shared<W>(sm, m);
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = idx < n;
  uint32_t acc[W], fac[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    acc[k] = (uint32_t)one[2 * k] | ((uint32_t)one[2 * k + 1] << 16);
  }
#pragma unroll 1
  for (int j = 0; j < ndig; ++j) {
    __syncthreads();  // every reader of the previous block is done
    const int32_t* blk = table + (int64_t)j * kEntries * kL;
    for (int x = threadIdx.x; x < kEntries * W; x += blockDim.x) {
      const int2 v = *reinterpret_cast<const int2*>(blk + 2 * x);
      stbl[x] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    }
    __syncthreads();
    if (live) {
      const uint32_t dig = vmn::digit<WB>(e, le, n, idx, j);
#pragma unroll
      for (int k = 0; k < W; ++k) fac[k] = 0;
#pragma unroll 4
      for (int d = 0; d < kEntries; ++d) {
        const uint32_t mask = 0u - (uint32_t)(dig == (uint32_t)d);
        const uint4* row = reinterpret_cast<const uint4*>(stbl + d * W);
#pragma unroll
        for (int k = 0; k < W / 4; ++k) {
          const uint4 v = row[k];
          fac[4 * k] |= v.x & mask;
          fac[4 * k + 1] |= v.y & mask;
          fac[4 * k + 2] |= v.z & mask;
          fac[4 * k + 3] |= v.w & mask;
        }
      }
      vmn::mont_mul<W>(acc, acc, fac, sm, mp);
    }
  }
  if (live) vmn::store_words<W>(out, acc, n, idx);
}

// ----------------------------------- H4: per-digit-position products (Yao)
// Launch 1: per-element 16-entry power table in device memory, packed
// words, layout (16, W, n) so that neighbouring elements are neighbours.
template <int W>
__global__ void __launch_bounds__(kThreads)
    ep_table_kernel(const int32_t* __restrict__ bases, uint32_t* __restrict__ tbl,
                    const int32_t* __restrict__ m, const int32_t* __restrict__ one,
                    uint32_t mp, int64_t n) {
  __shared__ uint32_t sm[W];
  vmn::load_vec_shared<W>(sm, m);
  __syncthreads();
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  uint32_t b[W], cur[W];
  vmn::load_words<W>(b, bases, n, idx);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    cur[k] = (uint32_t)one[2 * k] | ((uint32_t)one[2 * k + 1] << 16);
    tbl[(int64_t)k * n + idx] = cur[k];
    tbl[(int64_t)(W + k) * n + idx] = b[k];
  }
#pragma unroll
  for (int k = 0; k < W; ++k) cur[k] = b[k];
#pragma unroll 1
  for (int d = 2; d < 16; ++d) {
    vmn::mont_mul<W>(cur, cur, b, sm, mp);
#pragma unroll
    for (int k = 0; k < W; ++k) tbl[((int64_t)d * W + k) * n + idx] = cur[k];
  }
}

// Launch 2: thread (lane t, position j) folds elements t, t+lanes, ... of
// digit position j into one partial product.  The loop over chunks inside
// the thread takes the place of the TPU's sequential grid axis; the
// caller multiplies the lanes together (H1 product tree).
template <int W>
__global__ void __launch_bounds__(kThreads)
    ep_acc_kernel(const uint32_t* __restrict__ tbl, const int32_t* __restrict__ e,
                  int32_t* __restrict__ out, const int32_t* __restrict__ m,
                  const int32_t* __restrict__ one, uint32_t mp, int64_t n, int le,
                  int lanes) {
  __shared__ uint32_t sm[W];
  vmn::load_vec_shared<W>(sm, m);
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= lanes) return;
  const int j = blockIdx.y;
  const int64_t cols = (int64_t)gridDim.y * lanes;
  uint32_t acc[W], fac[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    acc[k] = (uint32_t)one[2 * k] | ((uint32_t)one[2 * k + 1] << 16);
  }
#pragma unroll 1
  for (int64_t i = t; i < n; i += lanes) {
    const uint32_t dig = vmn::digit<4>(e, le, n, i, j);
#pragma unroll
    for (int k = 0; k < W; ++k) fac[k] = 0;
#pragma unroll 1
    for (int d = 0; d < 16; ++d) {
      const uint32_t mask = 0u - (uint32_t)(dig == (uint32_t)d);
      const uint32_t* row = tbl + (int64_t)d * W * n + i;
#pragma unroll
      for (int k = 0; k < W; ++k) fac[k] |= row[(int64_t)k * n] & mask;
    }
    vmn::mont_mul<W>(acc, acc, fac, sm, mp);
  }
  vmn::store_words<W>(out, acc, cols, (int64_t)j * lanes + t);
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <int W, int WB>
int launch_fb(const int32_t* table, const int32_t* e, int32_t* out,
                     const int32_t* m, const int32_t* one, uint32_t mp,
                     int64_t n, int le, int ndig, cudaStream_t s) {
  const size_t smem = sizeof(uint32_t) * (size_t)(1 << WB) * W;
  // Above 48 KB (window 8 at 2048 bits: 64 KB) a launch is refused
  // unless the kernel opts in to the larger dynamic shared memory.
  cudaError_t err = cudaFuncSetAttribute(
      mont_fb_exp_kernel<W, WB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  mont_fb_exp_kernel<W, WB><<<blocks_for(n), kThreads, smem, s>>>(
      table, e, out, m, one, mp, n, le, ndig);
  return (int)cudaGetLastError();
}

}  // namespace

// Instantiated widths (W = L/2): test256 (L=16) and modp2048 (L=128), the
// widths that the tests and chip_smoke.py check against the plain versions.
// A wider group (modp3072: W=96, modp4096: W=128) gets its case here with
// the first cell or test that runs it.
#define VMN_FOR_W(w, ...)                          \
  switch (w) {                                     \
    case 8: {                                      \
      constexpr int W = 8;                         \
      __VA_ARGS__;                                 \
    } break;                                       \
    case 64: {                                     \
      constexpr int W = 64;                        \
      __VA_ARGS__;                                 \
    } break;                                       \
    default:                                       \
      return kUnsupportedWidth;                    \
  }

extern "C" {

int vmn_mont_mul(int w, const int32_t* a, const int32_t* b, int32_t* out,
                 const int32_t* m, uint32_t mp, int64_t n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  VMN_FOR_W(w, mont_mul_kernel<W><<<blocks_for(n), kThreads, 0, s>>>(
                   a, b, out, m, mp, n));
  return (int)cudaGetLastError();
}

int vmn_mont_exp(int w, const int32_t* base, const int32_t* e, int32_t* out,
                 const int32_t* m, const int32_t* one, uint32_t mp, int64_t n,
                 int le, int ndig, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  VMN_FOR_W(w, mont_exp_kernel<W><<<blocks_for(n), kThreads, 0, s>>>(
                   base, e, out, m, one, mp, n, le, ndig));
  return (int)cudaGetLastError();
}

int vmn_mont_fb_exp(int w, int wb, const int32_t* table, const int32_t* e,
                    int32_t* out, const int32_t* m, const int32_t* one,
                    uint32_t mp, int64_t n, int le, int ndig, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wb == 4) {
    VMN_FOR_W(w, return launch_fb<W, 4>(table, e, out, m, one, mp, n, le,
                                        ndig, s));
  }
  if (wb == 8) {
    VMN_FOR_W(w, return launch_fb<W, 8>(table, e, out, m, one, mp, n, le,
                                        ndig, s));
  }
  return kUnsupportedWidth;
}

int vmn_ep_table(int w, const int32_t* bases, uint32_t* tbl, const int32_t* m,
                 const int32_t* one, uint32_t mp, int64_t n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  VMN_FOR_W(w, ep_table_kernel<W><<<blocks_for(n), kThreads, 0, s>>>(
                   bases, tbl, m, one, mp, n));
  return (int)cudaGetLastError();
}

int vmn_ep_acc(int w, const uint32_t* tbl, const int32_t* e, int32_t* out,
               const int32_t* m, const int32_t* one, uint32_t mp, int64_t n,
               int le, int ndig_pad, int lanes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(lanes), (unsigned)ndig_pad);
  VMN_FOR_W(w, ep_acc_kernel<W><<<grid, kThreads, 0, s>>>(
                   tbl, e, out, m, one, mp, n, le, lanes));
  return (int)cudaGetLastError();
}

}  // extern "C"

// Hand-written Hopper kernels for batched Montgomery arithmetic, bound to
// Python through a plain C interface (ctypes; see ops/mont_kernels.py).
//
//   H1 vmn_mont_mul     replaces K2 mont_mul_pallas        (mont_kernels.py:182-216)
//   H2 vmn_mont_exp     replaces K3 mont_exp_pallas        (:222-286, :753-795)
//   H3 vmn_mont_fb_exp  replaces K4 mont_fb8_exp_pallas and K5 mont_fb_exp_pallas
//                                                          (:292-353, :361-527)
//   H4 vmn_ep_table +   replace both pallas_calls of K6 mont_expprod_positions
//      vmn_ep_acc                                          (:552-727)
//   vmn_mont_chain      the combine of K7 mont_expprod_pallas (:730-750)
//
// H1, H2 and the chain spread one element over TPI lanes of a warp with
// the cooperative product of mont_coop.cuh; the caller picks TPI from
// (W, N) among the instantiated pairs (vmn_mont_mul, vmn_mont_exp) by the
// crossovers measured on the card (COOP_TPI) and passes the launch shape
// (threads per block, blocks).  Their operands are row-major (N, 2W)
// 16-bit limbs, so that a group reads its element as one contiguous run.
// H3 and H4 run one element per thread with the CIOS product of mont.cuh
// on limb-major (2W, N) operands.  Each entry point launches on the
// caller's stream, does not synchronise, allocates nothing and returns
// cudaGetLastError() (or kUnsupportedWidth for a width, or a TPI, with no
// instantiation, kBadShape for a launch shape the kernel cannot take).
//
// What bounds H1, H2 and the chain on the H100, and what the cooperative
// design does about it: a W-word product is 2·W² dependent 32-bit
// multiply-adds (4·W² + W multiplies counting low and high halves).  On
// one thread that is ~60 µs at W = 64, the whole latency of a batch-1
// launch (the K7 combine, the product trees' roots, the inversions), and
// a large batch's operands spill.  TPI lanes share an element: the serial
// chain a lane runs is W/TPI words a step, a small batch gets a whole
// warp, a large one a few lanes so that the card stays full; operands
// stay in registers, H2's table moves to shared memory.  A large batch is
// then bound by multiply issue (each 32-bit half-product is one IMAD or
// IMAD.HI plus an IADD3.X of its carry chain), a batch of one by the
// latency of W steps of three shuffles and two row chains.
//
// ptxas (sm_90a, -O3, from chip_smoke.py's `ptxas` lines): registers,
// with no stack frame and no spill at any instantiation --
//   W = 64: mont_mul TPI 8/32: 48/28;       mont_exp 56/32;    chain 26.
//   W = 8:  mont_mul TPI 8: 21;   mont_exp TPI 1/8: 56/26;    chain 22.
#include <cuda_runtime.h>

#include <cstdint>

#include "mont.cuh"
#include "mont_coop.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnsupportedWidth = -1;
constexpr int kBadShape = -2;
constexpr int kExpEntries = 16;  // H2's 4-bit windows

// ------------------------------------------------------------- H1: product
// One element per group of TPI lanes: TPI = 32 for small batches (the
// product's serial chain is then W/32 words a lane), fewer lanes from the
// batch size where they measured faster (COOP_TPI, ops/mont_kernels.py).
template <int W, int TPI>
__global__ void __launch_bounds__(kThreads)
    mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                    int32_t* __restrict__ out, const int32_t* __restrict__ m,
                    uint32_t mp, int64_t n) {
  constexpr int S = W / TPI;
  bool live;
  const int64_t e = vmn::group_element<TPI>(n, &live);
  uint32_t x[S], y[S], mm[S];
  vmn::load_slice<W, TPI>(mm, m);
  vmn::load_slice<W, TPI>(x, a + e * 2 * W);
  vmn::load_slice<W, TPI>(y, b + e * 2 * W);
  vmn::coop_mont_mul<W, TPI>(x, x, y, mm, mp);
  if (live) vmn::store_slice<W, TPI>(out + e * 2 * W, x);
}

// -------------------------------------------------- H2: windowed power
// Per element: the 16-entry table base^d in shared memory, 4-bit fixed
// windows from the top digit, 4 squarings and one product per digit, the
// factor chosen by a masked select over all 16 entries of the lane's own
// slice (never an index by the secret digit).  The accumulator stays in
// registers.  Shared layout [entry][word][thread of the block]: for one
// (entry, word) the 32 lanes of a warp read 32 consecutive words, so no
// bank conflicts, and each thread reads only what it wrote (no barrier).
// A block of 128 threads holds 128/TPI elements at 16·4·W bytes each
// (4 KB at W = 64): 64 KB at TPI = 8, 16 KB at TPI = 32; above 48 KB the
// launcher opts in to the larger dynamic shared memory.  The table is
// what bounds the elements resident on an SM (at most 56 at W = 64).
template <int S>
__device__ __forceinline__ void select_entry(uint32_t* out,
                                             const uint32_t* mine, int stride,
                                             uint32_t dig) {
#pragma unroll
  for (int j = 0; j < S; ++j) out[j] = 0;
#pragma unroll 1  // unrolled, its 16·S loads are held in registers
  for (int d = 0; d < kExpEntries; ++d) {
    const uint32_t mask = 0u - (uint32_t)(dig == (uint32_t)d);
#pragma unroll
    for (int j = 0; j < S; ++j) out[j] |= mine[(d * S + j) * stride] & mask;
  }
}

// Three blocks an SM: at TPI = 8, W = 64 the shared table allows three
// 64 KB blocks (12 warps, 48 elements), and the bound keeps registers at
// or under 168 so that they allow three too.
template <int W, int TPI>
__global__ void __launch_bounds__(kThreads, 3)
    mont_exp_kernel(const int32_t* __restrict__ base, const int32_t* __restrict__ e,
                    int32_t* __restrict__ out, const int32_t* __restrict__ m,
                    const int32_t* __restrict__ one, uint32_t mp, int64_t n,
                    int le, int ndig) {
  constexpr int S = W / TPI;
  extern __shared__ uint32_t exp_tbl[];  // [kExpEntries][S][blockDim.x]
  bool live;
  const int64_t idx = vmn::group_element<TPI>(n, &live);
  const int stride = (int)blockDim.x;
  uint32_t* mine = exp_tbl + threadIdx.x;
  uint32_t mm[S], x[S], cur[S];
  vmn::load_slice<W, TPI>(mm, m);
  vmn::load_slice<W, TPI>(x, base + idx * 2 * W);
  vmn::load_slice<W, TPI>(cur, one);
#pragma unroll
  for (int j = 0; j < S; ++j) {
    mine[j * stride] = cur[j];
    mine[(S + j) * stride] = x[j];
    cur[j] = x[j];
  }
#pragma unroll 1
  for (int d = 2; d < kExpEntries; ++d) {
    vmn::coop_mont_mul<W, TPI>(cur, cur, x, mm, mp);
#pragma unroll
    for (int j = 0; j < S; ++j) mine[(d * S + j) * stride] = cur[j];
  }
  const int32_t* ex = e + idx * le;
  uint32_t acc[S], fac[S];
  // The top digit's entry starts the accumulator (one^16 · T[d] = T[d]).
  select_entry<S>(acc, mine, stride, vmn::row_digit(ex, le, ndig - 1));
#pragma unroll 1
  for (int j = ndig - 2; j >= 0; --j) {
    // loaded under the squarings
    const uint32_t dig = vmn::row_digit(ex, le, j);
#pragma unroll 1
    for (int s = 0; s < 4; ++s) vmn::coop_mont_mul<W, TPI>(acc, acc, acc, mm, mp);
    select_entry<S>(fac, mine, stride, dig);
    vmn::coop_mont_mul<W, TPI>(acc, acc, fac, mm, mp);
  }
  if (live) vmn::store_slice<W, TPI>(out + idx * 2 * W, acc);
}

// ------------------------------------------- K7's combine: one product chain
// prod_j P_j^(2^(4j)) over npos positions (row-major (npos, 2W) limbs),
// Horner from the top position: 4 squarings and one product each, 5·npos
// products back to back on one warp.  The accumulator stays in registers;
// P_j is read once, before its 4 squarings.  Launched as one warp: the
// groups past the first (W < 32) compute the same chain and do not store.
template <int W, int TPI>
__global__ void __launch_bounds__(32)
    mont_chain_kernel(const int32_t* __restrict__ P, int32_t* __restrict__ out,
                      const int32_t* __restrict__ m, uint32_t mp, int npos) {
  constexpr int S = W / TPI;
  uint32_t mm[S], acc[S], fac[S];
  vmn::load_slice<W, TPI>(mm, m);
  vmn::load_slice<W, TPI>(acc, P + (int64_t)(npos - 1) * 2 * W);
#pragma unroll 1
  for (int j = npos - 2; j >= 0; --j) {
    vmn::load_slice<W, TPI>(fac, P + (int64_t)j * 2 * W);
#pragma unroll 1
    for (int s = 0; s < 4; ++s) vmn::coop_mont_mul<W, TPI>(acc, acc, acc, mm, mp);
    vmn::coop_mont_mul<W, TPI>(acc, acc, fac, mm, mp);
  }
  if (threadIdx.x < TPI) vmn::store_slice<W, TPI>(out, acc);
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

template <int W, int TPI>
int launch_mul(const int32_t* a, const int32_t* b, int32_t* out,
               const int32_t* m, uint32_t mp, int64_t n, int threads,
               int64_t blocks, cudaStream_t s) {
  if (!vmn::coop_shape_ok<TPI>(threads, blocks)) return kBadShape;
  mont_mul_kernel<W, TPI><<<(unsigned)blocks, threads, 0, s>>>(a, b, out, m,
                                                               mp, n);
  return (int)cudaGetLastError();
}

template <int W, int TPI>
int launch_exp(const int32_t* base, const int32_t* e, int32_t* out,
               const int32_t* m, const int32_t* one, uint32_t mp, int64_t n,
               int le, int ndig, int threads, int64_t blocks,
               cudaStream_t s) {
  if (!vmn::coop_shape_ok<TPI>(threads, blocks) || le < 1 || ndig < 1) {
    return kBadShape;
  }
  const size_t smem = sizeof(uint32_t) * kExpEntries * (W / TPI) * threads;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mont_exp_kernel<W, TPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mont_exp_kernel<W, TPI><<<(unsigned)blocks, threads, smem, s>>>(
      base, e, out, m, one, mp, n, le, ndig);
  return (int)cudaGetLastError();
}

}  // namespace

// Instantiated widths (W = L/2): test256 and P-256 (L=16) and modp2048
// (L=128), the widths that the tests and chip_smoke.py check against the
// plain versions.  A wider group (modp3072: W=96, modp4096: W=128) gets its
// case here with the first cell or test that runs it.
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

// H1 and H2 are instantiated at the (W, TPI) pairs that COOP_TPI in
// ops/mont_kernels.py chooses: H1 at (8, 8), (64, 8), (64, 32), H2 at
// those and (8, 1).
int vmn_mont_mul(int w, int tpi, const int32_t* a, const int32_t* b,
                 int32_t* out, const int32_t* m, uint32_t mp, int64_t n,
                 int threads, int64_t blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VMN_MUL_ARGS a, b, out, m, mp, n, threads, blocks, s
  switch (w << 8 | tpi) {
    case 8 << 8 | 8: return launch_mul<8, 8>(VMN_MUL_ARGS);
    case 64 << 8 | 8: return launch_mul<64, 8>(VMN_MUL_ARGS);
    case 64 << 8 | 32: return launch_mul<64, 32>(VMN_MUL_ARGS);
    default: return kUnsupportedWidth;
  }
#undef VMN_MUL_ARGS
}

int vmn_mont_exp(int w, int tpi, const int32_t* base, const int32_t* e,
                 int32_t* out, const int32_t* m, const int32_t* one,
                 uint32_t mp, int64_t n, int le, int ndig, int threads,
                 int64_t blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VMN_EXP_ARGS base, e, out, m, one, mp, n, le, ndig, threads, blocks, s
  switch (w << 8 | tpi) {
    case 8 << 8 | 1: return launch_exp<8, 1>(VMN_EXP_ARGS);
    case 8 << 8 | 8: return launch_exp<8, 8>(VMN_EXP_ARGS);
    case 64 << 8 | 8: return launch_exp<64, 8>(VMN_EXP_ARGS);
    case 64 << 8 | 32: return launch_exp<64, 32>(VMN_EXP_ARGS);
    default: return kUnsupportedWidth;
  }
#undef VMN_EXP_ARGS
}

// One warp: TPI = 32 at W >= 32, TPI = W below.
int vmn_mont_chain(int w, const int32_t* P, int32_t* out, const int32_t* m,
                   uint32_t mp, int npos, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npos < 1) return kBadShape;
  VMN_FOR_W(w, mont_chain_kernel<W, (W < 32 ? W : 32)><<<1, 32, 0, s>>>(
                   P, out, m, mp, npos));
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

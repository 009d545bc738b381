// Hand-written Hopper kernels for batched elliptic-curve arithmetic,
// bound to Python through a plain C interface (ctypes; see
// ops/ec_kernels.py).
//
//   H5 vmn_ec_smul      replaces K9  ec_scalar_mul_pallas  (ec_kernels.py:277-331)
//   H6 vmn_ec_mexp_tbl  replace both pallas_calls of K10 ec_multiexp_pallas
//      vmn_ec_mexp_acc                                      (:444-570)
//   vmn_ec_chain        the position combine of K10        (:571-584)
//   H7 vmn_ec_fb        replaces K11 ec_fb_exp_pallas      (:667-719)
//   H8 vmn_ec_add       replaces K12 ec_point_add_pallas   (:747-773)
//
// H5 and the chain spread one point over TPI lanes of a warp with the
// cooperative field of ec_coop.cuh; the caller picks TPI among the
// instantiated pairs by the crossovers measured on the card (COOP_TPI in
// ops/mont_kernels.py) and passes the launch shape.  Their operands are
// row-major (n, 2W) 16-bit limbs, so that a group reads its point as one
// contiguous run.  H6-H8 run one point per thread (H6's second launch:
// per lane and digit position), 128 threads a block, on limb-major (L, n)
// int32 16-bit limbs as H3 and H4 read them, with ec.cuh's one-thread
// field.  Each entry point launches on the caller's stream, does not
// synchronise, allocates nothing and returns cudaGetLastError() (or
// kUnsupportedWidth for a width, or a TPI, with no instantiation,
// kBadShape for a launch shape the kernel cannot take).
//
// Constant time (docs/DEVIATIONS.md #5): no kernel indexes a table with a
// secret digit or branches on one; every table entry is read and masked.
#include <cuda_runtime.h>

#include <cstdint>

#include "ec.cuh"
#include "ec_coop.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnsupportedWidth = -1;
constexpr int kBadShape = -2;
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
  vmn::point_add(F, X1, Y1, Z1, X1, Y1, Z1, X2, Y2, Z2);
  vmn::store_words<W>(ox, X1, n, e);
  vmn::store_words<W>(oy, Y1, n, e);
  vmn::store_words<W>(oz, Z1, n, e);
}

// ------------------------------------------------- H5: scalar multiple
// One point per group of TPI lanes of a warp (ec_coop.cuh), each lane
// holding S = W/TPI words of every coordinate.  Per point: the 16
// Jacobian multiples d·P (entry 0 is infinity: X = 0, Y = one, Z = 0),
// then ndig windows from the most significant: 4 doublings, a masked
// select over all 16 entries (never an index by the secret digit), one
// addition.
//
// The table is 48·S words a lane.  It lies in shared memory, laid out
// [entry][coord][word][thread of the block] as H2's is: for one (entry,
// coord, word) the 32 lanes of a warp touch 32 consecutive words, so no
// bank conflicts, and each thread reads only what it wrote (no barrier).
// The select reads 48·S words a window against the window's 56 products,
// and leaves the registers to the products: held in registers, the table
// would add 48·S of them to every thread (96 at TPI 4), and registers,
// not the 192·S bytes of shared memory a thread, would then bound the
// points resident on an SM.  The previous kernel (one thread a point)
// kept the table in local memory and read all of it back every window.
//
// What bounds it on the H100: a small batch is one point's ~3,900
// dependent products (the point formulas run them as pairs, F.mul2, so
// that one hides the other's latency), so TPI 4 is fastest there; a full
// card is bound by the integer pipe (64 lanes a clock an SM), where a
// product spread over lanes issues about twice the instructions of the
// one-thread CIOS product (a row of half-products is two instructions
// each, plus the shuffles and the shift of every step, and the ballots
// of every field addition), so TPI 2 is fastest there and slower than
// the one-thread kernel it replaced.  A one-thread form with its 1.5 KB
// table in shared memory fits 4 warps an SM and spills (measured, PERF.md
// §6).  ptxas (sm_90a): TPI 4 / 2 64 / 96 registers, no stack frame, no
// spill.
template <int W, int TPI>
__global__ void __launch_bounds__(kThreads)
    ec_smul_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                   const uint8_t* __restrict__ inf, const int32_t* __restrict__ e,
                   int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                   int32_t* __restrict__ oz, const int32_t* __restrict__ m,
                   const int32_t* __restrict__ one, uint32_t mp, int64_t n,
                   int le, int ndig) {
  constexpr int S = W / TPI;
  extern __shared__ uint32_t smul_tbl[];  // [kEntries][3][S][blockDim.x]
  bool live;
  const int64_t idx = vmn::group_element<TPI>(n, &live);
  const int stride = (int)blockDim.x;
  uint32_t* mine = smul_tbl + threadIdx.x;
  uint32_t mm[S], o[S], X1[S], Y1[S], Z1[S];
  vmn::load_slice<W, TPI>(mm, m);
  vmn::load_slice<W, TPI>(o, one);
  vmn::load_slice<W, TPI>(X1, x + idx * 2 * W);
  vmn::load_slice<W, TPI>(Y1, y + idx * 2 * W);
  const uint32_t pinf = 0u - (uint32_t)(inf[idx] != 0);
  const vmn::CoopField<W, TPI> F{mm, mp};
  uint32_t aX[S], aY[S], aZ[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    Z1[k] = o[k] & ~pinf;
    mine[(0 * S + k) * stride] = 0;  // entry 0
    mine[(1 * S + k) * stride] = o[k];
    mine[(2 * S + k) * stride] = 0;
    mine[(3 * S + k) * stride] = X1[k];  // entry 1
    mine[(4 * S + k) * stride] = Y1[k];
    mine[(5 * S + k) * stride] = Z1[k];
    aX[k] = X1[k];
    aY[k] = Y1[k];
    aZ[k] = Z1[k];
  }
#pragma unroll 1
  for (int d = 2; d < kEntries; ++d) {
    vmn::point_add(F, aX, aY, aZ, aX, aY, aZ, X1, Y1, Z1);
    uint32_t* row = mine + d * 3 * S * stride;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      row[k * stride] = aX[k];
      row[(S + k) * stride] = aY[k];
      row[(2 * S + k) * stride] = aZ[k];
    }
  }

  vmn::set_zero<S>(aX);
  vmn::copy<S>(aY, o);
  vmn::set_zero<S>(aZ);
  const int32_t* ex = e + idx * le;
  uint32_t fX[S], fY[S], fZ[S];
#pragma unroll 1
  for (int j = ndig - 1; j >= 0; --j) {
    const uint32_t dig = vmn::row_digit(ex, le, j);  // loaded under the doublings
#pragma unroll 1
    for (int s = 0; s < 4; ++s) vmn::point_double(F, aX, aY, aZ, aX, aY, aZ);
    vmn::set_zero<S>(fX);
    vmn::set_zero<S>(fY);
    vmn::set_zero<S>(fZ);
#pragma unroll 1  // rolled: unrolled, its 48·S loads would all be live
    for (int d = 0; d < kEntries; ++d) {
      const uint32_t mask = 0u - (uint32_t)(dig == (uint32_t)d);
      const uint32_t* row = mine + d * 3 * S * stride;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        fX[k] |= row[k * stride] & mask;
        fY[k] |= row[(S + k) * stride] & mask;
        fZ[k] |= row[(2 * S + k) * stride] & mask;
      }
    }
    vmn::point_add(F, aX, aY, aZ, aX, aY, aZ, fX, fY, fZ);
  }
  if (live) {
    vmn::store_slice<W, TPI>(ox + idx * 2 * W, aX);
    vmn::store_slice<W, TPI>(oy + idx * 2 * W, aY);
    vmn::store_slice<W, TPI>(oz + idx * 2 * W, aZ);
  }
}

// --------------------------------------- K10's combine: one point chain
// sum_j 2^(4j)·S_j over npos Jacobian positions (three row-major (npos, 2W)
// limb arrays), Horner from the top position: 4 doublings and one
// addition each, 5·npos point operations back to back on one warp, where
// a loop over H8 would launch 5·npos single-point batches.  The doubling
// is point_double_as_add (ec_coop.cuh): the limbs of P + P, which the
// plain version computes, at a third of the products.  The accumulator
// stays in registers; S_j is read once, before its doublings.  A chain of
// dependent point operations: bound by their latency, not by the card's
// throughput; the paired products of the formulas halve the rounds of a
// point operation.  Launched as one warp: the groups past the first
// (TPI < 32) compute the same chain and do not store.  ptxas (sm_90a):
// 48 registers at TPI 8, no stack frame, no spill.
template <int W, int TPI>
__global__ void __launch_bounds__(32)
    ec_chain_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                    const int32_t* __restrict__ pz, int32_t* __restrict__ ox,
                    int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                    const int32_t* __restrict__ m,
                    const int32_t* __restrict__ one, uint32_t mp, int npos) {
  constexpr int S = W / TPI;
  uint32_t mm[S], aX[S], aY[S], aZ[S], fX[S], fY[S], fZ[S];
  vmn::load_slice<W, TPI>(mm, m);
  const vmn::CoopField<W, TPI> F{mm, mp};
  vmn::set_zero<S>(aX);
  vmn::load_slice<W, TPI>(aY, one);
  vmn::set_zero<S>(aZ);
#pragma unroll 1
  for (int j = npos - 1; j >= 0; --j) {
    vmn::load_slice<W, TPI>(fX, px + (int64_t)j * 2 * W);
    vmn::load_slice<W, TPI>(fY, py + (int64_t)j * 2 * W);
    vmn::load_slice<W, TPI>(fZ, pz + (int64_t)j * 2 * W);
#pragma unroll 1
    for (int s = 0; s < 4; ++s) vmn::point_double_as_add(F, aX, aY, aZ);
    vmn::point_add(F, aX, aY, aZ, aX, aY, aZ, fX, fY, fZ);
  }
  if (threadIdx.x < TPI) {
    vmn::store_slice<W, TPI>(ox, aX);
    vmn::store_slice<W, TPI>(oy, aY);
    vmn::store_slice<W, TPI>(oz, aZ);
  }
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
    vmn::point_add(F, aX, aY, aZ, aX, aY, aZ, X1, Y1, Z1);
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
    vmn::point_add(F, aX, aY, aZ, aX, aY, aZ, fX, fY, fZ);
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
      vmn::point_add(F, aX, aY, aZ, aX, aY, aZ, fX, fY, fZ);
    }
  }
  if (live) {
    vmn::store_words<W>(ox, aX, n, idx);
    vmn::store_words<W>(oy, aY, n, idx);
    vmn::store_words<W>(oz, aZ, n, idx);
  }
}

template <int W, int TPI>
int launch_smul(const int32_t* x, const int32_t* y, const uint8_t* inf,
                const int32_t* e, int32_t* ox, int32_t* oy, int32_t* oz,
                const int32_t* m, const int32_t* one, uint32_t mp, int64_t n,
                int le, int ndig, int threads, int64_t blocks,
                cudaStream_t s) {
  if (!vmn::coop_shape_ok<TPI>(threads, blocks) || le < 1 || ndig < 1) {
    return kBadShape;
  }
  const size_t smem = sizeof(uint32_t) * kEntries * 3 * (W / TPI) * threads;
  if (smem > 48 * 1024) {  // 96 KB at TPI 2: opt in above the default
    cudaError_t err = cudaFuncSetAttribute(
        ec_smul_kernel<W, TPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ec_smul_kernel<W, TPI><<<(unsigned)blocks, threads, smem, s>>>(
      x, y, inf, e, ox, oy, oz, m, one, mp, n, le, ndig);
  return (int)cudaGetLastError();
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

// H5 at (W, TPI) = (8, 2), (8, 4): the pairs that COOP_TPI in
// ops/mont_kernels.py can choose.
int vmn_ec_smul(int w, int tpi, const int32_t* x, const int32_t* y,
                const uint8_t* inf, const int32_t* e, int32_t* ox, int32_t* oy,
                int32_t* oz, const int32_t* m, const int32_t* one, uint32_t mp,
                int64_t n, int le, int ndig, int threads, int64_t blocks,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VMN_SMUL_ARGS x, y, inf, e, ox, oy, oz, m, one, mp, n, le, ndig, \
                      threads, blocks, s
  switch (w << 8 | tpi) {
    case 8 << 8 | 2: return launch_smul<8, 2>(VMN_SMUL_ARGS);
    case 8 << 8 | 4: return launch_smul<8, 4>(VMN_SMUL_ARGS);
    default: return kUnsupportedWidth;
  }
#undef VMN_SMUL_ARGS
}

// The combine at (W, TPI) = (8, 8), one warp: of TPI 1, 2, 4 and 8 the
// fastest at 16 and 64 positions (kernel_timing.py --sweep, PERF.md §6).
int vmn_ec_chain(int w, int tpi, const int32_t* px, const int32_t* py,
                 const int32_t* pz, int32_t* ox, int32_t* oy, int32_t* oz,
                 const int32_t* m, const int32_t* one, uint32_t mp, int npos,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npos < 1) return kBadShape;
  if ((w << 8 | tpi) != (8 << 8 | 8)) return kUnsupportedWidth;
  ec_chain_kernel<8, 8><<<1, 32, 0, s>>>(px, py, pz, ox, oy, oz, m, one, mp,
                                         npos);
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

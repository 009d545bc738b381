// Hand-written Hopper kernels for batched elliptic-curve arithmetic,
// bound to Python through a plain C interface (ctypes; see
// ops/ec_kernels.py).
//
//   H5 vmn_ec_smul      replaces K9  ec_scalar_mul_pallas  (ec_kernels.py:277-331)
//   H6 vmn_ec_mexp      replaces both pallas_calls of K10 ec_multiexp_pallas
//                                                           (:444-570)
//   vmn_ec_chain        the position combine of K10        (:571-584)
//   H7 vmn_ec_fb        replaces K11 ec_fb_exp_pallas      (:667-719)
//   H8 vmn_ec_add       replaces K12 ec_point_add_pallas   (:747-773)
//
// H5, H8 and the chain spread one point over TPI lanes of a warp with the
// cooperative field of ec_coop.cuh; the caller picks TPI among the
// instantiated pairs by the crossovers measured on the card (COOP_TPI in
// ops/mont_kernels.py) and passes the launch shape.  Their operands are
// row-major (n, 2W) 16-bit limbs, so that a group reads its point as one
// contiguous run.  H6 runs one point, or one (digit position, sub-chunk),
// per thread on the same row-major operands, with ec.cuh's one-thread
// field (its design below).  H7 runs one point per thread, 128 threads a
// block, on limb-major (L, n) int32 16-bit limbs, with the one-thread
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
// One Jacobian addition per pair (ec.cuh's branchless point_add: its
// doubling branch is taken exactly when H = R = 0, so P + P is a
// doubling) on TPI lanes of a warp with the cooperative field of
// ec_coop.cuh, every coordinate's slice in registers, as H5 runs its
// additions.  Operands are row-major (n, 2W) limbs, as H5 reads them: a
// group reads a point's coordinate as one contiguous run, and no operand
// is copied to another layout.  TPI by the batch size (COOP_TPI): 8 lanes
// for a small batch, whose latency is one pair's 24 dependent products
// (the formulas run them in pairs, F.mul2), 2 for a full card.
//
// What bounds it: 24 products a pair (16 of the addition, 8 of the
// doubling branch that the constant-time form always computes), where the
// bound counts 16; at 2^17 pairs the integer pipe, at the rate of H6's
// one-thread product (PERF.md §6).  Tried on the H100 and dropped: one
// thread a pair with its operands in shared memory (H6's discipline),
// which spilled at 128 and at 168 registers and ran 27 % slower at 2^17
// pairs and three times slower on one; TPI 2 held to 96 or 80 registers
// (20 or 24 warps an SM), slower at 2^17.  ptxas
// (sm_90a): TPI 2 / 4 / 8 107 / 68 / 47 registers, no stack frame, no
// spill.
template <int W, int TPI>
__global__ void __launch_bounds__(kThreads, 4)
    ec_add_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                  const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
                  const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
                  int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                  int32_t* __restrict__ oz, const int32_t* __restrict__ m,
                  uint32_t mp, int64_t n) {
  constexpr int S = W / TPI;
  bool live;
  const int64_t e = vmn::group_element<TPI>(n, &live);
  uint32_t mm[S], X1[S], Y1[S], Z1[S], X2[S], Y2[S], Z2[S];
  vmn::load_slice<W, TPI>(mm, m);
  vmn::load_slice<W, TPI>(X1, x1 + e * 2 * W);
  vmn::load_slice<W, TPI>(Y1, y1 + e * 2 * W);
  vmn::load_slice<W, TPI>(Z1, z1 + e * 2 * W);
  vmn::load_slice<W, TPI>(X2, x2 + e * 2 * W);
  vmn::load_slice<W, TPI>(Y2, y2 + e * 2 * W);
  vmn::load_slice<W, TPI>(Z2, z2 + e * 2 * W);
  const vmn::CoopField<W, TPI> F{mm, mp};
  vmn::point_add(F, X1, Y1, Z1, X1, Y1, Z1, X2, Y2, Z2);
  if (live) {
    vmn::store_slice<W, TPI>(ox + e * 2 * W, X1);
    vmn::store_slice<W, TPI>(oy + e * 2 * W, Y1);
    vmn::store_slice<W, TPI>(oz + e * 2 * W, Z1);
  }
}

template <int TPI>
int launch_add(const int32_t* x1, const int32_t* y1, const int32_t* z1,
               const int32_t* x2, const int32_t* y2, const int32_t* z2,
               int32_t* ox, int32_t* oy, int32_t* oz, const int32_t* m,
               uint32_t mp, int64_t n, int threads, int64_t blocks,
               cudaStream_t s) {
  if (!vmn::coop_shape_ok<TPI>(threads, blocks)) return kBadShape;
  ec_add_kernel<8, TPI><<<(unsigned)blocks, threads, 0, s>>>(
      x1, y1, z1, x2, y2, z2, ox, oy, oz, m, mp, n);
  return (int)cudaGetLastError();
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
// S_j = sum_i d_ij·P_i for every 4-bit digit position j < npos, as
// partial sums that the caller joins (H8 lane tree) and combines
// (ec_multiexp_combine).  One launch; no point's table goes through
// device memory.  A block of kMexpThreads threads walks the chunks of
// kMexpChunk points b, b + G, b + 2G, ... (G blocks): its first two warps
// (the builders) build the next chunk's tables while the other ten (the
// folders) fold the current chunk from the other buffer; one barrier a
// chunk.
//
// * Builder c < kMexpChunk of chunk k takes point kC + c: its multiples
//   d·P, d = 1..15, entry d = entry d-1 + P by point_add, the plain
//   version's formula sequence (entry 0, infinity, is not stored).  Shared
//   layout [buffer][point][entry][coord][word], 45·W + 4 words a point:
//   the 4 words of padding make the builders' 16-byte stores
//   conflict-free.
// * Folder f takes digit position j = f mod npos and sub-chunk s =
//   f / npos (subs = max(1, kMexpFolders / npos) of them; 5 at 64
//   positions): it folds points s, s + subs, ... of each chunk into its
//   Jacobian partial, reading the point's 4-bit digit j once and
//   masked-selecting its factor over all 16 entries (never an index by
//   the secret digit).  The folders of a warp share s, so they read the
//   same words at the same time: a broadcast.
// * Partial q = b·subs + s of position j goes to out (3, npos, G·subs, L),
//   row-major.  The plain version folds in exactly this order.
//
// What bounds it: a point's 14 table additions and, per position, one
// addition (24 products each in the branchless form, where the bound
// counts 16).  The one-thread field (ec.cuh) issues about half the
// instructions of the cooperative one (H5, PERF.md §6), so each thread
// owns a point or a (position, sub-chunk).  A point's 1.5 KB table stays
// in shared memory: in device memory it would be 201 MB at 2^17 points,
// read again for each of the 64 positions.
//
// Registers: __launch_bounds__(384, 1) holds them at 168, so that an SM
// keeps 12 warps; the addition's temporaries and two products fill that
// budget.  So every operand that outlives a product lives in shared
// memory: a builder reads entry d-1 and P back from its table, a folder
// keeps its running sum and factor there (6·W + 1 words, an odd stride:
// no bank conflict), and the field (Field<W, true>) runs its two
// products one after the other, each behind a fence (a compiler fence
// and __syncwarp), so that nothing is held across them.  That costs
// time: 14.0 ms at 2^17 points against 12.1 ms for the running sum in
// registers, which spilled 144 B (H100, PERF.md §6).  The tables and the
// slots fill 221 KB of the SM's 227 KB, which sets the chunk at 56 points.
constexpr int kMexpChunk = 56;
constexpr int kMexpBuilders = 64;
constexpr int kMexpFolders = 320;
constexpr int kMexpThreads = kMexpBuilders + kMexpFolders;

template <int W>
__host__ __device__ constexpr int mexp_point_words() {
  return 45 * W + 4;
}

template <int W>
__host__ __device__ constexpr int mexp_slot_words() {
  return 6 * W + 1;  // a folder's running sum and factor
}

template <int W>
__host__ __device__ constexpr size_t mexp_shared_bytes() {
  return sizeof(uint32_t) * (2 * kMexpChunk * mexp_point_words<W>() +
                             kMexpFolders * mexp_slot_words<W>());
}

// dst[0..W) = src, as 16-byte stores (dst 16-byte aligned, W % 4 == 0).
template <int W>
__device__ __forceinline__ void put_words(uint32_t* dst, const uint32_t* src) {
#pragma unroll
  for (int k = 0; k < W; k += 4) {
    *reinterpret_cast<uint4*>(dst + k) =
        make_uint4(src[k], src[k + 1], src[k + 2], src[k + 3]);
  }
}

// r |= src & mask over W words read as 16-byte loads.
template <int W>
__device__ __forceinline__ void or_masked(uint32_t* r, const uint32_t* src,
                                          uint32_t mask) {
#pragma unroll
  for (int k = 0; k < W; k += 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + k);
    r[k] |= v.x & mask;
    r[k + 1] |= v.y & mask;
    r[k + 2] |= v.z & mask;
    r[k + 3] |= v.w & mask;
  }
}

template <int W>
__global__ void __launch_bounds__(kMexpThreads, 1)
    ec_mexp_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                   const uint8_t* __restrict__ inf, const int32_t* __restrict__ e,
                   int32_t* __restrict__ out, const int32_t* __restrict__ m,
                   const int32_t* __restrict__ one, uint32_t mp, int64_t n,
                   int le, int npos, int subs) {
  constexpr int kPW = mexp_point_words<W>();
  constexpr int kBuf = kMexpChunk * kPW;
  constexpr int kCW = 3 * W;  // words of one entry
  // [2][kBuf] tables, then the folders' slots
  extern __shared__ __align__(16) uint32_t mexp_tbl[];
  __shared__ uint32_t sm[W], so[W];
  vmn::load_vec_shared<W>(sm, m);
  vmn::load_vec_shared<W>(so, one);
  __syncthreads();
  const vmn::Field<W, true> F{sm, mp};
  const int64_t nchunks = (n + kMexpChunk - 1) / kMexpChunk;
  const int G = (int)gridDim.x;
  const int tid = (int)threadIdx.x;
  const bool builder = tid < kMexpBuilders;  // whole warps
  const int f = tid - kMexpBuilders;
  const bool folder = !builder && f < npos * subs;
  const int j = folder ? f % npos : 0;
  const int s = folder ? f / npos : 0;

  // Builder: the 15 stored multiples of point k·C + tid into buffer buf.
  auto build = [&](int64_t k, uint32_t* buf) {
    const int64_t i = k * kMexpChunk + tid;
    if (tid >= kMexpChunk || i >= n) return;
    uint32_t X1[W], Y1[W], Z1[W], aX[W], aY[W], aZ[W];
    vmn::load_slice<W, 1>(X1, x + i * 2 * W);
    vmn::load_slice<W, 1>(Y1, y + i * 2 * W);
    const uint32_t pinf = 0u - (uint32_t)(inf[i] != 0);
#pragma unroll
    for (int k2 = 0; k2 < W; ++k2) Z1[k2] = so[k2] & ~pinf;
    uint32_t* row = buf + tid * kPW;
    put_words<W>(row, X1);
    put_words<W>(row + W, Y1);
    put_words<W>(row + 2 * W, Z1);
#pragma unroll 1
    for (int d = 2; d < kEntries; ++d) {
      const uint32_t* prev = row + (d - 2) * kCW;
      vmn::point_add(F, aX, aY, aZ, prev, prev + W, prev + 2 * W, row,
                     row + W, row + 2 * W);
      uint32_t* r = row + (d - 1) * kCW;
      put_words<W>(r, aX);
      put_words<W>(r + W, aY);
      put_words<W>(r + 2 * W, aZ);
    }
  };

  // Folder: its running sum A and factor Q in its slot.
  uint32_t* Q = mexp_tbl + 2 * kBuf + (folder ? f : 0) * mexp_slot_words<W>();
  uint32_t* A = Q + kCW;
  if (folder) {
    vmn::set_zero<W>(A);
    vmn::copy<W>(A + W, so);
    vmn::set_zero<W>(A + 2 * W);
  }
  // Folder: points s, s + subs, ... of chunk k (buffer buf) into A.
  auto fold = [&](int64_t k, const uint32_t* buf) {
    const int64_t base = k * kMexpChunk;
    const int cnt = n - base < kMexpChunk ? (int)(n - base) : kMexpChunk;
#pragma unroll 1
    for (int c = s; c < cnt; c += subs) {
      const uint32_t dig = vmn::row_digit(e + (base + c) * le, le, j);
      uint32_t fX[W], fY[W], fZ[W];
      const uint32_t at0 = 0u - (uint32_t)(dig == 0u);  // entry 0: infinity
      vmn::set_zero<W>(fX);
#pragma unroll
      for (int k2 = 0; k2 < W; ++k2) fY[k2] = so[k2] & at0;
      vmn::set_zero<W>(fZ);
      const uint32_t* row = buf + c * kPW;
#pragma unroll 1
      for (int d = 1; d < kEntries; ++d) {
        const uint32_t mask = 0u - (uint32_t)(dig == (uint32_t)d);
        const uint32_t* r = row + (d - 1) * kCW;
        or_masked<W>(fX, r, mask);
        or_masked<W>(fY, r + W, mask);
        or_masked<W>(fZ, r + 2 * W, mask);
      }
      vmn::copy<W>(Q, fX);
      vmn::copy<W>(Q + W, fY);
      vmn::copy<W>(Q + 2 * W, fZ);
      vmn::point_add(F, A, A + W, A + 2 * W, A, A + W, A + 2 * W, Q, Q + W,
                     Q + 2 * W);
    }
  };

  // Round `it` folds chunk k from buffer it mod 2 while chunk k + G is
  // built into the other; round -1 only builds the block's first chunk.
  int it = -1;
#pragma unroll 1
  for (int64_t k = (int64_t)blockIdx.x - G; k < nchunks; k += G, ++it) {
    if (builder) {
      if (k + G < nchunks) build(k + G, mexp_tbl + ((it + 1) & 1) * kBuf);
    } else if (folder && k >= 0) {
      fold(k, mexp_tbl + (it & 1) * kBuf);
    }
    __syncthreads();
  }
  if (folder) {
    const int64_t parts = (int64_t)G * subs;
    const int64_t q = (int64_t)blockIdx.x * subs + s;
    const int64_t plane = (int64_t)npos * parts * 2 * W;
    int32_t* o = out + ((int64_t)j * parts + q) * 2 * W;
    vmn::store_slice<W, 1>(o, A);
    vmn::store_slice<W, 1>(o + plane, A + W);
    vmn::store_slice<W, 1>(o + 2 * plane, A + 2 * W);
  }
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

// H8 at (W, TPI) = (8, 2), (8, 4), (8, 8): the pairs that
// COOP_TPI["ec_point_add", 8] in ops/mont_kernels.py can choose.
int vmn_ec_add(int w, int tpi, const int32_t* x1, const int32_t* y1,
               const int32_t* z1, const int32_t* x2, const int32_t* y2,
               const int32_t* z2, int32_t* ox, int32_t* oy, int32_t* oz,
               const int32_t* m, uint32_t mp, int64_t n, int threads,
               int64_t blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VMN_ADD_ARGS x1, y1, z1, x2, y2, z2, ox, oy, oz, m, mp, n, threads, \
                     blocks, s
  switch (w << 8 | tpi) {
    case 8 << 8 | 2: return launch_add<2>(VMN_ADD_ARGS);
    case 8 << 8 | 4: return launch_add<4>(VMN_ADD_ARGS);
    case 8 << 8 | 8: return launch_add<8>(VMN_ADD_ARGS);
    default: return kUnsupportedWidth;
  }
#undef VMN_ADD_ARGS
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

// H6 over G = `blocks` blocks of kMexpThreads threads; `subs` folders a
// digit position (ec_multiexp_positions' mexp_shape).
int vmn_ec_mexp(int w, const int32_t* x, const int32_t* y, const uint8_t* inf,
                const int32_t* e, int32_t* out, const int32_t* m,
                const int32_t* one, uint32_t mp, int64_t n, int le, int npos,
                int subs, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || le < 1 || npos < 1 || subs < 1 || npos * subs > kMexpFolders ||
      blocks < 1 || (int64_t)blocks * kMexpChunk >= n + kMexpChunk) {
    return kBadShape;
  }
  if (w != 8) return kUnsupportedWidth;
  constexpr int W = 8;
  const size_t smem = mexp_shared_bytes<W>();
  cudaError_t err = cudaFuncSetAttribute(
      ec_mexp_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ec_mexp_kernel<W><<<(unsigned)blocks, kMexpThreads, smem, s>>>(
      x, y, inf, e, out, m, one, mp, n, le, npos, subs);
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

// The EC kernels and their launchers (see ec_kernels.cu for what each
// replaces), in namespace vmn_ec.  Each launcher is a member of a class
// template of ec_launch.cuh, defined here and instantiated by the source
// file of its width (ec_w8.cu, ec_mexp_w8.cu, ec_w12.cu, ec_mexp_w12.cu),
// so that nvcc builds the widths, and H6 apart, in parallel processes.
//
// Constant time (docs/DEVIATIONS.md #5): no kernel indexes a table with a
// secret digit or branches on one; every table entry is read and masked.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "ec.cuh"
#include "ec_coop.cuh"
#include "ec_launch.cuh"

namespace vmn_ec {

constexpr int kThreads = 128;
constexpr int kEntries = 16;  // 4-bit windows
constexpr int kBlockShared = 232448;  // the 227 KB a block may opt in to

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
// (sm_90a) at W = 8: TPI 2 / 4 / 8 107 / 68 / 47 registers, at W = 12 TPI
// 4 84, at W' = 20 (P-521) TPI 4 123; no stack frame, no spill.  At
// W = 12, TPI 2 (142 registers under a bound of 255) was slower than TPI 4
// at every batch and is not built; at W' = 20 TPI 2 spilled 492 bytes
// under its bound of 128 registers and was slower at every batch.
template <int W, int TPI>
__global__ void __launch_bounds__(kThreads, 4)
    ec_add_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                  const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
                  const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
                  int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                  int32_t* __restrict__ oz, const int32_t* __restrict__ m,
                  uint32_t mp, const int32_t* __restrict__ c_in,
                  const int32_t* __restrict__ c_out, int64_t n) {
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
  vmn::coop_rebase3<W, TPI>(X1, Y1, Z1, c_in, mm, mp);
  vmn::coop_rebase3<W, TPI>(X2, Y2, Z2, c_in, mm, mp);
  const vmn::CoopField<W, TPI> F{mm, mp};
  vmn::point_add(F, X1, Y1, Z1, X1, Y1, Z1, X2, Y2, Z2);
  vmn::coop_rebase3<W, TPI>(X1, Y1, Z1, c_out, mm, mp);
  if (live) {
    vmn::store_slice<W, TPI>(ox + e * 2 * W, X1);
    vmn::store_slice<W, TPI>(oy + e * 2 * W, Y1);
    vmn::store_slice<W, TPI>(oz + e * 2 * W, Z1);
  }
}

template <int W, int TPI>
int Add<W, TPI>::launch(const int32_t* x1, const int32_t* y1,
                        const int32_t* z1, const int32_t* x2,
                        const int32_t* y2, const int32_t* z2, int32_t* ox,
                        int32_t* oy, int32_t* oz, const int32_t* m,
                        uint32_t mp, const int32_t* c_in,
                        const int32_t* c_out, int64_t n, int threads,
                        int64_t blocks, cudaStream_t s) {
  if (!vmn::coop_shape_ok<TPI>(threads, blocks)) return kBadShape;
  ec_add_kernel<W, TPI><<<(unsigned)blocks, threads, 0, s>>>(
      x1, y1, z1, x2, y2, z2, ox, oy, oz, m, mp, c_in, c_out, n);
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
// §6).  ptxas (sm_90a) at W = 8: TPI 4 / 2 64 / 96 registers, at W = 12
// TPI 4 84, at W' = 20 TPI 4 128; no stack frame, no spill.  At W' = 20
// the table is 120 KB a block of 128 threads (one block an SM).  At W = 12 the table is 72 KB a
// block of 128 threads at TPI 4 (three blocks an SM) and 144 KB at TPI 2
// (one), which measured slower at every batch (151.5 against 103.1 ms at
// 2^17 points) and is not built; at TPI 1 it would be 288 KB, more than a
// block may use.
template <int W, int TPI>
__global__ void __launch_bounds__(kThreads)
    ec_smul_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                   const uint8_t* __restrict__ inf, const int32_t* __restrict__ e,
                   int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                   int32_t* __restrict__ oz, const int32_t* __restrict__ m,
                   const int32_t* __restrict__ one, uint32_t mp,
                   const int32_t* __restrict__ c_in,
                   const int32_t* __restrict__ c_out, int64_t n, int le,
                   int ndig) {
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
  vmn::coop_rebase<W, TPI>(X1, c_in, mm, mp);
  vmn::coop_rebase<W, TPI>(Y1, c_in, mm, mp);
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
  vmn::coop_rebase3<W, TPI>(aX, aY, aZ, c_out, mm, mp);
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
// 48 registers at TPI 8, 124 at W' = 20 TPI 4 (with the boundary
// conversion of each position), no stack frame, no spill.
template <int W, int TPI>
__global__ void __launch_bounds__(32)
    ec_chain_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                    const int32_t* __restrict__ pz, int32_t* __restrict__ ox,
                    int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                    const int32_t* __restrict__ m,
                    const int32_t* __restrict__ one, uint32_t mp,
                    const int32_t* __restrict__ c_in,
                    const int32_t* __restrict__ c_out, int npos) {
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
    vmn::coop_rebase3<W, TPI>(fX, fY, fZ, c_in, mm, mp);
#pragma unroll 1
    for (int s = 0; s < 4; ++s) vmn::point_double_as_add(F, aX, aY, aZ);
    vmn::point_add(F, aX, aY, aZ, aX, aY, aZ, fX, fY, fZ);
  }
  vmn::coop_rebase3<W, TPI>(aX, aY, aZ, c_out, mm, mp);
  if (threadIdx.x < TPI) {
    vmn::store_slice<W, TPI>(ox, aX);
    vmn::store_slice<W, TPI>(oy, aY);
    vmn::store_slice<W, TPI>(oz, aZ);
  }
}

template <int W, int TPI>
int Chain<W, TPI>::launch(const int32_t* px, const int32_t* py,
                          const int32_t* pz, int32_t* ox, int32_t* oy,
                          int32_t* oz, const int32_t* m, const int32_t* one,
                          uint32_t mp, const int32_t* c_in,
                          const int32_t* c_out, int npos, cudaStream_t s) {
  if (npos < 1) return kBadShape;
  ec_chain_kernel<W, TPI><<<1, 32, 0, s>>>(px, py, pz, ox, oy, oz, m, one, mp,
                                           c_in, c_out, npos);
  return (int)cudaGetLastError();
}

// ------------------------------------------- H6: multi-exponentiation
// S_j = sum_i d_ij·P_i for every 4-bit digit position j < npos, as
// partial sums that the caller joins (H8 lane tree) and combines
// (ec_multiexp_combine).  One launch; no point's table goes through
// device memory.  A block of MexpShape<W>::kThreads threads walks the
// chunks of kChunk points b, b + G, b + 2G, ... (G blocks): its first two
// warps (the builders) build the next chunk's tables while the others (the
// folders, ten warps at W = 8) fold the current chunk from the other
// buffer; one barrier a chunk.
//
// * Builder c < kChunk of chunk k takes point kC + c: its multiples
//   d·P, d = 1..15, entry d = entry d-1 + P by point_add, the plain
//   version's formula sequence (entry 0, infinity, is not stored).  Shared
//   layout [buffer][point][entry][coord][word], 45·W + 4 words a point:
//   the 4 words of padding make the builders' 16-byte stores
//   conflict-free.
// * Folder f takes digit position j = f mod npos and sub-chunk s =
//   f / npos (subs = max(1, kFolders / npos) of them; 5 at 64
//   positions and W = 8): it folds points s, s + subs, ... of each chunk into its
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
//
// The shape at each width (MEXP_SHAPES in ops/ec_kernels.py): builders,
// folders, points a chunk.  At W = 12 (P-384) a point's table is 2.1 KB
// and a product's operands half as large again: at the W = 8 shape (384
// threads, 168 registers, 31 points a chunk) ptxas spills 156 bytes a
// thread, so the block keeps 192 folders (six warps) under a bound of 255
// registers (256 threads, 8 warps an SM), which it uses with no stack
// frame and no spill, and 40 points a chunk fill what the slots leave of
// the 227 KB (H100, PERF.md §6).
//
// A padded modulus (Modulus in ops/mont_kernels.py; c_in and c_out not
// NULL) at a width of this form: P-224, L = 14 limbs on the P-256 shape
// at W' = 8.  The constants lie in shared memory beside the modulus and
// the kernel's one; each builder takes its point's x and y to the
// kernel's radix (two products by c_in) before it builds the table, and
// each folder its (X, Y, Z) sum back (three products by c_out) before it
// stores: two products a point and three a partial, where a point's
// table and folds take about 1000.  A point at infinity stays infinity
// (Z = 0), and the sums keep the plain version's limbs.  The products
// run on the same fenced field, so the register bound holds: ptxas
// (sm_90a) gives ec_mexp_kernel<8> 166 registers, no stack frame, no
// spill (PERF.md §6).
//
// At P-521's padded width (L = 33 limbs in W' words) one thread a
// point cannot hold a product's operands: the addition's temporaries
// alone are ~19·W words, past 255 registers from W = 14 on.  There H6 is
// ec_mexp_coop_kernel below: the same builders and folders, each a group
// of kTPI lanes with the cooperative field (ec_coop.cuh), kBuilders and
// kFolders counting groups.
template <int W>
struct MexpShape;

template <>
struct MexpShape<8> {
  static constexpr int kTPI = 1;
  static constexpr int kBuilders = 64, kFolders = 320, kChunk = 56;
  static constexpr int kThreads = kBuilders + kFolders;
};

template <>
struct MexpShape<12> {
  static constexpr int kTPI = 1;
  static constexpr int kBuilders = 64, kFolders = 192, kChunk = 40;
  static constexpr int kThreads = kBuilders + kFolders;
};

template <>
struct MexpShape<20> {
  static constexpr int kTPI = 4;
  static constexpr int kBuilders = 16, kFolders = 80, kChunk = 16;
  static constexpr int kThreads = (kBuilders + kFolders) * kTPI;
};

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
  using Sh = MexpShape<W>;
  return sizeof(uint32_t) * (2 * Sh::kChunk * mexp_point_words<W>() +
                             Sh::kFolders * mexp_slot_words<W>());
}

// The cooperative form's shared memory: the two chunk buffers and a
// running sum (3·W words) for each of the `rounds`·kFolders items.
template <int W>
__host__ __device__ constexpr size_t mexp_coop_shared_bytes(int rounds) {
  using Sh = MexpShape<W>;
  return sizeof(uint32_t) * (2 * Sh::kChunk * mexp_point_words<W>() +
                             (size_t)rounds * Sh::kFolders * 3 * W);
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
__global__ void __launch_bounds__(MexpShape<W>::kThreads, 1)
    ec_mexp_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                   const uint8_t* __restrict__ inf, const int32_t* __restrict__ e,
                   int32_t* __restrict__ out, const int32_t* __restrict__ m,
                   const int32_t* __restrict__ one, uint32_t mp,
                   const int32_t* __restrict__ c_in,
                   const int32_t* __restrict__ c_out, int64_t n, int le,
                   int npos, int subs) {
  constexpr int kChunk = MexpShape<W>::kChunk;
  constexpr int kBuilders = MexpShape<W>::kBuilders;
  static_assert(kChunk <= kBuilders, "a builder a point of the chunk");
  constexpr int kPW = mexp_point_words<W>();
  constexpr int kBuf = kChunk * kPW;
  constexpr int kCW = 3 * W;  // words of one entry
  // [2][kBuf] tables, then the folders' slots
  extern __shared__ __align__(16) uint32_t mexp_tbl[];
  // the modulus, the kernel's one and, at a padded modulus, c_in, c_out
  __shared__ uint32_t sm[W], so[W], sci[W], sco[W];
  const bool conv = c_in != nullptr;  // uniform: c_out is set with c_in
  vmn::load_vec_shared<W>(sm, m);
  vmn::load_vec_shared<W>(so, one);
  if (conv) {
    vmn::load_vec_shared<W>(sci, c_in);
    vmn::load_vec_shared<W>(sco, c_out);
  }
  __syncthreads();
  const vmn::Field<W, true> F{sm, mp};
  const int64_t nchunks = (n + kChunk - 1) / kChunk;
  const int G = (int)gridDim.x;
  const int tid = (int)threadIdx.x;
  const bool builder = tid < kBuilders;  // whole warps
  const int f = tid - kBuilders;
  const bool folder = !builder && f < npos * subs;
  const int j = folder ? f % npos : 0;
  const int s = folder ? f / npos : 0;

  // Builder: the 15 stored multiples of point k·C + tid into buffer buf.
  auto build = [&](int64_t k, uint32_t* buf) {
    const int64_t i = k * kChunk + tid;
    if (tid >= kChunk || i >= n) return;
    uint32_t X1[W], Y1[W], Z1[W], aX[W], aY[W], aZ[W];
    vmn::load_slice<W, 1>(X1, x + i * 2 * W);
    vmn::load_slice<W, 1>(Y1, y + i * 2 * W);
    if (conv) {  // x·R0 -> x·R at the kernel's radix: two products
      F.mul(X1, X1, sci);
      F.mul(Y1, Y1, sci);
    }
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
    const int64_t base = k * kChunk;
    const int cnt = n - base < kChunk ? (int)(n - base) : kChunk;
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
    if (conv) {  // the sum back to the limbs' radix: three products
      F.mul(A, A, sco);
      F.mul(A + W, A + W, sco);
      F.mul(A + 2 * W, A + 2 * W, sco);
    }
    const int64_t parts = (int64_t)G * subs;
    const int64_t q = (int64_t)blockIdx.x * subs + s;
    const int64_t plane = (int64_t)npos * parts * 2 * W;
    int32_t* o = out + ((int64_t)j * parts + q) * 2 * W;
    vmn::store_slice<W, 1>(o, A);
    vmn::store_slice<W, 1>(o + plane, A + W);
    vmn::store_slice<W, 1>(o + 2 * plane, A + 2 * W);
  }
}

// ------------------------------ H6 at the padded widths: groups of lanes
// The design of ec_mexp_kernel above with a group of kTPI lanes (the
// cooperative field of ec_coop.cuh, S = W/kTPI words of every value a
// lane) in place of each thread: builder group g builds points g, g +
// kBuilders, ... of the next chunk into the other buffer, and folder
// group f takes the items (position j, sub-chunk s) f, f + kFolders, ...
// of the npos·subs items, `rounds` of them, where the one-thread form has
// a folder an item: at 521-bit scalars 144 positions, more than the
// groups a block can hold.  An item's running sum lives in shared memory
// (3·W words, loaded into the group's registers while it folds a chunk);
// the factor is selected over all 16 entries into registers.  Every
// group of a warp takes the same steps, so that the shuffles and ballots
// of the field stay full-warp: a builder past the last point builds a
// copy of it (the folders never read it), a folder past the last item
// folds a copy of the last item's sum and does not store it, a point past
// the chunk's end is folded as digit 0 (the point at infinity, which an
// addition returns unchanged, limb for limb), and a warp with no item in
// a round leaves the round's loop.  The folding order is the one-thread
// form's (_mexp_order in ops/ec_kernels.py repeats it).  At a padded
// modulus the builders take each point to the kernel's radix (c_in) and
// the folders their sums back (c_out).  Bound, like the one-thread form,
// by its products; a cooperative product issues about twice the
// instructions of a one-thread one (H5, PERF.md §6).  ptxas (sm_90a) at
// W' = 20 (groups of 4 lanes, 384 threads, a bound of 170 registers): 160
// registers, no stack frame, no spill; 143 ms at 2^17 points and 521-bit
// scalars against 243 ms at W' = 24 (groups of 8, 448 threads, 124
// registers; H100, PERF.md §6).
template <int W>
__global__ void __launch_bounds__(MexpShape<W>::kThreads, 1)
    ec_mexp_coop_kernel(const int32_t* __restrict__ x,
                        const int32_t* __restrict__ y,
                        const uint8_t* __restrict__ inf,
                        const int32_t* __restrict__ e,
                        int32_t* __restrict__ out,
                        const int32_t* __restrict__ m,
                        const int32_t* __restrict__ one, uint32_t mp,
                        const int32_t* __restrict__ c_in,
                        const int32_t* __restrict__ c_out, int64_t n, int le,
                        int npos, int subs, int rounds) {
  using Sh = MexpShape<W>;
  constexpr int TPI = Sh::kTPI;
  constexpr int S = W / TPI;
  constexpr int kChunk = Sh::kChunk;
  constexpr int kPW = mexp_point_words<W>();
  constexpr int kBuf = kChunk * kPW;
  constexpr int kCW = 3 * W;  // words of one entry
  static_assert(kChunk % Sh::kBuilders == 0, "builders share the chunk");
  static_assert(Sh::kBuilders * TPI % 32 == 0 && Sh::kFolders * TPI % 32 == 0,
                "builders and folders in whole warps");
  // [2][kBuf] tables, then the items' running sums [rounds·kFolders][kCW]
  extern __shared__ __align__(16) uint32_t mexp_tbl[];
  const int tid = (int)threadIdx.x;
  const int grp = tid / TPI;
  const bool builder = grp < Sh::kBuilders;
  const int f = grp - Sh::kBuilders;
  const int f0 = (tid & ~31) / TPI - Sh::kBuilders;  // the warp's first
  const int items = npos * subs;
  const int off = vmn::group_lane<TPI>() * S;  // this lane's words
  uint32_t mm[S], o[S];
  vmn::load_slice<W, TPI>(mm, m);
  vmn::load_slice<W, TPI>(o, one);
  const vmn::CoopField<W, TPI> F{mm, mp};
  uint32_t* sums = mexp_tbl + 2 * kBuf;
  const int64_t nchunks = (n + kChunk - 1) / kChunk;
  const int G = (int)gridDim.x;

  auto build = [&](int64_t k, uint32_t* buf) {
#pragma unroll 1
    for (int c = grp; c < kChunk; c += Sh::kBuilders) {
      int64_t i = k * kChunk + c;
      if (i >= n) i = n - 1;
      uint32_t X1[S], Y1[S], Z1[S], aX[S], aY[S], aZ[S];
      vmn::load_slice<W, TPI>(X1, x + i * 2 * W);
      vmn::load_slice<W, TPI>(Y1, y + i * 2 * W);
      vmn::coop_rebase<W, TPI>(X1, c_in, mm, mp);
      vmn::coop_rebase<W, TPI>(Y1, c_in, mm, mp);
      const uint32_t pinf = 0u - (uint32_t)(inf[i] != 0);
      uint32_t* row = buf + c * kPW + off;
#pragma unroll
      for (int k2 = 0; k2 < S; ++k2) {
        Z1[k2] = o[k2] & ~pinf;
        aX[k2] = row[k2] = X1[k2];
        aY[k2] = row[W + k2] = Y1[k2];
        aZ[k2] = row[2 * W + k2] = Z1[k2];
      }
#pragma unroll 1
      for (int d = 2; d < kEntries; ++d) {
        vmn::point_add(F, aX, aY, aZ, aX, aY, aZ, X1, Y1, Z1);
        uint32_t* r = row + (d - 1) * kCW;
#pragma unroll
        for (int k2 = 0; k2 < S; ++k2) {
          r[k2] = aX[k2];
          r[W + k2] = aY[k2];
          r[2 * W + k2] = aZ[k2];
        }
      }
    }
  };

  // The item of folder group f in round r (clamped to the last), and
  // whether it is f's own.
  auto item_of = [&](int r, bool* live) {
    const int it = f + r * Sh::kFolders;
    *live = it < items;
    return *live ? it : items - 1;
  };

  auto fold = [&](int64_t k, const uint32_t* buf) {
    const int64_t base = k * kChunk;
    const int cnt = n - base < kChunk ? (int)(n - base) : kChunk;
    const int steps = (kChunk + subs - 1) / subs;
#pragma unroll 1
    for (int r = 0; r < rounds; ++r) {
      if (f0 + r * Sh::kFolders >= items) break;  // no item in the warp
      bool live;
      const int it = item_of(r, &live);
      const int j = it % npos, s = it / npos;
      uint32_t* A = sums + it * kCW + off;
      uint32_t aX[S], aY[S], aZ[S];
#pragma unroll
      for (int k2 = 0; k2 < S; ++k2) {
        aX[k2] = A[k2];
        aY[k2] = A[W + k2];
        aZ[k2] = A[2 * W + k2];
      }
#pragma unroll 1
      for (int t = 0; t < steps; ++t) {
        const int c = t * subs + s;
        const bool valid = c < cnt;
        const int cc = valid ? c : 0;
        const uint32_t dig =
            valid ? vmn::row_digit(e + (base + cc) * le, le, j) : 0u;
        const uint32_t at0 = 0u - (uint32_t)(dig == 0u);  // infinity
        uint32_t fX[S], fY[S], fZ[S];
#pragma unroll
        for (int k2 = 0; k2 < S; ++k2) {
          fX[k2] = 0;
          fY[k2] = o[k2] & at0;
          fZ[k2] = 0;
        }
        const uint32_t* row = buf + cc * kPW + off;
#pragma unroll 1
        for (int d = 1; d < kEntries; ++d) {
          const uint32_t mask = 0u - (uint32_t)(dig == (uint32_t)d);
          const uint32_t* q = row + (d - 1) * kCW;
#pragma unroll
          for (int k2 = 0; k2 < S; ++k2) {
            fX[k2] |= q[k2] & mask;
            fY[k2] |= q[W + k2] & mask;
            fZ[k2] |= q[2 * W + k2] & mask;
          }
        }
        vmn::point_add(F, aX, aY, aZ, aX, aY, aZ, fX, fY, fZ);
      }
      if (live) {
#pragma unroll
        for (int k2 = 0; k2 < S; ++k2) {
          A[k2] = aX[k2];
          A[W + k2] = aY[k2];
          A[2 * W + k2] = aZ[k2];
        }
      }
    }
  };

  if (!builder) {  // every sum starts at infinity (0, one, 0)
    for (int r = 0; r < rounds; ++r) {
      bool live;
      uint32_t* A = sums + item_of(r, &live) * kCW + off;
      if (!live) continue;
#pragma unroll
      for (int k2 = 0; k2 < S; ++k2) {
        A[k2] = 0;
        A[W + k2] = o[k2];
        A[2 * W + k2] = 0;
      }
    }
  }
  // Round `it` folds chunk k from buffer it mod 2 while chunk k + G is
  // built into the other; round -1 only builds the block's first chunk.
  int it = -1;
#pragma unroll 1
  for (int64_t k = (int64_t)blockIdx.x - G; k < nchunks; k += G, ++it) {
    if (builder) {
      if (k + G < nchunks) build(k + G, mexp_tbl + ((it + 1) & 1) * kBuf);
    } else if (k >= 0) {
      fold(k, mexp_tbl + (it & 1) * kBuf);
    }
    __syncthreads();
  }
  if (builder) return;  // whole warps
  const int64_t parts = (int64_t)G * subs;
  const int64_t plane = (int64_t)npos * parts * 2 * W;
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    if (f0 + r * Sh::kFolders >= items) break;
    bool live;
    const int itm = item_of(r, &live);
    const uint32_t* A = sums + itm * kCW + off;
    uint32_t aX[S], aY[S], aZ[S];
#pragma unroll
    for (int k2 = 0; k2 < S; ++k2) {
      aX[k2] = A[k2];
      aY[k2] = A[W + k2];
      aZ[k2] = A[2 * W + k2];
    }
    vmn::coop_rebase3<W, TPI>(aX, aY, aZ, c_out, mm, mp);
    if (live) {
      const int j = itm % npos, s = itm / npos;
      const int64_t q = (int64_t)blockIdx.x * subs + s;
      int32_t* dst = out + ((int64_t)j * parts + q) * 2 * W;
      vmn::store_slice<W, TPI>(dst, aX);
      vmn::store_slice<W, TPI>(dst + plane, aY);
      vmn::store_slice<W, TPI>(dst + 2 * plane, aZ);
    }
  }
}

template <int W>
int Mexp<W>::launch(const int32_t* x, const int32_t* y, const uint8_t* inf,
                    const int32_t* e, int32_t* out, const int32_t* m,
                    const int32_t* one, uint32_t mp, const int32_t* c_in,
                    const int32_t* c_out, int64_t n, int le, int npos,
                    int subs, int blocks, cudaStream_t s) {
  using Sh = MexpShape<W>;
  if (n < 1 || le < 1 || npos < 1 || subs < 1 || blocks < 1 ||
      (int64_t)blocks * Sh::kChunk >= n + Sh::kChunk) {
    return kBadShape;
  }
  if ((c_in == nullptr) != (c_out == nullptr)) return kBadShape;
  if constexpr (Sh::kTPI == 1) {
    static_assert(mexp_shared_bytes<W>() + 16 * W <= kBlockShared,
                  "H6's tables, slots and constants pass 227 KB");
    if (npos * subs > Sh::kFolders) return kBadShape;  // one thread an item
    const size_t smem = mexp_shared_bytes<W>();
    cudaError_t err = cudaFuncSetAttribute(
        ec_mexp_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    ec_mexp_kernel<W><<<(unsigned)blocks, Sh::kThreads, smem, s>>>(
        x, y, inf, e, out, m, one, mp, c_in, c_out, n, le, npos, subs);
  } else {
    const int rounds = (npos * subs + Sh::kFolders - 1) / Sh::kFolders;
    const size_t smem = mexp_coop_shared_bytes<W>(rounds);
    if (smem > (size_t)kBlockShared) return kBadShape;
    cudaError_t err = cudaFuncSetAttribute(
        ec_mexp_coop_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    ec_mexp_coop_kernel<W><<<(unsigned)blocks, Sh::kThreads, smem, s>>>(
        x, y, inf, e, out, m, one, mp, c_in, c_out, n, le, npos, subs,
        rounds);
  }
  return (int)cudaGetLastError();
}

// --------------------------------------------------- H7: fixed base
// out = sum_j T[j][digit_j(e)] for the affine table T (ndig, 16, L) of
// d·2^(4j)·P shared by the batch: no doublings, one addition per digit
// with Z = one (Z = 0 for digit 0).  The block stages digit j's 16 rows of
// both coordinates (2·16·W words, 1 KB at W = 8) in shared memory; every
// thread masked-selects its row, a broadcast read for the warp.  This
// replaces the TPU's one-hot f32 MXU gather.  ptxas: 182 registers at
// W = 8; at W = 12 255 with an 80-byte stack frame (80 bytes of spill
// stores, 92 of loads), a kernel off the mix paths (PERF.md §6).
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

template <int W>
int Fb<W>::launch(const int32_t* tx, const int32_t* ty, const int32_t* e,
                  int32_t* ox, int32_t* oy, int32_t* oz, const int32_t* m,
                  const int32_t* one, uint32_t mp, int64_t n, int le,
                  int ndig, cudaStream_t s) {
  ec_fb_kernel<W><<<blocks_for(n), kThreads, 0, s>>>(tx, ty, e, ox, oy, oz, m,
                                                     one, mp, n, le, ndig);
  return (int)cudaGetLastError();
}

template <int W, int TPI>
int Smul<W, TPI>::launch(const int32_t* x, const int32_t* y,
                         const uint8_t* inf, const int32_t* e, int32_t* ox,
                         int32_t* oy, int32_t* oz, const int32_t* m,
                         const int32_t* one, uint32_t mp, const int32_t* c_in,
                         const int32_t* c_out, int64_t n, int le, int ndig,
                         int threads, int64_t blocks, cudaStream_t s) {
  if (!vmn::coop_shape_ok<TPI>(threads, blocks) || le < 1 || ndig < 1) {
    return kBadShape;
  }
  const size_t smem = sizeof(uint32_t) * kEntries * 3 * (W / TPI) * threads;
  if (smem > 48 * 1024) {  // 96 KB at W = 8, TPI 2: opt in above 48 KB
    cudaError_t err = cudaFuncSetAttribute(
        ec_smul_kernel<W, TPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ec_smul_kernel<W, TPI><<<(unsigned)blocks, threads, smem, s>>>(
      x, y, inf, e, ox, oy, oz, m, one, mp, c_in, c_out, n, le, ndig);
  return (int)cudaGetLastError();
}

}  // namespace vmn_ec

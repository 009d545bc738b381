// Hand-written Hopper kernels for batched Montgomery arithmetic, bound to
// Python through a plain C interface (ctypes; see ops/mont_kernels.py).
//
//   H1 vmn_mont_mul     replaces K2 mont_mul_pallas        (mont_kernels.py:182-216)
//   H2 vmn_mont_exp     replaces K3 mont_exp_pallas        (:222-286, :753-795)
//   H3 vmn_mont_fb_exp  replaces K4 mont_fb8_exp_pallas and K5 mont_fb_exp_pallas
//                                                          (:292-353, :361-527)
//   H4 vmn_mont_expprod replaces both pallas_calls of K6 mont_expprod_positions
//                                                          (:552-727)
//   vmn_mont_chain      the combine of K7 mont_expprod_pallas (:730-750)
//
// Every entry point takes and returns limbs at the modulus's own L limbs
// and radix R = 2^(16·L).  Where L/2 is not the kernel's W (an odd L, or
// a width rounded up to a built one: Modulus in ops/mont_kernels.py)
// the operands come padded with zero limbs and c_in, c_out not NULL: each
// kernel takes its Montgomery inputs to R' = 2^(32·W) on load
// (coop_rebase, a product with c_in) and its results back on store (c_out);
// H3 converts its table once a launch (mont_rebase_table_kernel), H4 its
// bases and partials around its launch (mont_rebase_rows_kernel).
//
// Every kernel here spreads one element over TPI lanes of a warp with
// the cooperative product of mont_coop.cuh; the caller picks TPI from
// (W, N) among the instantiated pairs (vmn_mont_mul, vmn_mont_exp,
// vmn_mont_fb_exp, vmn_mont_expprod) by the crossovers measured on the
// card (COOP_TPI) and passes the launch shape (threads per block,
// blocks).  Their operands are row-major (N, 2W) 16-bit limbs, so that a
// group reads its element as one contiguous run.  Each entry point
// launches on the caller's stream, does not synchronise, allocates
// nothing and returns cudaGetLastError() (or kUnsupportedWidth for a
// width, or a TPI, with no instantiation, kBadShape for a launch shape
// the kernel cannot take).
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
// with no stack frame and no spill at any instantiation (the chain's
// registers rose with its conversion's paired product; one warp) --
//   W = 64: mont_mul TPI 8/32: 48/28;       mont_exp 56/30;    chain 38;
//           mont_expprod TPI 8/16: 64/53.
//   W = 96: mont_mul TPI 16/32: 42/31;      mont_exp 47/36;    chain 44;
//           mont_expprod TPI 16: 61.
//   W = 128: mont_mul TPI 32: 32;  mont_exp TPI 16/32: 56/38;  chain 50;
//           mont_expprod TPI 16: 64.
//   W = 8:  mont_mul TPI 8: 26;   mont_exp TPI 1/8: 64/28;    chain 27;
//           mont_expprod TPI 1/4: 64/42.
//   W = 12: mont_mul TPI 4: 32;   mont_exp TPI 1/2/4: 91/48/38; chain 44;
//           built on demand: mont_fb_exp TPI 4: 34, mont_expprod 52.
//   W = 20: mont_mul TPI 4: 40;   mont_exp TPI 2/4: 64/46; on demand:
//           chain 53, mont_fb_exp TPI 4: 40, mont_expprod 58.
//   W = 32 (on demand): mont_mul TPI 8/16: 32/30; mont_exp 39/32;
//           mont_fb_exp 36/26 (either window); mont_expprod TPI 8: 53;
//           chain 26.
//   W = 192 (on demand, modp6144): mont_mul TPI 16/32: 67/40; mont_exp
//           TPI 32: 46 (TPI 16, swept and not built: 72); mont_fb_exp
//           48 (either window); mont_expprod 62; chain 61.
//   W = 256 (on demand, modp8192), all TPI 32: mont_mul 47; mont_exp 56
//           (TPI 16, swept and not built: 84 / 93 for mont_mul /
//           mont_exp); mont_fb_exp 59 / 55 (window 8 / 4); mont_expprod
//           64; chain 64.
//   The boundary passes (mont_rebase_table_kernel, _rows_kernel): 26-48.
//   (W = 192 and 256: on an NVIDIA H100 80GB HBM3 at 700 W.)
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mont.cuh"
#include "mont_coop.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnsupportedWidth = -1;

// The bounds of the kernels whose blocks are small (H1, the boundary
// passes; the chain's one warp).  In a width's own library past 256 words
// (15 or 16 words a lane), with the blocks at least one a multiprocessor
// as well: given only a block size, ptxas trades a few bytes of spill for
// one more resident block (72 registers and 4 bytes at H1 <480, 32>, 80
// and 28 at the rows pass <512, 32>); given both, it may use registers up
// to what one block allows.  Every other width keeps the block size alone.
#if defined(VMN_W) && VMN_W > 256
#define VMN_BOUNDS(threads) __launch_bounds__(threads, 1)
#else
#define VMN_BOUNDS(threads) __launch_bounds__(threads)
#endif
constexpr int kBadShape = -2;
constexpr int kExpEntries = 16;  // H2's 4-bit windows

// ------------------------------------------------------------- H1: product
// One element per group of TPI lanes: TPI = 32 for small batches (the
// product's serial chain is then W/32 words a lane), fewer lanes from the
// batch size where they measured faster (COOP_TPI, ops/mont_kernels.py).
template <int W, int TPI>
__global__ void VMN_BOUNDS(kThreads)
    mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                    int32_t* __restrict__ out, const int32_t* __restrict__ m,
                    uint32_t mp, const int32_t* __restrict__ c_in, int64_t n) {
  constexpr int S = W / TPI;
  bool live;
  const int64_t e = vmn::group_element<TPI>(n, &live);
  uint32_t x[S], y[S], mm[S];
  vmn::load_slice<W, TPI>(mm, m);
  vmn::load_slice<W, TPI>(x, a + e * 2 * W);
  vmn::load_slice<W, TPI>(y, b + e * 2 * W);
  vmn::coop_mont_mul<W, TPI>(x, x, y, mm, mp);
  // A padded modulus: a·b·R^-1 = (a·b·R'^-1)·c_in·R'^-1, one product.
  vmn::coop_rebase<W, TPI>(x, c_in, mm, mp);
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
// A padded modulus (c_in, c_out not NULL) takes the base to the kernel's
// radix on load and the power back on store, two products an element;
// `one` is then the kernel's own (R' mod m).
// A block of 128 threads holds 128/TPI elements at 16·4·W bytes each
// (4 KB at W = 64): 64 KB at TPI = 8, 16 KB at TPI = 32; above 48 KB the
// launcher opts in to the larger dynamic shared memory (W = 256, TPI 32:
// 4 elements of 16 KB, 64 KB a block, three blocks in 192 KB).  The table is
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
                    const int32_t* __restrict__ one, uint32_t mp,
                    const int32_t* __restrict__ c_in,
                    const int32_t* __restrict__ c_out, int64_t n, int le,
                    int ndig) {
  constexpr int S = W / TPI;
  extern __shared__ uint32_t exp_tbl[];  // [kExpEntries][S][blockDim.x]
  bool live;
  const int64_t idx = vmn::group_element<TPI>(n, &live);
  const int stride = (int)blockDim.x;
  uint32_t* mine = exp_tbl + threadIdx.x;
  uint32_t mm[S], x[S], cur[S];
  vmn::load_slice<W, TPI>(mm, m);
  vmn::load_slice<W, TPI>(x, base + idx * 2 * W);
  vmn::coop_rebase<W, TPI>(x, c_in, mm, mp);
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
  vmn::coop_rebase<W, TPI>(acc, c_out, mm, mp);
  if (live) vmn::store_slice<W, TPI>(out + idx * 2 * W, acc);
}

// ------------------------------------------- K7's combine: one product chain
// prod_j P_j^(2^(4j)) over npos positions (row-major (npos, 2W) limbs),
// Horner from the top position: 4 squarings and one product each, 5·npos
// products back to back on one warp.  The accumulator stays in registers;
// P_j is read once, before its 4 squarings.  Launched as one warp: the
// groups past the first (W < 32) compute the same chain and do not store.
// A padded modulus (c_in, c_out not NULL): the top position is taken to
// the kernel's radix before the chain, each later P_j by a product run
// beside its step's first squaring (coop_mont_mul2: independent, so its
// latency hides behind the squaring's), the result back on store; two
// products' latency in all.
template <int W, int TPI>
__global__ void VMN_BOUNDS(32)
    mont_chain_kernel(const int32_t* __restrict__ P, int32_t* __restrict__ out,
                      const int32_t* __restrict__ m, uint32_t mp,
                      const int32_t* __restrict__ c_in,
                      const int32_t* __restrict__ c_out, int npos) {
  constexpr int S = W / TPI;
  uint32_t mm[S], acc[S], fac[S];
  vmn::load_slice<W, TPI>(mm, m);
  vmn::load_slice<W, TPI>(acc, P + (int64_t)(npos - 1) * 2 * W);
  vmn::coop_rebase<W, TPI>(acc, c_in, mm, mp);
#pragma unroll 1
  for (int j = npos - 2; j >= 0; --j) {
    vmn::load_slice<W, TPI>(fac, P + (int64_t)j * 2 * W);
    int s0 = 0;
    if (c_in != nullptr) {  // uniform over the launch
      uint32_t k[S];
      vmn::load_slice<W, TPI>(k, c_in);
      vmn::coop_mont_mul2<W, TPI>(acc, acc, acc, fac, fac, k, mm, mp);
      s0 = 1;
    }
#pragma unroll 1
    for (int s = s0; s < 4; ++s) vmn::coop_mont_mul<W, TPI>(acc, acc, acc, mm, mp);
    vmn::coop_mont_mul<W, TPI>(acc, acc, fac, mm, mp);
  }
  vmn::coop_rebase<W, TPI>(acc, c_out, mm, mp);
  if (threadIdx.x < TPI) vmn::store_slice<W, TPI>(out, acc);
}

// --------------------------------------------- H3: fixed-base power, 2^WB
// out = prod_j T[j][digit_j(e)] for a table T (ndig, 2^WB entries, W words)
// shared by the batch.  TPI lanes of a warp share an element, as in H1
// and H2 (the cooperative product of mont_coop.cuh).  Per digit the block
// stages the digit's 2^WB entries in shared memory, then each lane takes
// its S = W/TPI words of the factor by a masked select over every entry
// (never an index by the secret digit) and the group multiplies it into
// the accumulator, which stays in registers.
//
// The staged table is the wrapper's packed copy of T (fb_pack in
// ops/mont_kernels.py): word lane·S + k of an entry (k < S) lies at
// [k / V][lane][k % V] of the entry, V the widest of 4, 2, 1 that divides
// S (slice_vec): one vector load gives a lane V words of its slice, the
// TPI lanes of a group read TPI·V consecutive words, and every group of
// the warp reads the same ones (a broadcast), so no bank conflict.  Two
// buffers: the copy of the next piece (cp.async, 16 bytes a thread at a
// time) runs under this piece's select and product, as K4 overlapped its
// two VMEM buffers; one barrier a piece.  A padded modulus: the entry
// point first takes the packed table's entries to the kernel's radix, one
// product an entry in a launch of its own (mont_rebase_table_kernel; the
// entries are few beside the batch's products), and the kernel takes the
// result back on store (c_out).  A piece is a digit's 2^WB
// entries where two of them fit the 227 KB a block may use (every window
// at W <= 96: 192 KB at window 8, W = 96), else the largest power-of-two
// share of them of which two fit (fb_pieces): halves at window 8 and
// W = 128 (two 64 KB halves, staged in turn, where two whole digits would
// take 256 KB) and W = 192 (two 96 KB halves), quarters at W = 256 (two
// 64 KB quarters, where two halves would take 256 KB), eighths at W = 480
// and 512 (two 60 and 64 KB eighths, where two quarters would take 240
// and 256 KB); the masked select runs over every entry of every piece of
// the digit before its product.
// At window 8 and W = 64 a buffer is 64 KB, so a block holds the SM's
// shared memory alone: the launch shape (fb_launch)
// gives a block about N/132 elements, so that N = 10000 is one wave of
// 132 blocks of 19 warps (TPI 8), where blocks of 128 threads would leave
// 53 SMs idle.  TPI by the crossovers of COOP_TPI["mont_fb_exp", W].
//
// What bounds it: the products (one a digit, 4·W² + W multiplies) and the
// select, which reads 2^WB·W words an element a digit, one AND-OR each:
// at window 8 about as many integer instructions as the product it feeds,
// and about half of the kernel's time on the H100 (PERF.md §6).  ptxas
// (sm_90a): 56 / 36 / 26 registers at W = 64, TPI 8 / 16 / 32 (either
// window), 26 at W = 8, TPI 4; 32 / 36 at W = 96 / 128, TPI 32 (window
// 8), 48 / 59 at W = 192 / 256; no stack frame, no spill.  At W = 96 and
// 128 only TPI 32 is built: TPI 16 measured slower on the paths' 10000
// elements, and a block of 1024 threads caps a thread at 64 registers,
// which TPI 8's 12 or 16 words a slice would pass; at W = 192 and 256
// TPI 32 is the only TPI whose slice (6, 8 words) stays within them.  At
// W = 480 and 512, TPI 32 (15 and 16 words a lane) in blocks of at most
// 512 threads (block_cap), which leave a thread 128 registers.
__device__ __forceinline__ void cp_async16(uint32_t* dst,
                                           const uint32_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Words a lane moves at once in the shared layouts of H3 and H4: the
// widest of 4, 2, 1 that divides its S words.
template <int S>
__host__ __device__ constexpr int slice_vec() {
  return S % 4 == 0 ? 4 : S % 2 == 0 ? 2 : 1;
}

constexpr int kFbShared = 232448;  // the 227 KB a block may opt in to

// Pieces a digit of 2^WB entries of W words is staged in: the smallest
// power of two P for which two buffers of 1/P of a digit fit kFbShared
// (fb_pieces in ops/mont_kernels.py mirrors it).
template <int W, int WB, int P = 1>
__host__ __device__ constexpr int fb_pieces() {
  if constexpr (2 * (4 << WB) * W / P <= kFbShared) {
    return P;
  } else {
    static_assert(P < (1 << WB), "a piece would hold no entry");
    return fb_pieces<W, WB, 2 * P>();
  }
}

// V consecutive words from shared memory (16-, 8- or 4-byte aligned).
template <int V>
__device__ __forceinline__ void load_vec(uint32_t* w, const uint32_t* p) {
  if constexpr (V == 4) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
  } else if constexpr (V == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x, w[1] = x.y;
  } else {
    w[0] = p[0];
  }
}

template <int W, int WB, int TPI>
__global__ void __launch_bounds__(vmn::block_cap<W>(), 1)
    mont_fb_exp_kernel(const uint32_t* __restrict__ table,
                       const int32_t* __restrict__ e, int32_t* __restrict__ out,
                       const int32_t* __restrict__ m,
                       const int32_t* __restrict__ one, uint32_t mp,
                       const int32_t* __restrict__ c_out, int64_t n, int le,
                       int ndig) {
  constexpr int S = W / TPI;
  constexpr int V = slice_vec<S>();
  constexpr int kPieces = fb_pieces<W, WB>();
  constexpr int kEntries = (1 << WB) / kPieces;  // entries of a piece
  constexpr int kBlk = kEntries * W;  // words of one piece
  extern __shared__ __align__(16) uint32_t fb_stage[];  // [2][kBlk]
  bool live;
  const int64_t idx = vmn::group_element<TPI>(n, &live);
  const int lane = vmn::group_lane<TPI>();
  uint32_t mm[S], acc[S], fac[S];
  vmn::load_slice<W, TPI>(mm, m);
  vmn::load_slice<W, TPI>(acc, one);
  const int32_t* ex = e + idx * le;
  // piece u = j·kPieces + p: entries p·kEntries .. of digit j, which
  // follow one another in the packed table
  auto stage = [&](int u) {
    uint32_t* dst = fb_stage + (u & 1) * kBlk;
    const uint32_t* src = table + (int64_t)u * kBlk;
    for (int c = 4 * threadIdx.x; c < kBlk; c += 4 * blockDim.x) {
      cp_async16(dst + c, src + c);
    }
    cp_async_commit();
  };
  const int pieces = ndig * kPieces;
  stage(0);
  uint32_t dig = vmn::row_digit<WB>(ex, le, 0);
#pragma unroll
  for (int k = 0; k < S; ++k) fac[k] = 0;
#pragma unroll 1
  for (int u = 0; u < pieces; ++u) {
    cp_async_wait_all();  // this thread's copies of piece u have landed
    __syncthreads();      // everyone's, and piece u - 1's buffer is read
    if (u + 1 < pieces) stage(u + 1);
    const int p = u % kPieces;
    const uint32_t* row = fb_stage + (u & 1) * kBlk + lane * V;
#pragma unroll 2
    for (int d = 0; d < kEntries; ++d) {
      const uint32_t mask =
          0u - (uint32_t)(dig == (uint32_t)(p * kEntries + d));
#pragma unroll
      for (int kk = 0; kk < S / V; ++kk) {
        uint32_t w[V];
        load_vec<V>(w, row + d * W + kk * TPI * V);
#pragma unroll
        for (int v = 0; v < V; ++v) fac[kk * V + v] |= w[v] & mask;
      }
    }
    if (p == kPieces - 1) {  // the digit's last piece: its product
      // the next digit, loaded under the product
      dig = vmn::row_digit<WB>(ex, le, u / kPieces + 1);
      vmn::coop_mont_mul<W, TPI>(acc, acc, fac, mm, mp);
#pragma unroll
      for (int k = 0; k < S; ++k) fac[k] = 0;
    }
  }
  vmn::coop_rebase<W, TPI>(acc, c_out, mm, mp);
  if (live) vmn::store_slice<W, TPI>(out + idx * 2 * W, acc);
}

// ----------------------------------- H4: per-digit-position products (Yao)
// P_j = prod_i b_i^(d_ij) over the 4-bit digit positions j, as partial
// products that the caller multiplies together (the H1 lane tree).  One
// launch, and no table goes through device memory.  A block of G groups of
// TPI lanes (the cooperative product of mont_coop.cuh) takes `per_block`
// elements and `jb` digit positions (grid: element blocks x position
// blocks) and walks its elements in chunks of at most `chunk`:
//
// * Build.  Each element's 16 entries b^d go to shared memory: entries 0
//   (one) and 1 (b) are copied, entries 2..15 are built in four levels of
//   independent products, level h = 1, 2, 4, 8 making b^(h+k) = b^h·b^k
//   for k = 1 .. min(h, 15 - h): 1, 2, 4 and 7 products an element.  A
//   level's (element, entry) products go round all G groups, one barrier
//   a level: four product latencies where the chain takes fourteen.
// * Fold.  Item (s, p), p < jb a position and s < subs a share of the
//   chunk's elements, folds elements s, s + subs, ... into its
//   accumulator: the position's digit of the element, the factor by a
//   masked select over all 16 entries (never an index by the secret digit:
//   docs/DEVIATIONS.md #5), one product.  The items go round the groups;
//   an item's accumulator stays in shared memory between chunks and in
//   registers along one.  Neighbouring groups hold neighbouring positions
//   of one share, so a warp's groups select from the same element at
//   once: the same words, a broadcast.
// * Partials.  Item (s, p) of element block b writes partial b·subs + s of
//   position j0 + p: out (npos, gridDim.x·subs, 2W) row-major limbs.  The
//   products commute and Montgomery products are exact, so any grouping
//   gives the plain version's limbs.
//
// Shared layout: an entry or accumulator is W words, lane r's slice
// (S = W/TPI words) at [k / V][r][k % V], V the widest of 4, 2, 1 that
// divides S (fb_pack's layout): a lane moves its slice as S/V vectors and
// the TPI lanes of a group touch TPI·V consecutive words, so no bank
// conflict; an element's table is 16W + 4 words (ep_stride).  Bytes:
// 4·(chunk·(16W + 4) + jb·subs·W): the launch rule (ep_launch in
// ops/mont_kernels.py) keeps the accumulators within 64 KB, splitting the
// positions into blocks of jb (256 at W = 64, 128 at W = 128), and sizes
// `chunk` to what is left of the 227 KB a block may use (4 KB an element
// at W = 64, 8 KB at W = 128).  Lanes past the work of a round run on a
// clamped item and do not store, so that every lane of a warp takes part
// in the product's shuffles.
//
// What bounds it: the products, one a (element, position) and 14 an
// element for each block of positions; the select reads 16 entries a
// product from shared memory, 32·S loads and masks a lane against the
// product's 4·W·S multiply-adds (an eighth at W = 64).  One block of up
// to 1024 threads an SM (512 above 256 words: block_cap; the table fills
// the shared memory), registers held at 64 by __launch_bounds__ (used in
// full at W = 64, TPI 8, with no stack frame and no spill; 128 above 256
// words).  A padded
// modulus: the entry point takes the bases to the kernel's radix before
// the launch and the partials back after it (mont_rebase_rows_kernel, one
// product a row each: a conversion inside the kernel, as each block
// loads its bases, cost a product a base and position block and made
// ptxas spill at W = 64, TPI 8).  TPI by N
// (COOP_TPI): 16 for a few elements, 8 from 1024 at W = 64; at every N
// 32 lanes were slower, their groups too few for the positions.  At
// W = 96 and 128, TPI 16 at every N (ptxas: 61 and 64 registers, no
// spill), where TPI 8's slices would pass the 64 registers; at W = 192
// and 256 TPI 32 (62 and 64 registers): an element's table is 12 and
// 16 KB, so a chunk holds 14 and 10 elements beside 48 and 64 KB of
// accumulators; at W = 480 and 512 TPI 32 in blocks of at most 512
// threads (block_cap: 15 and 16 words a lane), an element's table 30 and
// 32 KB, a chunk 5 elements beside up to 64 KB of accumulators.
constexpr int kEpShared = kFbShared;
// Words between two elements' tables: 16 entries and 4 words of padding,
// so that groups reading the same entry of neighbouring elements (the
// build's first levels) start 4 banks apart.
template <int W>
__host__ __device__ constexpr int ep_stride() {
  return 16 * W + 4;
}

template <int V>
__device__ __forceinline__ void store_vec(uint32_t* p, const uint32_t* w) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    p[0] = w[0];
  }
}

// This lane's S words of a W-word value in the shared layout above.
template <int W, int TPI>
__device__ __forceinline__ void get_slice(uint32_t* x, const uint32_t* v) {
  constexpr int S = W / TPI, V = slice_vec<S>();
  const uint32_t* p = v + vmn::group_lane<TPI>() * V;
#pragma unroll
  for (int kk = 0; kk < S / V; ++kk) load_vec<V>(x + kk * V, p + kk * TPI * V);
}

template <int W, int TPI>
__device__ __forceinline__ void put_slice(uint32_t* v, const uint32_t* x) {
  constexpr int S = W / TPI, V = slice_vec<S>();
  uint32_t* p = v + vmn::group_lane<TPI>() * V;
#pragma unroll
  for (int kk = 0; kk < S / V; ++kk) store_vec<V>(p + kk * TPI * V, x + kk * V);
}

// fac = entry dig of an element's 16, by a masked select over all of them.
template <int W, int TPI>
__device__ __forceinline__ void select_slice(uint32_t* fac,
                                             const uint32_t* entries,
                                             uint32_t dig) {
  constexpr int S = W / TPI, V = slice_vec<S>();
  const uint32_t* p = entries + vmn::group_lane<TPI>() * V;
#pragma unroll
  for (int k = 0; k < S; ++k) fac[k] = 0;
#pragma unroll 2
  for (int d = 0; d < 16; ++d) {
    const uint32_t mask = 0u - (uint32_t)(dig == (uint32_t)d);
#pragma unroll
    for (int kk = 0; kk < S / V; ++kk) {
      uint32_t w[V];
      load_vec<V>(w, p + d * W + kk * TPI * V);
#pragma unroll
      for (int v = 0; v < V; ++v) fac[kk * V + v] |= w[v] & mask;
    }
  }
}

template <int W, int TPI>
__global__ void __launch_bounds__(vmn::block_cap<W>(), 1)
    mont_expprod_kernel(const int32_t* __restrict__ bases,
                        const int32_t* __restrict__ e,
                        int32_t* __restrict__ out,
                        const int32_t* __restrict__ m,
                        const int32_t* __restrict__ one, uint32_t mp,
                        int64_t n, int le, int jb, int subs,
                        int64_t per_block, int chunk) {
  constexpr int S = W / TPI;
  extern __shared__ __align__(16) uint32_t ep_smem[];
  uint32_t* tbl = ep_smem;  // [chunk][ep_stride]: 16 entries of W words
  uint32_t* accs = ep_smem + (size_t)chunk * ep_stride<W>();  // [jb·subs][W]
  const int G = (int)blockDim.x / TPI;
  const int g = (int)threadIdx.x / TPI;
  const int items = jb * subs;
  const int j0 = (int)blockIdx.y * jb;
  const int64_t e0 = (int64_t)blockIdx.x * per_block;
  const int64_t e1 = n < e0 + per_block ? n : e0 + per_block;
  uint32_t mm[S], x[S], y[S];
  vmn::load_slice<W, TPI>(mm, m);
  vmn::load_slice<W, TPI>(x, one);
  for (int it = g; it < items; it += G) put_slice<W, TPI>(accs + it * W, x);
#pragma unroll 1
  for (int64_t c0 = e0; c0 < e1; c0 += chunk) {
    const int cnt = e1 - c0 < chunk ? (int)(e1 - c0) : chunk;
    __syncthreads();  // the previous chunk's fold has read the table
    for (int c = g; c < cnt; c += G) {
      vmn::load_slice<W, TPI>(x, one);
      vmn::load_slice<W, TPI>(y, bases + (c0 + c) * 2 * W);
      put_slice<W, TPI>(tbl + c * ep_stride<W>(), x);
      put_slice<W, TPI>(tbl + c * ep_stride<W>() + W, y);
    }
    __syncthreads();
#pragma unroll 1
    for (int h = 1; h < 16; h *= 2) {
      const int per = (2 * h < 15 ? 2 * h : 15) - h;  // entries h+1 ..
      const int work = cnt * per;
#pragma unroll 1
      for (int w0 = 0; w0 < work; w0 += G) {
        const int w = w0 + g < work ? w0 + g : work - 1;
        const int k = 1 + w % per;
        uint32_t* ent = tbl + (w / per) * ep_stride<W>();
        get_slice<W, TPI>(x, ent + h * W);
        get_slice<W, TPI>(y, ent + k * W);
        vmn::coop_mont_mul<W, TPI>(x, x, y, mm, mp);
        if (w0 + g < work) put_slice<W, TPI>(ent + (h + k) * W, x);
      }
      __syncthreads();
    }
    const int steps = (cnt + subs - 1) / subs;
#pragma unroll 1
    for (int i0 = 0; i0 < items; i0 += G) {
      const int it = i0 + g < items ? i0 + g : items - 1;
      const int s = it / jb, j = j0 + it % jb;
      get_slice<W, TPI>(x, accs + it * W);
#pragma unroll 1
      for (int k = 0; k < steps; ++k) {
        // an element past the chunk selects entry 0, one
        const int c = s + k * subs;
        const int cc = c < cnt ? c : 0;
        uint32_t dig = vmn::row_digit(e + (c0 + cc) * le, le, j);
        dig = c < cnt ? dig : 0u;
        select_slice<W, TPI>(y, tbl + cc * ep_stride<W>(), dig);
        vmn::coop_mont_mul<W, TPI>(x, x, y, mm, mp);
      }
      if (i0 + g < items) put_slice<W, TPI>(accs + it * W, x);
    }
  }
  // Each group reads back only the accumulators it wrote.
  const int64_t parts = (int64_t)gridDim.x * subs;
  for (int it = g; it < items; it += G) {
    get_slice<W, TPI>(x, accs + it * W);
    const int64_t q = (int64_t)blockIdx.x * subs + it / jb;
    vmn::store_slice<W, TPI>(out + ((j0 + it % jb) * parts + q) * 2 * W, x);
  }
}

// H3's table at a padded modulus: out = in·c·R^-1 for each of n entries
// of W words in fb_pack's layout (a group of TPI lanes an entry, the lanes'
// slices where H3 reads them), at the kernel's radix R = 2^(32·W).
template <int W, int TPI>
__global__ void VMN_BOUNDS(kThreads)
    mont_rebase_table_kernel(const uint32_t* __restrict__ in,
                             uint32_t* __restrict__ out,
                             const int32_t* __restrict__ m, uint32_t mp,
                             const int32_t* __restrict__ c, int64_t n) {
  constexpr int S = W / TPI;
  bool live;
  const int64_t idx = vmn::group_element<TPI>(n, &live);
  uint32_t mm[S], x[S], k[S];
  vmn::load_slice<W, TPI>(mm, m);
  vmn::load_slice<W, TPI>(k, c);
  get_slice<W, TPI>(x, in + idx * W);
  vmn::coop_mont_mul<W, TPI>(x, x, k, mm, mp);
  if (live) put_slice<W, TPI>(out + idx * W, x);
}

// H4's boundary at a padded modulus: out = in·c·R^-1 for each of n rows
// of 2W 16-bit limbs (a group of TPI lanes a row), in place where out is
// in.
template <int W, int TPI>
__global__ void VMN_BOUNDS(kThreads)
    mont_rebase_rows_kernel(const int32_t* in, int32_t* out,
                            const int32_t* __restrict__ m, uint32_t mp,
                            const int32_t* __restrict__ c, int64_t n) {
  constexpr int S = W / TPI;
  bool live;
  const int64_t idx = vmn::group_element<TPI>(n, &live);
  uint32_t mm[S], x[S], k[S];
  vmn::load_slice<W, TPI>(mm, m);
  vmn::load_slice<W, TPI>(k, c);
  vmn::load_slice<W, TPI>(x, in + idx * 2 * W);
  vmn::coop_mont_mul<W, TPI>(x, x, k, mm, mp);
  if (live) vmn::store_slice<W, TPI>(out + idx * 2 * W, x);
}

template <int W, int TPI>
void launch_rebase_rows(const int32_t* in, int32_t* out, const int32_t* m,
                        uint32_t mp, const int32_t* c, int64_t n,
                        cudaStream_t s) {
  const int64_t blocks = (n * TPI + kThreads - 1) / kThreads;
  mont_rebase_rows_kernel<W, TPI><<<(unsigned)blocks, kThreads, 0, s>>>(
      in, out, m, mp, c, n);
}

template <int W, int WB, int TPI>
int launch_fb(const uint32_t* table, uint32_t* conv, const int32_t* e,
              int32_t* out, const int32_t* m, const int32_t* one, uint32_t mp,
              const int32_t* c_in, const int32_t* c_out, int64_t n, int le,
              int ndig, int threads, int64_t blocks, cudaStream_t s) {
  if (!vmn::coop_shape_ok<TPI>(threads, blocks, vmn::block_cap<W>()) ||
      le < 1 ||
      ndig < 1 || (c_in != nullptr && conv == nullptr)) {
    return kBadShape;
  }
  if (c_in != nullptr) {  // the table's entries to the kernel's radix
    const int64_t entries = (int64_t)ndig << WB;
    const int64_t tb = (entries * TPI + kThreads - 1) / kThreads;
    mont_rebase_table_kernel<W, TPI><<<(unsigned)tb, kThreads, 0, s>>>(
        table, conv, m, mp, c_in, entries);
    table = conv;
  }
  const size_t smem =
      sizeof(uint32_t) * 2 * (size_t)((1 << WB) / fb_pieces<W, WB>()) * W;
  // Above 48 KB (window 8 at 2048 bits: 128 KB) a launch is refused
  // unless the kernel opts in to the larger dynamic shared memory.
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mont_fb_exp_kernel<W, WB, TPI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mont_fb_exp_kernel<W, WB, TPI><<<(unsigned)blocks, threads, smem, s>>>(
      table, e, out, m, one, mp, c_out, n, le, ndig);
  return (int)cudaGetLastError();
}

template <int W, int TPI>
int launch_mul(const int32_t* a, const int32_t* b, int32_t* out,
               const int32_t* m, uint32_t mp, const int32_t* c_in, int64_t n,
               int threads, int64_t blocks, cudaStream_t s) {
  if (!vmn::coop_shape_ok<TPI>(threads, blocks)) return kBadShape;
  mont_mul_kernel<W, TPI><<<(unsigned)blocks, threads, 0, s>>>(a, b, out, m,
                                                               mp, c_in, n);
  return (int)cudaGetLastError();
}

template <int W, int TPI>
int launch_exp(const int32_t* base, const int32_t* e, int32_t* out,
               const int32_t* m, const int32_t* one, uint32_t mp,
               const int32_t* c_in, const int32_t* c_out, int64_t n, int le,
               int ndig, int threads, int64_t blocks, cudaStream_t s) {
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
      base, e, out, m, one, mp, c_in, c_out, n, le, ndig);
  return (int)cudaGetLastError();
}

// H4; at a padded modulus `conv` (n rows) receives the converted bases.
template <int W, int TPI>
int launch_ep(const int32_t* bases, int32_t* conv, const int32_t* e,
              int32_t* out, const int32_t* m, const int32_t* one, uint32_t mp,
              const int32_t* c_in, const int32_t* c_out, int64_t n, int le,
              int jb, int subs, int64_t per_block, int chunk, int threads,
              int eblocks, int pblocks, cudaStream_t s) {
  const size_t smem = sizeof(uint32_t) * ((size_t)chunk * ep_stride<W>() +
                                          (size_t)jb * subs * W);
  if (!vmn::coop_shape_ok<TPI>(threads, eblocks, vmn::block_cap<W>()) ||
      n < 1 ||
      le < 1 || jb < 1 || subs < 1 || chunk < 1 || per_block < 1 ||
      pblocks < 1 || pblocks > 65535 || smem > (size_t)kEpShared ||
      (c_in != nullptr && (conv == nullptr || c_out == nullptr))) {
    return kBadShape;
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mont_expprod_kernel<W, TPI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (c_in != nullptr) {  // the bases to the kernel's radix
    launch_rebase_rows<W, TPI>(bases, conv, m, mp, c_in, n, s);
    bases = conv;
  }
  mont_expprod_kernel<W, TPI>
      <<<dim3((unsigned)eblocks, (unsigned)pblocks), threads, smem, s>>>(
          bases, e, out, m, one, mp, n, le, jb, subs, per_block, chunk);
  if (c_out != nullptr) {  // the partials back, in place
    launch_rebase_rows<W, TPI>(out, out, m, mp, c_out,
                               (int64_t)pblocks * jb * eblocks * subs, s);
  }
  return (int)cudaGetLastError();
}

// One warp: TPI the largest power of two that divides W, at most 32 (8
// at W = 8, 4 at W = 12 and 20, 32 at the ModP widths).
template <int W>
int launch_chain(const int32_t* P, int32_t* out, const int32_t* m,
                 uint32_t mp, const int32_t* c_in, const int32_t* c_out,
                 int npos, cudaStream_t s) {
  if (npos < 1) return kBadShape;
  mont_chain_kernel<W, ((W & -W) < 32 ? (W & -W) : 32)>
      <<<1, 32, 0, s>>>(P, out, m, mp, c_in, c_out, npos);
  return (int)cudaGetLastError();
}

}  // namespace

#define VMN_MUL_ARGS a, b, out, m, mp, c_in, n, threads, blocks, s
#define VMN_EXP_ARGS base, e, out, m, one, mp, c_in, c_out, n, le, ndig, \
                     threads, blocks, s
#define VMN_FB_ARGS table, conv, e, out, m, one, mp, c_in, c_out, n, le, \
                    ndig, threads, blocks, s
#define VMN_EP_ARGS bases, conv, e, out, m, one, mp, c_in, c_out, n, le, jb, \
                    subs, per_block, chunk, threads, eblocks, pblocks, s
#define VMN_CHAIN_ARGS P, out, m, mp, c_in, c_out, npos, s

// The C entry points, each returning kUnsupportedWidth for a (W, TPI[,
// window]) it has no case for, before it launches anything.  Built in
// two ways from this one file:
//  * without VMN_W, the main library (ops/mont_kernels.py build_kernels):
//    the fixed switches below, at the widths of the paths checked since
//    they were written (_WIDTHS);
//  * with -DVMN_W=w, a width's own library, built on demand at the first
//    use of a width the switches lack (any other ModP size, e.g. 1024
//    bits: W = 32, or 1000 bits: 63 limbs at W' = 32) or of a kernel they
//    lack at a width they have (H3, H4 at W = 12 and W' = 20): every
//    entry point at W = VMN_W alone, each kernel at the TPIs of the bit
//    mask VMN_{MUL,EXP,FB,EP}_TPIS (bit t for TPI t, from the rule at W,
//    coop_rule; 0 leaves the kernel out), H3 at windows 4 and 8, the
//    chain at its one TPI (build_widths).
#ifndef VMN_W  // the main library
extern "C" {

// H1 and H2 are instantiated at the (W, TPI) pairs that COOP_TPI in
// ops/mont_kernels.py chooses: H1 at (8, 8), (12, 4), (20, 4), (64, 8),
// (64, 32), (96, 16), (96, 32), (128, 32), H2 at (8, 1), (8, 8), (12, 1),
// (12, 2), (12, 4), (20, 2), (20, 4), (64, 8), (64, 32) and at TPI 16 and
// 32 of W = 96 and 128.  W = 20 is P-521's inner width (L = 33 limbs
// padded to 40, c_in and c_out not NULL); H3, H4 and the chain there, and
// H3 and H4 at W = 12, come from the width's own library.
int vmn_mont_mul(int w, int tpi, const int32_t* a, const int32_t* b,
                 int32_t* out, const int32_t* m, uint32_t mp,
                 const int32_t* c_in, int64_t n, int threads, int64_t blocks,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w << 8 | tpi) {
    case 8 << 8 | 8: return launch_mul<8, 8>(VMN_MUL_ARGS);
    case 12 << 8 | 4: return launch_mul<12, 4>(VMN_MUL_ARGS);
    case 20 << 8 | 4: return launch_mul<20, 4>(VMN_MUL_ARGS);
    case 64 << 8 | 8: return launch_mul<64, 8>(VMN_MUL_ARGS);
    case 64 << 8 | 32: return launch_mul<64, 32>(VMN_MUL_ARGS);
    case 96 << 8 | 16: return launch_mul<96, 16>(VMN_MUL_ARGS);
    case 96 << 8 | 32: return launch_mul<96, 32>(VMN_MUL_ARGS);
    case 128 << 8 | 32: return launch_mul<128, 32>(VMN_MUL_ARGS);
    default: return kUnsupportedWidth;
  }
}

int vmn_mont_exp(int w, int tpi, const int32_t* base, const int32_t* e,
                 int32_t* out, const int32_t* m, const int32_t* one,
                 uint32_t mp, const int32_t* c_in, const int32_t* c_out,
                 int64_t n, int le, int ndig, int threads, int64_t blocks,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w << 8 | tpi) {
    case 20 << 8 | 2: return launch_exp<20, 2>(VMN_EXP_ARGS);
    case 20 << 8 | 4: return launch_exp<20, 4>(VMN_EXP_ARGS);
    case 8 << 8 | 1: return launch_exp<8, 1>(VMN_EXP_ARGS);
    case 8 << 8 | 8: return launch_exp<8, 8>(VMN_EXP_ARGS);
    case 12 << 8 | 1: return launch_exp<12, 1>(VMN_EXP_ARGS);
    case 12 << 8 | 2: return launch_exp<12, 2>(VMN_EXP_ARGS);
    case 12 << 8 | 4: return launch_exp<12, 4>(VMN_EXP_ARGS);
    case 64 << 8 | 8: return launch_exp<64, 8>(VMN_EXP_ARGS);
    case 64 << 8 | 32: return launch_exp<64, 32>(VMN_EXP_ARGS);
    case 96 << 8 | 16: return launch_exp<96, 16>(VMN_EXP_ARGS);
    case 96 << 8 | 32: return launch_exp<96, 32>(VMN_EXP_ARGS);
    case 128 << 8 | 16: return launch_exp<128, 16>(VMN_EXP_ARGS);
    case 128 << 8 | 32: return launch_exp<128, 32>(VMN_EXP_ARGS);
    default: return kUnsupportedWidth;
  }
}

int vmn_mont_chain(int w, const int32_t* P, int32_t* out, const int32_t* m,
                   uint32_t mp, const int32_t* c_in, const int32_t* c_out,
                   int npos, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 8: return launch_chain<8>(VMN_CHAIN_ARGS);
    case 12: return launch_chain<12>(VMN_CHAIN_ARGS);
    case 64: return launch_chain<64>(VMN_CHAIN_ARGS);
    case 96: return launch_chain<96>(VMN_CHAIN_ARGS);
    case 128: return launch_chain<128>(VMN_CHAIN_ARGS);
    default: return kUnsupportedWidth;
  }
}

// H3 (`conv`, as large as `table`, receives the converted table where
// c_in is not NULL) at (W, window, TPI): (64, 8), (64, 4) and (8, 4) --
// the modp2048 path, 256-bit exponents at modp2048 and the test256
// golden -- and (96, 8), (128, 8), the modp3072 and modp4096 paths, at
// the TPIs that
// COOP_TPI["mont_fb_exp", W] can choose; window 4 there too, which a
// group with a short q (a 256-bit one beside a 3072-bit p, FIPS 186-4
// §4.2) gives its fixed-base powers (the RFC 3526 groups' are full
// width): 2·16 entries of 128 words are 16 KB of staged table, far below
// the 227 KB.
int vmn_mont_fb_exp(int w, int wb, int tpi, const uint32_t* table,
                    uint32_t* conv, const int32_t* e, int32_t* out,
                    const int32_t* m, const int32_t* one, uint32_t mp,
                    const int32_t* c_in, const int32_t* c_out, int64_t n,
                    int le, int ndig, int threads, int64_t blocks,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w << 16 | wb << 8 | tpi) {
    case 64 << 16 | 8 << 8 | 8: return launch_fb<64, 8, 8>(VMN_FB_ARGS);
    case 64 << 16 | 8 << 8 | 16: return launch_fb<64, 8, 16>(VMN_FB_ARGS);
    case 64 << 16 | 8 << 8 | 32: return launch_fb<64, 8, 32>(VMN_FB_ARGS);
    case 64 << 16 | 4 << 8 | 8: return launch_fb<64, 4, 8>(VMN_FB_ARGS);
    case 64 << 16 | 4 << 8 | 16: return launch_fb<64, 4, 16>(VMN_FB_ARGS);
    case 64 << 16 | 4 << 8 | 32: return launch_fb<64, 4, 32>(VMN_FB_ARGS);
    case 8 << 16 | 4 << 8 | 4: return launch_fb<8, 4, 4>(VMN_FB_ARGS);
    case 96 << 16 | 8 << 8 | 32: return launch_fb<96, 8, 32>(VMN_FB_ARGS);
    case 128 << 16 | 8 << 8 | 32: return launch_fb<128, 8, 32>(VMN_FB_ARGS);
    case 96 << 16 | 4 << 8 | 32: return launch_fb<96, 4, 32>(VMN_FB_ARGS);
    case 128 << 16 | 4 << 8 | 32: return launch_fb<128, 4, 32>(VMN_FB_ARGS);
    default: return kUnsupportedWidth;
  }
}

// H4 at the (W, TPI) pairs that COOP_TPI["mont_expprod_positions", W]
// can choose, in the launch shape of ep_launch (ops/mont_kernels.py);
// `conv` (as large as `bases`) receives the converted bases where c_in
// is not NULL.
int vmn_mont_expprod(int w, int tpi, const int32_t* bases, int32_t* conv,
                     const int32_t* e, int32_t* out, const int32_t* m,
                     const int32_t* one, uint32_t mp, const int32_t* c_in,
                     const int32_t* c_out, int64_t n, int le, int jb,
                     int subs, int64_t per_block, int chunk, int threads,
                     int eblocks, int pblocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w << 8 | tpi) {
    case 8 << 8 | 1: return launch_ep<8, 1>(VMN_EP_ARGS);
    case 8 << 8 | 4: return launch_ep<8, 4>(VMN_EP_ARGS);
    case 64 << 8 | 8: return launch_ep<64, 8>(VMN_EP_ARGS);
    case 64 << 8 | 16: return launch_ep<64, 16>(VMN_EP_ARGS);
    case 96 << 8 | 16: return launch_ep<96, 16>(VMN_EP_ARGS);
    case 128 << 8 | 16: return launch_ep<128, 16>(VMN_EP_ARGS);
    default: return kUnsupportedWidth;
  }
}

}  // extern "C"


#else  // a width's own library

namespace {

// launch(std::integral_constant<int, T>) at the TPI T = tpi where bit T of
// kMask is set and T divides VMN_W; kUnsupportedWidth elsewhere.
template <unsigned kMask, int T = 1, class F>
int at_tpi(int tpi, const F& launch) {
  if constexpr (T > 32) {
    return kUnsupportedWidth;
  } else {
    if constexpr ((kMask & T) != 0 && VMN_W % T == 0) {
      if (tpi == T) return launch(std::integral_constant<int, T>{});
    }
    return at_tpi<kMask, 2 * T>(tpi, launch);
  }
}

}  // namespace

extern "C" {

int vmn_mont_mul(int w, int tpi, const int32_t* a, const int32_t* b,
                 int32_t* out, const int32_t* m, uint32_t mp,
                 const int32_t* c_in, int64_t n, int threads, int64_t blocks,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w != VMN_W) return kUnsupportedWidth;
  return at_tpi<VMN_MUL_TPIS>(tpi, [&](auto t) {
    return launch_mul<VMN_W, decltype(t)::value>(VMN_MUL_ARGS);
  });
}

int vmn_mont_exp(int w, int tpi, const int32_t* base, const int32_t* e,
                 int32_t* out, const int32_t* m, const int32_t* one,
                 uint32_t mp, const int32_t* c_in, const int32_t* c_out,
                 int64_t n, int le, int ndig, int threads, int64_t blocks,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w != VMN_W) return kUnsupportedWidth;
  return at_tpi<VMN_EXP_TPIS>(tpi, [&](auto t) {
    return launch_exp<VMN_W, decltype(t)::value>(VMN_EXP_ARGS);
  });
}

int vmn_mont_chain(int w, const int32_t* P, int32_t* out, const int32_t* m,
                   uint32_t mp, const int32_t* c_in, const int32_t* c_out,
                   int npos, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w != VMN_W) return kUnsupportedWidth;
  return launch_chain<VMN_W>(VMN_CHAIN_ARGS);
}

int vmn_mont_fb_exp(int w, int wb, int tpi, const uint32_t* table,
                    uint32_t* conv, const int32_t* e, int32_t* out,
                    const int32_t* m, const int32_t* one, uint32_t mp,
                    const int32_t* c_in, const int32_t* c_out, int64_t n,
                    int le, int ndig, int threads, int64_t blocks,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w != VMN_W || (wb != 4 && wb != 8)) return kUnsupportedWidth;
  return at_tpi<VMN_FB_TPIS>(tpi, [&](auto t) {
    constexpr int T = decltype(t)::value;
    return wb == 8 ? launch_fb<VMN_W, 8, T>(VMN_FB_ARGS)
                   : launch_fb<VMN_W, 4, T>(VMN_FB_ARGS);
  });
}

int vmn_mont_expprod(int w, int tpi, const int32_t* bases, int32_t* conv,
                     const int32_t* e, int32_t* out, const int32_t* m,
                     const int32_t* one, uint32_t mp, const int32_t* c_in,
                     const int32_t* c_out, int64_t n, int le, int jb,
                     int subs, int64_t per_block, int chunk, int threads,
                     int eblocks, int pblocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w != VMN_W) return kUnsupportedWidth;
  return at_tpi<VMN_EP_TPIS>(tpi, [&](auto t) {
    return launch_ep<VMN_W, decltype(t)::value>(VMN_EP_ARGS);
  });
}

}  // extern "C"

#endif  // VMN_W

// Cooperative Montgomery product: TPI threads of one warp share one
// W-word element.  This is the design of NVlabs' CGBN ("CUDA Generic Big
// Numbers"), written here from its published description.
//
// Why: the single-thread CIOS product of mont.cuh is 2·W² dependent
// multiply-adds on one thread.  At W = 64 on an H100 a batch of one is then
// ~60 µs of one thread on one SM, and a batch of 10000 is 79 blocks on 132
// SMs with its operands spilled to local memory.  Spreading the element over TPI
// lanes cuts the serial chain TPI times, multiplies the threads of a launch
// by TPI, and leaves each thread W/TPI words, which fit in registers.
//
// Layout: lane k of a group (k = threadIdx.x mod TPI; the TPI lanes of a
// group are consecutive lanes of one warp) owns words k·S .. k·S+S-1,
// S = W/TPI, of every operand and of the running sum t.  Per outer word i:
//   * the owner of a_i broadcasts it (__shfl_sync);
//   * each lane adds a_i·b over its S words (`row_mac`);
//   * lane 0 holds the lowest word of t exactly; every lane reads it and
//     computes q = t_0·m' itself, then adds q·m over its S words;
//   * t is divided by 2^32: lane k takes lane k+1's lowest word
//     (__shfl_down_sync) as its top word.
// A lane's carry out of its top word is not passed on at once: it is kept
// in the lane's own word above its slice (at most 2 after each step) and
// added into its top word at the next shift.  At the end the remaining carries between
// lanes, and the borrow of the final subtraction of m, are settled for the
// whole group at once from __ballot_sync generate/propagate masks.
//
// Every lane of the warp must call these functions together (full-warp
// masks); the kernels keep idle lanes running on a clamped element and only
// skip their stores.  The schedule is independent of the data
// (docs/DEVIATIONS.md #5): no branch or index depends on an operand.
#pragma once

#include <cstdint>

namespace vmn {

constexpr unsigned kWarpAll = 0xffffffffu;

// Threads a block of a cooperative launch at most (COOP_BLOCK in
// ops/mont_kernels.py), and of H3's and H4's (FB_BLOCK, WIDE_BLOCK), whose
// block holds the SM's shared memory alone.
constexpr int kCoopBlock = 128;
constexpr int kFbBlock = 1024;
constexpr int kWideBlock = 512;

// H3's and H4's threads a block at most at W words, the bound of their
// __launch_bounds__ and of their launch shape (block_cap in
// ops/mont_kernels.py): 1024 up to 256 words, where a thread may then hold
// 64 registers and TPI 32 leaves a lane 8 words at most; 512 above (128
// registers), where a lane holds 15 or 16 words (W = 480, 512).
template <int W>
__host__ __device__ constexpr int block_cap() {
  return W <= 256 ? kFbBlock : kWideBlock;
}

template <int TPI>
__device__ __forceinline__ int group_lane() {
  return (int)(threadIdx.x & (TPI - 1));
}

// The element of this thread's group, clamped into [0, n) so that every
// lane of the warp takes part in the group's shuffles; `live` says whether
// the group stores its result.
template <int TPI>
__device__ __forceinline__ int64_t group_element(int64_t n, bool* live) {
  const int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / TPI;
  *live = e < n;
  return *live ? e : n - 1;
}

// WB-bit digit j (WB = 4 or 8) of one exponent stored as le row-major
// 16-bit limbs; digits past the last limb read as zero.
template <int WB = 4>
__device__ __forceinline__ uint32_t row_digit(const int32_t* e, int le,
                                              int j) {
  constexpr int kPerLimb = 16 / WB;
  const int limb = j / kPerLimb;
  const uint32_t v = limb < le ? (uint32_t)e[limb] : 0u;
  return (v >> ((j % kPerLimb) * WB)) & ((1u << WB) - 1u);
}

// A cooperative launch: `threads` a block (whole warps, a multiple of
// TPI, at most `most`) over `blocks` blocks, as ops/mont_kernels.py's
// coop_launch (fb_launch for H3) computes it.
template <int TPI>
inline bool coop_shape_ok(int threads, int64_t blocks,
                          int most = kCoopBlock) {
  return threads > 0 && threads <= most && threads % 32 == 0 &&
         threads % TPI == 0 && blocks > 0 && blocks < (1ll << 31);
}

// The group's bits of a warp-wide ballot: bit k for lane k of the group.
template <int TPI>
__device__ __forceinline__ uint64_t group_ballot(bool pred) {
  const uint32_t all = __ballot_sync(kWarpAll, pred);
  if constexpr (TPI == 32) {
    return all;
  } else {
    const int base = (int)(threadIdx.x & 31) & ~(TPI - 1);
    return (all >> base) & ((1u << TPI) - 1u);
  }
}

// Carries between the lanes of a group.  g: this lane's slice carries out
// by itself; p: it carries out exactly when a carry comes in (never both).
// Read as the bits of one binary sum (G|P) + G, the carry into lane k is
// bit k of that sum xor P, and the carry out of the top lane is bit TPI.
// Returns this lane's carry in (0 or 1); *top gets the top lane's carry out.
template <int TPI>
__device__ __forceinline__ uint32_t group_carries(bool g, bool p,
                                                  uint32_t* top) {
  const uint64_t G = group_ballot<TPI>(g), P = group_ballot<TPI>(p);
  const uint64_t s = (G | P) + G;
  *top = (uint32_t)(s >> TPI) & 1u;
  return (uint32_t)((s ^ P) >> group_lane<TPI>()) & 1u;
}

// t[0..S-1] += x·y[0..S-1], the carry out added into (hh:hl), the word
// above the slice.  From S = 4 words up, PTX carry chains: ptxas turns each
// mad{c}.{lo,hi}.cc into an independent IMAD / IMAD.HI and an IADD3.X on
// a predicate carry, so the lo and hi chains interleave.  Below that,
// 64-bit accumulators, which nvcc schedules better for one- and two-word
// slices.  Both choices were timed against the other on the H100.
template <int S>
__device__ __forceinline__ void row_mac(uint32_t* t, uint32_t x,
                                        const uint32_t* y, uint32_t& hl,
                                        uint32_t& hh) {
  if constexpr (S >= 4) {
    asm volatile("mad.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[0]) : "r"(x), "r"(y[0]));
#pragma unroll
    for (int j = 1; j < S; ++j) {
      asm volatile("madc.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[j]) : "r"(x), "r"(y[j]));
    }
    asm volatile("addc.cc.u32 %0, %0, 0;" : "+r"(hl));
    asm volatile("addc.u32 %0, %0, 0;" : "+r"(hh));
    asm volatile("mad.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[1]) : "r"(x), "r"(y[0]));
#pragma unroll
    for (int j = 1; j < S - 1; ++j) {
      asm volatile("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[j + 1]) : "r"(x), "r"(y[j]));
    }
    asm volatile("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(hl) : "r"(x), "r"(y[S - 1]));
    asm volatile("addc.u32 %0, %0, 0;" : "+r"(hh));
  } else {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const uint64_t s = t[j] + (uint64_t)x * y[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    const uint64_t h = ((uint64_t)hh << 32 | hl) + c;
    hl = (uint32_t)h;
    hh = (uint32_t)(h >> 32);
  }
}

// One running CIOS sum t of the cooperative product: this lane's S = W/TPI
// words, and the carry (hh:hl) out of its top word, which belongs at word
// (lane + 1)·S.  `step` adds one outer word of a (already broadcast) and
// divides by 2^32; `finish` settles the carries between lanes and the
// final subtraction.  coop_mont_mul runs one sum, coop_mont_mul2 two
// independent ones step by step, so that the shuffles and carry chains of
// the one hide the latency of the other's.
template <int W, int TPI>
struct CoopMontSum {
  static_assert(TPI >= 1 && TPI <= 32 && (TPI & (TPI - 1)) == 0,
                "TPI: a power of two within one warp");
  static_assert(W % TPI == 0, "TPI must divide W");
  static constexpr int S = W / TPI;
  uint32_t t[S];
  uint32_t hl, hh;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < S; ++j) t[j] = 0;
    hl = hh = 0;
  }

  // t = (t + x·b + q·m) / 2^32 for this step's outer word x.
  __device__ __forceinline__ void step(uint32_t x, const uint32_t* b,
                                       const uint32_t* m, uint32_t mp,
                                       int lane) {
    row_mac<S>(t, x, b, hl, hh);
    const uint32_t q = __shfl_sync(kWarpAll, t[0], 0, TPI) * mp;
    row_mac<S>(t, q, m, hl, hh);
    // t / 2^32: lane 0's word 0 is now zero and drops out.
    uint32_t up = __shfl_down_sync(kWarpAll, t[0], 1, TPI);
    if (lane == TPI - 1) up = 0;
#pragma unroll
    for (int j = 0; j + 1 < S; ++j) t[j] = t[j + 1];
    const uint64_t s = (uint64_t)up + ((uint64_t)hh << 32 | hl);
    t[S - 1] = (uint32_t)s;
    hl = (uint32_t)(s >> 32);
    hh = 0;
  }

  // r = t mod m, canonical: t < 2m after the last step (for a, b < m < R,
  // whatever the gap between m and R: a padded modulus too, mont.cuh).
  // A lane's hi, the carry out of its slice, is at most 2 at any m.
  __device__ __forceinline__ void finish(uint32_t* r, const uint32_t* m,
                                         int lane) {
    const uint32_t hi = hl;  // at most 2
    // The lower lane's hi belongs at this lane's word 0.
    uint32_t c = __shfl_up_sync(kWarpAll, hi, 1, TPI);
    if (lane == 0) c = 0;
    uint32_t ones = 0xffffffffu;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const uint64_t s = (uint64_t)t[j] + c;
      t[j] = (uint32_t)s;
      c = (uint32_t)(s >> 32);
      ones &= t[j];
    }
    uint32_t top;  // word W of t: 0 or 1, since t < 2m < 2R
    c = group_carries<TPI>(c != 0, ones == 0xffffffffu, &top);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const uint64_t s = (uint64_t)t[j] + c;
      t[j] = (uint32_t)s;
      c = (uint32_t)(s >> 32);
    }
    top += __shfl_sync(kWarpAll, hi, TPI - 1, TPI);
    // t - m, borrows between lanes settled the same way.
    uint32_t d[S], borrow = 0, any = 0;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const uint64_t x = (uint64_t)t[j] - m[j] - borrow;
      d[j] = (uint32_t)x;
      borrow = (uint32_t)(x >> 63);
      any |= d[j];
    }
    uint32_t borrow_out;
    borrow = group_carries<TPI>(borrow != 0, any == 0, &borrow_out);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const uint64_t x = (uint64_t)d[j] - borrow;
      d[j] = (uint32_t)x;
      borrow = (uint32_t)(x >> 63);
    }
    // Keep t when t < m (no word W and a borrow out), else t - m.
    const uint32_t keep = 0u - (uint32_t)((top == 0) & (borrow_out != 0));
#pragma unroll
    for (int j = 0; j < S; ++j) r[j] = (t[j] & keep) | (d[j] & ~keep);
  }
};

// r = a·b·R^-1 mod m, R = 2^(32·W), the same canonical result as
// vmn::mont_mul<W>.  a, b, m, r: this lane's W/TPI words (registers);
// a, b canonical (< m); r may alias a or b.  mp = -m^-1 mod 2^32.
template <int W, int TPI>
__device__ __forceinline__ void coop_mont_mul(uint32_t* r, const uint32_t* a,
                                              const uint32_t* b,
                                              const uint32_t* m, uint32_t mp) {
  constexpr int S = W / TPI;
  const int lane = group_lane<TPI>();
  CoopMontSum<W, TPI> acc;
  acc.init();
#pragma unroll 1
  for (int src = 0; src < TPI; ++src) {
#pragma unroll
    for (int k = 0; k < S; ++k) {  // outer word i = src·S + k
      acc.step(__shfl_sync(kWarpAll, a[k], src, TPI), b, m, mp, lane);
    }
  }
  acc.finish(r, m, lane);
}

// r1 = a1·b1·R^-1 and r2 = a2·b2·R^-1 mod m, two independent products run
// step by step together.  Each r may alias any operand: both are written
// after every step has read them.
template <int W, int TPI>
__device__ __forceinline__ void coop_mont_mul2(
    uint32_t* r1, const uint32_t* a1, const uint32_t* b1, uint32_t* r2,
    const uint32_t* a2, const uint32_t* b2, const uint32_t* m, uint32_t mp) {
  constexpr int S = W / TPI;
  const int lane = group_lane<TPI>();
  CoopMontSum<W, TPI> acc1, acc2;
  acc1.init();
  acc2.init();
#pragma unroll 1
  for (int src = 0; src < TPI; ++src) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const uint32_t x1 = __shfl_sync(kWarpAll, a1[k], src, TPI);
      const uint32_t x2 = __shfl_sync(kWarpAll, a2[k], src, TPI);
      acc1.step(x1, b1, m, mp, lane);
      acc2.step(x2, b2, m, mp, lane);
    }
  }
  acc1.finish(r1, m, lane);
  acc2.finish(r2, m, lane);
}

// This lane's W/TPI words of one element stored as 2W row-major 16-bit
// limbs in int32 (words lane·S .. lane·S+S-1; two limbs per 8-byte load).
template <int W, int TPI>
__device__ __forceinline__ void load_slice(uint32_t* x, const int32_t* row) {
  constexpr int S = W / TPI;
  const int2* p = reinterpret_cast<const int2*>(row) + group_lane<TPI>() * S;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int2 v = p[j];
    x[j] = (uint32_t)v.x | ((uint32_t)v.y << 16);
  }
}

template <int W, int TPI>
__device__ __forceinline__ void store_slice(int32_t* row, const uint32_t* x) {
  constexpr int S = W / TPI;
  int2* p = reinterpret_cast<int2*>(row) + group_lane<TPI>() * S;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    p[j] = make_int2((int32_t)(x[j] & 0xFFFFu), (int32_t)(x[j] >> 16));
  }
}

// The boundary of a padded modulus (Modulus in ops/mont_kernels.py): x =
// x·c·R^-1 mod m at the kernel's radix R = 2^(32·W), for this lane's slice
// x of a canonical value and the constant c, 2W row-major 16-bit limbs;
// nothing where c is NULL (a modulus whose L limbs are W words: every
// width but the padded ones).  c = c_in takes an operand from the limbs'
// radix R0 = 2^(16·L) to R (x·R0 -> x·R), c = c_out back (x·R -> x·R0).
// The branch is uniform over the launch (a kernel argument), so every
// lane of the warp takes the product's shuffles together.
template <int W, int TPI>
__device__ __forceinline__ void coop_rebase(uint32_t* x, const int32_t* c,
                                            const uint32_t* m, uint32_t mp) {
  if (c == nullptr) return;
  uint32_t k[W / TPI];
  load_slice<W, TPI>(k, c);
  coop_mont_mul<W, TPI>(x, x, k, m, mp);
}

}  // namespace vmn

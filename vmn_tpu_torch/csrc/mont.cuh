// Device Montgomery arithmetic shared by every kernel of mont_kernels.cu.
//
// Counterpart of K1 in vmn_tpu/ops/mont_kernels.py (_mmul_rows :136-176
// with _ks_carry :71-91, _ks_sub :94-115, _normalize_sub :118-133).  The
// TPU has no carry chain, so K1 accumulates 16-bit partial products in
// 32-bit lanes and resolves carries with Kogge-Stone scans.  Here one
// thread owns one element and runs word-serial CIOS over 32-bit words
// with 64-bit accumulators (nvcc emits mul.wide/add.cc/addc chains), so
// no carry scan exists.
//
// Format at the kernel boundary: 16-bit limbs held in int32, limb-major
// (L, N) so that a warp reads limb i of 32 neighbouring elements in one
// coalesced load.  Inside a thread two limbs pack into one 32-bit word,
// W = L/2 words.  The radix stays R = 2^(16·L) = 2^(32·W); the word-level
// m' = -m^-1 mod 2^32 replaces vmn_tpu's 16-bit one.  Odd L has no such
// packing and is refused by the Python wrappers.
#pragma once

#include <cstdint>

namespace vmn {

// r = a*b*R^-1 mod m.  a, b canonical (< m), W words each; r may alias a
// or b (it is written only after both are read).  m: W words (shared or
// global), mp = -m^-1 mod 2^32.  Schedule is data independent.
template <int W>
__device__ __forceinline__ void mont_mul(uint32_t* r, const uint32_t* a,
                                         const uint32_t* b,
                                         const uint32_t* __restrict__ m,
                                         uint32_t mp) {
  uint32_t bb[W];
#pragma unroll
  for (int j = 0; j < W; ++j) bb[j] = b[j];
  uint32_t t[W + 2];
#pragma unroll
  for (int j = 0; j < W + 2; ++j) t[j] = 0;
  // Unrolled at the curve widths, so that an operand held in registers
  // (the EC kernels' coordinates) is never indexed by a loop variable
  // and stays out of local memory; a rolled loop at the ModP widths.
#pragma unroll (W <= 16 ? W : 1)
  for (int i = 0; i < W; ++i) {
    const uint64_t ai = a[i];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const uint64_t s = (uint64_t)t[j] + ai * bb[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[W] + c;
    t[W] = (uint32_t)s;
    t[W + 1] = (uint32_t)(s >> 32);
    const uint64_t q = (uint32_t)(t[0] * mp);
    s = (uint64_t)t[0] + q * m[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < W; ++j) {
      s = (uint64_t)t[j] + q * m[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[W] + c;
    t[W - 1] = (uint32_t)s;
    t[W] = t[W + 1] + (uint32_t)(s >> 32);
  }
  // t < 2m: subtract m when t >= m, by mask (no branch on the value).
  uint32_t d[W];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint64_t x = (uint64_t)t[j] - m[j] - borrow;
    d[j] = (uint32_t)x;
    borrow = x >> 63;
  }
  const uint32_t keep = 0u - (uint32_t)((t[W] == 0) & (borrow != 0));
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = (t[j] & keep) | (d[j] & ~keep);
}

// Word k of element e from limb-major 16-bit limbs (L = 2W rows of n).
template <int W>
__device__ __forceinline__ void load_words(uint32_t* x, const int32_t* src,
                                           int64_t n, int64_t e) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    x[k] = (uint32_t)src[(2 * k) * n + e] |
           ((uint32_t)src[(2 * k + 1) * n + e] << 16);
  }
}

template <int W>
__device__ __forceinline__ void store_words(int32_t* dst, const uint32_t* x,
                                            int64_t n, int64_t e) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    dst[(2 * k) * n + e] = (int32_t)(x[k] & 0xFFFFu);
    dst[(2 * k + 1) * n + e] = (int32_t)(x[k] >> 16);
  }
}

// A (2W,) limb vector (modulus, Montgomery one) packed into W words by the
// threads of a block; the caller synchronises.
template <int W>
__device__ __forceinline__ void load_vec_shared(uint32_t* dst,
                                                const int32_t* src) {
  for (int k = threadIdx.x; k < W; k += blockDim.x) {
    dst[k] = (uint32_t)src[2 * k] | ((uint32_t)src[2 * k + 1] << 16);
  }
}

// Digit j of width WB (4 or 8) of element e's exponent, limb-major
// (le, n) 16-bit limbs; digits past the last limb read as zero.
template <int WB>
__device__ __forceinline__ uint32_t digit(const int32_t* e, int le, int64_t n,
                                          int64_t idx, int j) {
  constexpr int kPerLimb = 16 / WB;
  const int limb = j / kPerLimb;
  const int shift = (j % kPerLimb) * WB;
  const uint32_t v = limb < le ? (uint32_t)e[limb * n + idx] : 0u;
  return (v >> shift) & ((1u << WB) - 1u);
}

}  // namespace vmn

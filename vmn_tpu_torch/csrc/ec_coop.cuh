// K8's field over a group of TPI lanes of one warp: the cooperative form
// of ec.cuh's Field, for the point formulas of ec.cuh (point_double,
// point_add), which run on it unchanged.
//
// Counterpart of K8 in vmn_tpu/ops/ec_kernels.py (_fadd :55, _fsub :69,
// _is_zero :92, _msel :101, _F :106) on the layout of mont_coop.cuh: lane
// k of a group owns words k·S .. k·S+S-1, S = W/TPI, of every value.
// Products are vmn::coop_mont_mul<W, TPI>, two independent ones of a
// point formula at a time through coop_mont_mul2.  A sum or difference
// carries between lanes: each lane adds its own slice, then the carries (or
// borrows) between the lanes are settled at once from generate/propagate
// ballots (group_carries), as the final subtraction of the product is.
// Every choice that depends on the whole value (a + b >= m, a < b, a value
// is zero) comes from a group ballot, so that all lanes of the group take
// the same one.  Values stay canonical (below m), so the limbs equal those
// of the one-thread Field and of the TPU kernels.
//
// As in mont_coop.cuh, every lane of the warp calls these functions
// together (full-warp ballots and shuffles), and no branch or index
// depends on a value (docs/DEVIATIONS.md #5).
#pragma once

#include <cstdint>

#include "ec.cuh"
#include "mont_coop.cuh"

namespace vmn {

// All-ones in every lane of the group when the group's value is zero.
template <int W, int TPI>
__device__ __forceinline__ uint32_t coop_is_zero(const uint32_t* x) {
  constexpr int S = W / TPI;
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < S; ++k) acc |= x[k];
  return 0u - (uint32_t)(group_ballot<TPI>(acc != 0) == 0);
}

// x[0..S-1] += c (0 or 1) with the carry run through the slice.
template <int S>
__device__ __forceinline__ void add_carry_in(uint32_t* x, uint32_t c) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const uint64_t t = (uint64_t)x[k] + c;
    x[k] = (uint32_t)t;
    c = (uint32_t)(t >> 32);
  }
}

// x[0..S-1] -= b (0 or 1) with the borrow run through the slice.
template <int S>
__device__ __forceinline__ void sub_borrow_in(uint32_t* x, uint32_t b) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const uint64_t t = (uint64_t)x[k] - b;
    x[k] = (uint32_t)t;
    b = (uint32_t)(t >> 63);
  }
}

// s = a + b over the group's W words; returns the carry out of the top
// lane (the same in every lane).  s may alias a or b.
template <int W, int TPI>
__device__ __forceinline__ uint32_t coop_add_words(uint32_t* s,
                                                   const uint32_t* a,
                                                   const uint32_t* b) {
  constexpr int S = W / TPI;
  uint64_t c = 0;
  uint32_t ones = 0xffffffffu;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const uint64_t t = (uint64_t)a[k] + b[k] + c;
    s[k] = (uint32_t)t;
    c = t >> 32;
    ones &= s[k];
  }
  // A slice that carried out is not all ones (its sum is at most
  // 2^(32S+1) - 2), so generate and propagate never hold together.
  uint32_t top;
  add_carry_in<S>(s, group_carries<TPI>(c != 0, ones == 0xffffffffu, &top));
  return top;
}

// d = a - b over the group's W words; returns the borrow out of the top
// lane (the same in every lane).  d may alias a or b.
template <int W, int TPI>
__device__ __forceinline__ uint32_t coop_sub_words(uint32_t* d,
                                                   const uint32_t* a,
                                                   const uint32_t* b) {
  constexpr int S = W / TPI;
  uint32_t borrow = 0, any = 0;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const uint64_t t = (uint64_t)a[k] - b[k] - borrow;
    d[k] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
    any |= d[k];
  }
  // A slice that borrowed out is not zero, so the two never hold together.
  uint32_t top;
  sub_borrow_in<S>(d, group_carries<TPI>(borrow != 0, any == 0, &top));
  return top;
}

// r = (a + b) mod m for canonical a, b < m; r may alias a or b.  As in
// ec.cuh, a + b < 2m < 2R carries at most once out of the top lane, for
// any m < R (a padded modulus too).
template <int W, int TPI>
__device__ __forceinline__ void coop_fadd(uint32_t* r, const uint32_t* a,
                                          const uint32_t* b,
                                          const uint32_t* m) {
  constexpr int S = W / TPI;
  uint32_t s[S], d[S];
  const uint32_t carry = coop_add_words<W, TPI>(s, a, b);
  const uint32_t borrow = coop_sub_words<W, TPI>(d, s, m);
  // a + b >= m exactly when the sum carried out or s - m did not borrow.
  msel<S>(r, 0u - (uint32_t)((carry != 0) | (borrow == 0)), d, s);
}

// r = (a - b) mod m for canonical a, b < m; r may alias a or b.
template <int W, int TPI>
__device__ __forceinline__ void coop_fsub(uint32_t* r, const uint32_t* a,
                                          const uint32_t* b,
                                          const uint32_t* m) {
  constexpr int S = W / TPI;
  uint32_t d[S], madd[S];
  const uint32_t mask = 0u - coop_sub_words<W, TPI>(d, a, b);  // a < b
#pragma unroll
  for (int k = 0; k < S; ++k) madd[k] = m[k] & mask;
  coop_add_words<W, TPI>(r, d, madd);  // the carry out of a - b + m drops
}

// The field of one curve over a group of TPI lanes: this lane's S words
// of the modulus (registers) and m'.
template <int W, int TPI>
struct CoopField {
  static_assert(W % TPI == 0, "TPI must divide W");
  static constexpr int kWords = W / TPI;
  const uint32_t* m;
  uint32_t mp;

  __device__ __forceinline__ void mul(uint32_t* r, const uint32_t* a,
                                      const uint32_t* b) const {
    coop_mont_mul<W, TPI>(r, a, b, m, mp);
  }
  __device__ __forceinline__ void sq(uint32_t* r, const uint32_t* a) const {
    coop_mont_mul<W, TPI>(r, a, a, m, mp);
  }
  __device__ __forceinline__ void mul2(uint32_t* r1, const uint32_t* a1,
                                       const uint32_t* b1, uint32_t* r2,
                                       const uint32_t* a2,
                                       const uint32_t* b2) const {
    coop_mont_mul2<W, TPI>(r1, a1, b1, r2, a2, b2, m, mp);
  }
  __device__ __forceinline__ void add(uint32_t* r, const uint32_t* a,
                                      const uint32_t* b) const {
    coop_fadd<W, TPI>(r, a, b, m);
  }
  __device__ __forceinline__ void sub(uint32_t* r, const uint32_t* a,
                                      const uint32_t* b) const {
    coop_fsub<W, TPI>(r, a, b, m);
  }
  __device__ __forceinline__ void dbl(uint32_t* r, const uint32_t* a) const {
    coop_fadd<W, TPI>(r, a, a, m);
  }
  __device__ __forceinline__ uint32_t is_zero(const uint32_t* a) const {
    return coop_is_zero<W, TPI>(a);
  }
};

// P + P as the branchless addition computes it, at a doubling's cost: the
// addition of a point to itself takes its doubling branch (H = R = 0)
// unless the point is at infinity (Z = 0), where it returns the point as
// it is.  So this is point_double, kept out where Z = 0: the same limbs
// as point_add(P, P) on every input, (0, Y, 0) included.
template <class Fld>
__device__ __forceinline__ void point_double_as_add(const Fld& F, uint32_t* X,
                                                    uint32_t* Y, uint32_t* Z) {
  constexpr int S = Fld::kWords;
  uint32_t dX[S], dY[S], dZ[S];
  point_double(F, dX, dY, dZ, X, Y, Z);
  const uint32_t inf = F.is_zero(Z);
  msel<S>(X, inf, X, dX);
  msel<S>(Y, inf, Y, dY);
  msel<S>(Z, inf, Z, dZ);
}

// A point's three coordinates through coop_rebase (mont_coop.cuh): to the
// kernel's radix (c_in) or back (c_out) at a padded modulus; nothing where
// c is NULL.  Zero stays zero, so Z == 0 (infinity) is kept.
template <int W, int TPI>
__device__ __forceinline__ void coop_rebase3(uint32_t* X, uint32_t* Y,
                                             uint32_t* Z, const int32_t* c,
                                             const uint32_t* m, uint32_t mp) {
  if (c == nullptr) return;
  uint32_t k[W / TPI];
  load_slice<W, TPI>(k, c);
  coop_mont_mul2<W, TPI>(X, X, k, Y, Y, k, m, mp);
  coop_mont_mul<W, TPI>(Z, Z, k, m, mp);
}

}  // namespace vmn

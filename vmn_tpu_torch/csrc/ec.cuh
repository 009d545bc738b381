// Device elliptic-curve arithmetic over a prime field, shared by every
// kernel of ec_kernels.cu.
//
// Counterpart of K8 in vmn_tpu/ops/ec_kernels.py: _fadd :55, _fsub :69,
// _is_zero :92, _msel :101, _F :106, _point_double :138-152 and the
// branchless _point_add :155-192.  The TPU kernel resolves the carries
// of field add/sub with Kogge-Stone scans over 16-bit limbs in 32-bit
// lanes; here one thread owns one point and runs 32-bit word carry
// chains, the same format as mont.cuh (W = L/2 words, canonical values
// below p, Montgomery form).  Every product is vmn::mont_mul (K1's port).
//
// Formulas are vmn_tpu's, value for value: a = -3 Jacobian doubling and
// the general Jacobian addition whose exceptional cases (either input at
// infinity, P == Q, P == -Q) are resolved by per-thread masks, never by
// a branch on data.  Infinity is Z == 0.  All values stay canonical, so
// the outputs equal the TPU kernel's limb for limb.
//
// The point formulas are written once, over a field type F that holds
// F::kWords words of each value in a thread: Field<W> here (one thread,
// the whole value), CoopField<W, TPI> in ec_coop.cuh (W/TPI words in each
// of TPI lanes).  Register use: a Jacobian addition at W = 8 keeps its six
// input coordinates, three outputs and the doubling's temporaries live
// (about 150 words on one thread); everything is inlined and indexed by
// unrolled constants so that the coordinates stay in registers.
#pragma once

#include <cstdint>

#include "mont.cuh"

namespace vmn {

// All-ones when the W-word value is zero, else 0.
template <int W>
__device__ __forceinline__ uint32_t is_zero_mask(const uint32_t* x) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) acc |= x[k];
  return 0u - (uint32_t)(acc == 0);
}

// r = mask ? a : b, word by word.
template <int W>
__device__ __forceinline__ void msel(uint32_t* r, uint32_t mask,
                                     const uint32_t* a, const uint32_t* b) {
#pragma unroll
  for (int k = 0; k < W; ++k) r[k] = (a[k] & mask) | (b[k] & ~mask);
}

template <int W>
__device__ __forceinline__ void copy(uint32_t* r, const uint32_t* a) {
#pragma unroll
  for (int k = 0; k < W; ++k) r[k] = a[k];
}

template <int W>
__device__ __forceinline__ void set_zero(uint32_t* r) {
#pragma unroll
  for (int k = 0; k < W; ++k) r[k] = 0;
}

// r = (a + b) mod m for canonical a, b < m; r may alias a or b.  a + b <
// 2m < 2R: one carry out of the top word, for any m < R (a padded modulus
// too); every value stays canonical, so nothing is lazy.
template <int W>
__device__ __forceinline__ void fadd(uint32_t* r, const uint32_t* a,
                                     const uint32_t* b,
                                     const uint32_t* __restrict__ m) {
  uint32_t s[W], d[W];
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const uint64_t t = (uint64_t)a[k] + b[k] + c;
    s[k] = (uint32_t)t;
    c = t >> 32;
  }
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const uint64_t t = (uint64_t)s[k] - m[k] - borrow;
    d[k] = (uint32_t)t;
    borrow = t >> 63;
  }
  // a + b >= m exactly when the sum carried out or s - m did not borrow.
  const uint32_t take_d = 0u - (uint32_t)((c != 0) | (borrow == 0));
  msel<W>(r, take_d, d, s);
}

// r = (a - b) mod m for canonical a, b < m; r may alias a or b.
template <int W>
__device__ __forceinline__ void fsub(uint32_t* r, const uint32_t* a,
                                     const uint32_t* b,
                                     const uint32_t* __restrict__ m) {
  uint32_t d[W];
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const uint64_t t = (uint64_t)a[k] - b[k] - borrow;
    d[k] = (uint32_t)t;
    borrow = t >> 63;
  }
  const uint32_t mask = 0u - (uint32_t)borrow;  // a < b: add m back
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const uint64_t t = (uint64_t)d[k] + (m[k] & mask) + c;
    r[k] = (uint32_t)t;
    c = t >> 32;
  }
}

// The field of one curve on one thread: modulus words (shared memory)
// and m'.  With kFence, each product starts behind a fence (a compiler
// fence and __syncwarp, over the lanes that run it), and mul2 runs its
// two products one after the other: values kept in shared memory (the
// modulus; H6's tables, sums and factors) are then read again where a
// product uses them instead of being held in registers from one product
// to the next, and the two products' temporaries are not live together,
// so that the formulas fit a register budget (H6's) without spilling.
template <int W, bool kFence = false>
struct Field {
  static constexpr int kWords = W;
  const uint32_t* m;
  uint32_t mp;

  __device__ __forceinline__ static void fence() {
    if constexpr (kFence) {
      asm volatile("" ::: "memory");
      __syncwarp(__activemask());
    }
  }
  __device__ __forceinline__ void mul(uint32_t* r, const uint32_t* a,
                                      const uint32_t* b) const {
    fence();
    mont_mul<W>(r, a, b, m, mp);
  }
  __device__ __forceinline__ void sq(uint32_t* r, const uint32_t* a) const {
    fence();
    mont_mul<W>(r, a, a, m, mp);
  }
  // Two independent products; each r may alias any operand.  One thread
  // runs them in turn (the compiler interleaves the unrolled rows).
  __device__ __forceinline__ void mul2(uint32_t* r1, const uint32_t* a1,
                                       const uint32_t* b1, uint32_t* r2,
                                       const uint32_t* a2,
                                       const uint32_t* b2) const {
    fence();
    uint32_t t[W];
    mont_mul<W>(t, a1, b1, m, mp);
    fence();
    mont_mul<W>(r2, a2, b2, m, mp);
    copy<W>(r1, t);
  }
  __device__ __forceinline__ void add(uint32_t* r, const uint32_t* a,
                                      const uint32_t* b) const {
    fadd<W>(r, a, b, m);
  }
  __device__ __forceinline__ void sub(uint32_t* r, const uint32_t* a,
                                      const uint32_t* b) const {
    fsub<W>(r, a, b, m);
  }
  __device__ __forceinline__ void dbl(uint32_t* r, const uint32_t* a) const {
    fadd<W>(r, a, a, m);
  }
  __device__ __forceinline__ uint32_t is_zero(const uint32_t* a) const {
    return is_zero_mask<W>(a);
  }
};

// (X3, Y3, Z3) = 2·(X, Y, Z), a = -3 (vmn_tpu/ops/ec_kernels.py:138-152).
// The outputs may alias the inputs.  The 8 products run as 4 pairs of
// independent ones (F.mul2); every value is the reference's.
template <class Fld>
__device__ __forceinline__ void point_double(const Fld& F, uint32_t* X3,
                                             uint32_t* Y3, uint32_t* Z3,
                                             const uint32_t* X,
                                             const uint32_t* Y,
                                             const uint32_t* Z) {
  constexpr int W = Fld::kWords;
  uint32_t delta[W], gamma[W], beta[W], alpha[W], t[W], u[W], v[W];
  F.add(v, Y, Z);
  F.mul2(delta, Z, Z, gamma, Y, Y);
  F.sub(t, X, delta);  // xmd
  F.dbl(u, t);
  F.add(u, u, t);      // 3·xmd
  F.add(t, X, delta);  // xpd
  F.mul2(beta, X, gamma, alpha, u, t);  // X is dead from here
  F.mul2(v, v, v, t, alpha, alpha);     // (Y + Z)^2, alpha^2
  F.dbl(beta, beta);
  F.dbl(beta, beta);   // beta4
  F.dbl(u, beta);      // beta8
  F.sub(X3, t, u);
  F.sub(v, v, gamma);
  F.sub(Z3, v, delta);
  F.sub(t, beta, X3);
  F.mul2(gamma, gamma, gamma, t, alpha, t);  // g2, alpha·(beta4 - X3)
  F.dbl(gamma, gamma);
  F.dbl(gamma, gamma);
  F.dbl(gamma, gamma);  // g8
  F.sub(Y3, t, gamma);
}

// (X3, Y3, Z3) = (X1, Y1, Z1) + (X2, Y2, Z2), branchless
// (vmn_tpu/ops/ec_kernels.py:155-192).  The outputs may alias either input.
// The 16 products of the addition run as 8 pairs of independent ones.
template <class Fld>
__device__ __forceinline__ void point_add(const Fld& F, uint32_t* X3,
                                          uint32_t* Y3, uint32_t* Z3,
                                          const uint32_t* X1,
                                          const uint32_t* Y1,
                                          const uint32_t* Z1,
                                          const uint32_t* X2,
                                          const uint32_t* Y2,
                                          const uint32_t* Z2) {
  constexpr int W = Fld::kWords;
  uint32_t z1z1[W], z2z2[W], u1[W], s1[W], s2[W], h[W], r[W], t[W], v[W];
  uint32_t rx[W], ry[W], rz[W];
  F.mul2(z1z1, Z1, Z1, z2z2, Z2, Z2);
  F.mul2(s1, Y1, Z2, s2, Y2, Z1);
  F.mul2(u1, X1, z2z2, t, X2, z1z1);  // U1, U2
  F.sub(h, t, u1);                    // H = U2 - U1
  F.mul2(s1, s1, z2z2, s2, s2, z1z1); // S1, S2
  F.sub(r, s2, s1);                   // R = S2 - S1
  F.mul2(rz, Z1, Z2, t, h, h);        // Z1·Z2, HH
  F.mul2(rz, rz, h, rx, r, r);        // Z3 = Z1·Z2·H, R^2
  F.mul2(v, u1, t, t, h, t);          // V = U1·HH, HHH
  F.sub(rx, rx, t);
  F.dbl(z1z1, v);
  F.sub(rx, rx, z1z1);                // X3 = R^2 - HHH - 2V
  F.sub(s2, v, rx);
  F.mul2(s1, s1, t, ry, r, s2);       // S1·HHH, R(V - X3)
  F.sub(ry, ry, s1);                  // Y3 = R(V - X3) - S1·HHH

  const uint32_t p1_inf = F.is_zero(Z1);
  const uint32_t p2_inf = F.is_zero(Z2);
  const uint32_t h_zero = F.is_zero(h);
  const uint32_t r_zero = F.is_zero(r);
  const uint32_t same = h_zero & r_zero;   // P == Q: take the double
  const uint32_t opp = h_zero & ~r_zero;   // P == -Q: infinity

  point_double(F, u1, s1, t, X1, Y1, Z1);
  msel<W>(rx, same, u1, rx);
  msel<W>(ry, same, s1, ry);
  msel<W>(rz, same, t, rz);
  set_zero<W>(t);
  msel<W>(rz, opp & ~(p1_inf | p2_inf), t, rz);
  msel<W>(rx, p1_inf, X2, rx);
  msel<W>(ry, p1_inf, Y2, ry);
  msel<W>(rz, p1_inf, Z2, rz);
  msel<W>(rx, p2_inf, X1, rx);
  msel<W>(ry, p2_inf, Y1, ry);
  msel<W>(rz, p2_inf, Z1, rz);
  copy<W>(X3, rx);
  copy<W>(Y3, ry);
  copy<W>(Z3, rz);
}

}  // namespace vmn

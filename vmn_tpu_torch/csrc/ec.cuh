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
// Register use: a Jacobian addition at W = 8 keeps its six input
// coordinates, three outputs and the doubling's temporaries live (about
// 150 words); everything is inlined and indexed by unrolled constants so
// that the coordinates stay in registers.
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

// r = (a + b) mod m for canonical a, b < m; r may alias a or b.
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

// The field of one curve: modulus words (shared memory) and m'.
template <int W>
struct Field {
  const uint32_t* m;
  uint32_t mp;

  __device__ __forceinline__ void mul(uint32_t* r, const uint32_t* a,
                                      const uint32_t* b) const {
    mont_mul<W>(r, a, b, m, mp);
  }
  __device__ __forceinline__ void sq(uint32_t* r, const uint32_t* a) const {
    mont_mul<W>(r, a, a, m, mp);
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
};

// (X3, Y3, Z3) = 2·(X, Y, Z), a = -3 (vmn_tpu/ops/ec_kernels.py:138-152).
// The outputs may alias the inputs.
template <int W>
__device__ __forceinline__ void point_double(const Field<W>& F, uint32_t* X3,
                                             uint32_t* Y3, uint32_t* Z3,
                                             const uint32_t* X,
                                             const uint32_t* Y,
                                             const uint32_t* Z) {
  uint32_t delta[W], gamma[W], beta[W], alpha[W], t[W], u[W];
  F.sq(delta, Z);
  F.sq(gamma, Y);
  F.mul(beta, X, gamma);
  F.sub(t, X, delta);  // xmd
  F.dbl(u, t);
  F.add(u, u, t);      // 3·xmd
  F.add(t, X, delta);  // xpd
  F.mul(alpha, u, t);
  F.dbl(beta, beta);
  F.dbl(beta, beta);   // beta4
  F.add(t, Y, Z);
  F.sq(t, t);
  F.sub(t, t, gamma);
  F.sub(Z3, t, delta);  // Z is dead from here
  F.dbl(u, beta);       // beta8
  F.sq(t, alpha);
  F.sub(X3, t, u);      // X is dead from here
  F.sq(gamma, gamma);   // g2
  F.dbl(gamma, gamma);
  F.dbl(gamma, gamma);
  F.dbl(gamma, gamma);  // g8
  F.sub(t, beta, X3);
  F.mul(t, alpha, t);
  F.sub(Y3, t, gamma);
}

// (X3, Y3, Z3) = (X1, Y1, Z1) + (X2, Y2, Z2), branchless
// (vmn_tpu/ops/ec_kernels.py:155-192).  The outputs may alias either input.
template <int W>
__device__ __forceinline__ void point_add(const Field<W>& F, uint32_t* X3,
                                          uint32_t* Y3, uint32_t* Z3,
                                          const uint32_t* X1,
                                          const uint32_t* Y1,
                                          const uint32_t* Z1,
                                          const uint32_t* X2,
                                          const uint32_t* Y2,
                                          const uint32_t* Z2) {
  uint32_t z1z1[W], z2z2[W], u1[W], s1[W], h[W], r[W], t[W], v[W];
  uint32_t rx[W], ry[W], rz[W];
  F.sq(z1z1, Z1);
  F.sq(z2z2, Z2);
  F.mul(u1, X1, z2z2);
  F.mul(t, X2, z1z1);         // U2
  F.sub(h, t, u1);            // H = U2 - U1
  F.mul(s1, Y1, Z2);
  F.mul(s1, s1, z2z2);        // S1
  F.mul(t, Y2, Z1);
  F.mul(t, t, z1z1);          // S2
  F.sub(r, t, s1);            // R = S2 - S1
  F.mul(rz, Z1, Z2);
  F.mul(rz, rz, h);           // Z3 = Z1·Z2·H
  F.sq(t, h);                 // HH
  F.mul(v, u1, t);            // V = U1·HH
  F.mul(t, h, t);             // HHH
  F.sq(rx, r);
  F.sub(rx, rx, t);
  F.dbl(z1z1, v);
  F.sub(rx, rx, z1z1);        // X3 = R^2 - HHH - 2V
  F.mul(s1, s1, t);           // S1·HHH
  F.sub(v, v, rx);
  F.mul(ry, r, v);
  F.sub(ry, ry, s1);          // Y3 = R(V - X3) - S1·HHH

  const uint32_t p1_inf = is_zero_mask<W>(Z1);
  const uint32_t p2_inf = is_zero_mask<W>(Z2);
  const uint32_t h_zero = is_zero_mask<W>(h);
  const uint32_t r_zero = is_zero_mask<W>(r);
  const uint32_t same = h_zero & r_zero;   // P == Q: take the double
  const uint32_t opp = h_zero & ~r_zero;   // P == -Q: infinity

  point_double<W>(F, u1, s1, t, X1, Y1, Z1);
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

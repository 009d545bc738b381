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
// field (its design in ec_kernels.cuh).  H7 runs one point per thread, 128
// threads a block, on limb-major (L, n) int32 16-bit limbs, with the
// one-thread field.  Each entry point launches on the caller's stream, does
// not synchronise, allocates nothing and returns cudaGetLastError() (or
// kUnsupportedWidth for a width, or a TPI, with no instantiation,
// kBadShape for a launch shape the kernel cannot take).
//
// The kernels are in ec_kernels.cuh; this file holds the entry points,
// which reach each (W, TPI) through the launchers of ec_launch.cuh,
// instantiated in a source file of its width: W = 8 (P-256, L = 16) in
// ec_w8.cu and ec_mexp_w8.cu, W = 12 (P-384, L = 24) in ec_w12.cu and
// ec_mexp_w12.cu, W' = 20 (P-521, L = 33 limbs padded to 40, the
// conversion of coop_rebase at the kernels' boundary) in ec_w20.cu and
// ec_mexp_w20.cu.  P-224 (L = 14 limbs) runs on the W = 8
// instantiations at the inner width W' = 8, converted at the boundary as
// P-521 is (H6 in its one-thread form).  H7 has no padded form (off the
// paths).
#include <cuda_runtime.h>

#include <cstdint>

#include "ec_launch.cuh"

using vmn_ec::Add;
using vmn_ec::Chain;
using vmn_ec::Fb;
using vmn_ec::Mexp;
using vmn_ec::Smul;
using vmn_ec::kUnsupportedWidth;

extern "C" {

// H8 at (W, TPI) = (8, 2), (8, 4), (8, 8), (12, 4), (20, 4): the pairs
// that COOP_TPI["ec_point_add", W] in ops/mont_kernels.py can choose.
int vmn_ec_add(int w, int tpi, const int32_t* x1, const int32_t* y1,
               const int32_t* z1, const int32_t* x2, const int32_t* y2,
               const int32_t* z2, int32_t* ox, int32_t* oy, int32_t* oz,
               const int32_t* m, uint32_t mp, const int32_t* c_in,
               const int32_t* c_out, int64_t n, int threads, int64_t blocks,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VMN_ADD_ARGS x1, y1, z1, x2, y2, z2, ox, oy, oz, m, mp, c_in, c_out, \
                     n, threads, blocks, s
  switch (w << 8 | tpi) {
    case 8 << 8 | 2: return Add<8, 2>::launch(VMN_ADD_ARGS);
    case 8 << 8 | 4: return Add<8, 4>::launch(VMN_ADD_ARGS);
    case 8 << 8 | 8: return Add<8, 8>::launch(VMN_ADD_ARGS);
    case 12 << 8 | 4: return Add<12, 4>::launch(VMN_ADD_ARGS);
    case 20 << 8 | 4: return Add<20, 4>::launch(VMN_ADD_ARGS);
    default: return kUnsupportedWidth;
  }
#undef VMN_ADD_ARGS
}

// H5 at (W, TPI) = (8, 2), (8, 4), (12, 4), (20, 4): the pairs that
// COOP_TPI in ops/mont_kernels.py can choose.
int vmn_ec_smul(int w, int tpi, const int32_t* x, const int32_t* y,
                const uint8_t* inf, const int32_t* e, int32_t* ox, int32_t* oy,
                int32_t* oz, const int32_t* m, const int32_t* one, uint32_t mp,
                const int32_t* c_in, const int32_t* c_out, int64_t n, int le,
                int ndig, int threads, int64_t blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VMN_SMUL_ARGS x, y, inf, e, ox, oy, oz, m, one, mp, c_in, c_out, n, \
                      le, ndig, threads, blocks, s
  switch (w << 8 | tpi) {
    case 8 << 8 | 2: return Smul<8, 2>::launch(VMN_SMUL_ARGS);
    case 8 << 8 | 4: return Smul<8, 4>::launch(VMN_SMUL_ARGS);
    case 12 << 8 | 4: return Smul<12, 4>::launch(VMN_SMUL_ARGS);
    case 20 << 8 | 4: return Smul<20, 4>::launch(VMN_SMUL_ARGS);
    default: return kUnsupportedWidth;
  }
#undef VMN_SMUL_ARGS
}

// The combine at (W, TPI) = (8, 8), (12, 4) and (20, 4), one warp: at
// W = 8 the fastest of TPI 1, 2, 4 and 8 at 16 and 64 positions
// (kernel_timing.py --sweep, PERF.md §6); at W = 12 and 20 the most
// lanes that divide W.
int vmn_ec_chain(int w, int tpi, const int32_t* px, const int32_t* py,
                 const int32_t* pz, int32_t* ox, int32_t* oy, int32_t* oz,
                 const int32_t* m, const int32_t* one, uint32_t mp,
                 const int32_t* c_in, const int32_t* c_out, int npos,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VMN_CHAIN_ARGS px, py, pz, ox, oy, oz, m, one, mp, c_in, c_out, npos, s
  switch (w << 8 | tpi) {
    case 8 << 8 | 8: return Chain<8, 8>::launch(VMN_CHAIN_ARGS);
    case 12 << 8 | 4: return Chain<12, 4>::launch(VMN_CHAIN_ARGS);
    case 20 << 8 | 4: return Chain<20, 4>::launch(VMN_CHAIN_ARGS);
    default: return kUnsupportedWidth;
  }
#undef VMN_CHAIN_ARGS
}

// H6 over G = `blocks` blocks of MexpShape<W>::kThreads threads; `subs`
// folders a digit position (ec_multiexp_positions' mexp_shape); at W = 20
// the cooperative form.  c_in and c_out: both NULL or both set.
int vmn_ec_mexp(int w, const int32_t* x, const int32_t* y, const uint8_t* inf,
                const int32_t* e, int32_t* out, const int32_t* m,
                const int32_t* one, uint32_t mp, const int32_t* c_in,
                const int32_t* c_out, int64_t n, int le, int npos, int subs,
                int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VMN_MEXP_ARGS x, y, inf, e, out, m, one, mp, c_in, c_out, n, le, \
                      npos, subs, blocks, s
  switch (w) {
    case 8: return Mexp<8>::launch(VMN_MEXP_ARGS);
    case 12: return Mexp<12>::launch(VMN_MEXP_ARGS);
    case 20: return Mexp<20>::launch(VMN_MEXP_ARGS);
    default: return kUnsupportedWidth;
  }
#undef VMN_MEXP_ARGS
}

int vmn_ec_fb(int w, const int32_t* tx, const int32_t* ty, const int32_t* e,
              int32_t* ox, int32_t* oy, int32_t* oz, const int32_t* m,
              const int32_t* one, uint32_t mp, int64_t n, int le, int ndig,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VMN_FB_ARGS tx, ty, e, ox, oy, oz, m, one, mp, n, le, ndig, s
  switch (w) {
    case 8: return Fb<8>::launch(VMN_FB_ARGS);
    case 12: return Fb<12>::launch(VMN_FB_ARGS);
    default: return kUnsupportedWidth;
  }
#undef VMN_FB_ARGS
}

}  // extern "C"

// A hand-written Hopper kernel that expands prover randomness on the card,
// bound to Python through a plain C interface (ctypes; see
// ops/prf_kernels.py).
//
//   vmn_chacha20_limbs  replaces no Pallas kernel.  vmn_tpu expands a
//                       DeviceSource draw with an XLA program, _prf_limbs
//                       (vmn_tpu/crypto/randomsource.py:141-162): Threefry
//                       words split into 16-bit limbs.  This kernel keeps
//                       that layout with ChaCha20's keystream in place of
//                       Threefry's words.
//
// Why the algorithm differs: vmn_tpu squeezes its 256-bit seed into a
// Threefry-2x32 key of 64 bits (ROADMAP fault F1) and names no algorithm
// (F2).  Here the PRF is ChaCha20 with 20 rounds (RFC 8439 §2.3), keyed
// with all 256 bits; the nonce is 32 bits (nonce0, zero for a draw)
// followed by the 64-bit draw index, little-endian, and the 32-bit block
// counter starts at `counter0` (0 for a draw; RFC 8439's test block uses
// 1).  The wrapper refuses a draw past 2^32 blocks.
//
// Layout (vmn_tpu's _prf_limbs): row i of an n-row draw of `bits` bits is
// the nw = (lt + 1) / 2 keystream words from word i·nw on (a word is the
// block's state word after the final addition, i.e. its four keystream
// bytes read little-endian), each split low half first into two 16-bit
// limbs, the last half-word dropped when lt is odd, the top limb masked
// to `top_bits` bits.  A launch writes rows [row0, row1) alone, as an
// (row1 - row0, lt) int32 array: a rank of a sharded mix expands its own
// block of a draw and computes no other block.
//
// One thread computes one 64-byte block: the 16-word state in registers,
// 20 rounds of quarter rounds whose rotations are `__funnelshift_l`.  The
// stores go through shared memory, so that a warp stores consecutive
// int32s: each thread stages its block's 16 keystream words (after the
// final addition) in shared memory, a row of 17 words a thread (the
// padding word keeps the 32 lanes' stores on 32 banks); after one barrier
// the block's threads walk the output limbs of the block's words in
// order, thread i taking limbs i, i + 256, ..., each reading its word from
// shared memory.  A block's words may cross a row boundary (nw is not a
// multiple of 16), so a limb's (row, limb of the row) is stepped, not
// divided, and the limb dropped at odd lt is simply never an output limb.
// (Storing each word's limbs from registers, at row·lt + 2·col, put a
// warp's stores 128 bytes apart.)
//
// What bounds it on an H100: about 980 32-bit integer operations a block
// (20 rounds × 4 quarter rounds × 12 add/xor/rotate, the 16 final adds
// and the stores' index work), over 132 SMs × 64 integer operations a
// clock × 1.98 GHz (the CUDA C++ Programming Guide's throughput for
// 32-bit add, logical and funnel-shift instructions at compute
// capability 9.0); or 4 bytes written a limb over 3.35 TB/s.  At the
// modp2048 draw of N = 10000 (42,500 blocks, 5.4 MB) the operations take
// 2.5 µs and the bytes 1.6 µs: a launch is a few microseconds either way,
// next to the tens of milliseconds the host PRG took for the same bytes.
// Nothing is read but the kernel's parameters.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBadShape = -2;
constexpr int kRounds = 20;
constexpr int kThreads = 256;
// A thread's staged block: 16 words and a padding word.
constexpr int kStagedRow = 17;

struct ChachaArgs {
  uint32_t key[8];
  uint32_t nonce0;
  uint32_t nonce1;    // the draw index's low word
  uint32_t nonce2;    // its high word
  uint32_t counter0;  // the block counter of block 0 of the draw
  int64_t blk0;       // the first block this launch computes
  int64_t nblk;       // the blocks it computes
  int64_t word0;      // the first keystream word it stores: row0 · nw
  int64_t word1;      // the end of its words: row1 · nw
  int nw;             // keystream words a row
  int lt;             // limbs a row
  uint32_t top_mask;  // the top limb's mask
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void quarter(uint32_t& a, uint32_t& b, uint32_t& c,
                                        uint32_t& d) {
  a += b; d = rotl(d ^ a, 16);
  c += d; b = rotl(b ^ c, 12);
  a += b; d = rotl(d ^ a, 8);
  c += d; b = rotl(b ^ c, 7);
}

template <int ROUNDS>
__global__ void __launch_bounds__(kThreads)
    chacha_limbs_kernel(const ChachaArgs p, int32_t* __restrict__ out) {
  __shared__ uint32_t staged[kThreads * kStagedRow];
  const int64_t first_blk = p.blk0 + (int64_t)blockIdx.x * kThreads;
  const int64_t t = first_blk - p.blk0 + threadIdx.x;
  if (t < p.nblk) {
    const int64_t blk = first_blk + threadIdx.x;
    uint32_t s[16] = {0x61707865u, 0x3320646eu, 0x79622d32u, 0x6b206574u,
                      p.key[0], p.key[1], p.key[2], p.key[3],
                      p.key[4], p.key[5], p.key[6], p.key[7],
                      p.counter0 + (uint32_t)blk, p.nonce0, p.nonce1,
                      p.nonce2};
    uint32_t x[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) x[j] = s[j];
#pragma unroll
    for (int r = 0; r < ROUNDS; r += 2) {
      quarter(x[0], x[4], x[8], x[12]);
      quarter(x[1], x[5], x[9], x[13]);
      quarter(x[2], x[6], x[10], x[14]);
      quarter(x[3], x[7], x[11], x[15]);
      quarter(x[0], x[5], x[10], x[15]);
      quarter(x[1], x[6], x[11], x[12]);
      quarter(x[2], x[7], x[8], x[13]);
      quarter(x[3], x[4], x[9], x[14]);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      staged[threadIdx.x * kStagedRow + j] = x[j] + s[j];
    }
  }
  __syncthreads();
  // The block's keystream words [w0, w1), clipped to the launch's
  // [word0, word1): the first block of a range that starts mid-block
  // skips the words before word0, the last stops at word1.
  const int64_t left = p.nblk - (t - threadIdx.x);
  const int64_t nblk = left < kThreads ? left : kThreads;
  const int64_t base = first_blk * 16;
  const int64_t w0 = base > p.word0 ? base : p.word0;
  const int64_t w1 = base + nblk * 16 < p.word1 ? base + nblk * 16 : p.word1;
  if (w0 >= w1) return;
  // Their limbs are the output's [o0, o1): word g of the range is row
  // (g - word0) / nw, limbs 2·col and 2·col + 1 of it; at odd lt the
  // second half of a row's last word has no limb.
  const int64_t r0 = (w0 - p.word0) / p.nw;
  const int64_t r1 = (w1 - p.word0) / p.nw;
  const int64_t o0 = r0 * p.lt + 2 * (w0 - p.word0 - r0 * p.nw);
  const int64_t o1 = r1 * p.lt + 2 * (w1 - p.word0 - r1 * p.nw);
  // This thread's first limb o0 + threadIdx.x as (row, limb of the row),
  // then steps of kThreads limbs: q rows and r limbs.
  int64_t o = o0 + threadIdx.x;
  int64_t row = o / p.lt;
  int c = (int)(o - row * p.lt);
  const int q = kThreads / p.lt;
  const int r = kThreads - q * p.lt;
  for (; o < o1; o += kThreads) {
    const int64_t g = p.word0 + row * p.nw + (c >> 1) - base;  // 0..4095
    const uint32_t w = staged[(g >> 4) * kStagedRow + (g & 15)];
    const uint32_t mask = c == p.lt - 1 ? p.top_mask : 0xffffu;
    out[o] = (int32_t)(((c & 1) ? w >> 16 : w & 0xffffu) & mask);
    c += r;
    row += q;
    if (c >= p.lt) {
      c -= p.lt;
      ++row;
    }
  }
}

}  // namespace

extern "C" {

// Rows [row0, row1) of an n-row draw as (row1 - row0, lt) int32 16-bit
// limbs at `out`: ChaCha20 under `key` (8 little-endian words, host
// memory), nonce (nonce0, draw), blocks from counter0 on.  Launches on
// `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError(), or kBadShape for a layout it cannot take.
int vmn_chacha20_limbs(const uint32_t* key, uint32_t nonce0, uint64_t draw,
                       uint32_t counter0, int64_t row0, int64_t row1, int nw,
                       int lt, int top_bits, int32_t* out, void* stream) {
  if (row0 < 0 || row1 < row0 || nw < 1 || lt < 1 || lt > 2 * nw ||
      lt < 2 * nw - 1 || top_bits < 1 || top_bits > 16) {
    return kBadShape;
  }
  if (row1 == row0) return 0;
  ChachaArgs p;
  for (int j = 0; j < 8; ++j) p.key[j] = key[j];
  p.nonce0 = nonce0;
  p.nonce1 = (uint32_t)draw;
  p.nonce2 = (uint32_t)(draw >> 32);
  p.counter0 = counter0;
  p.word0 = row0 * nw;
  p.word1 = row1 * nw;
  p.blk0 = p.word0 / 16;
  p.nblk = (p.word1 + 15) / 16 - p.blk0;
  p.nw = nw;
  p.lt = lt;
  p.top_mask = (1u << top_bits) - 1u;
  const int64_t blocks = (p.nblk + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return kBadShape;
  chacha_limbs_kernel<kRounds><<<(unsigned)blocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(p, out);
  return (int)cudaGetLastError();
}

}  // extern "C"

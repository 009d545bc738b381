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
// 20 rounds of quarter rounds whose rotations are `__funnelshift_l`, then
// the block's words stored into the limbs of the rows they fall in.  A
// block's words may cross a row boundary (nw is not a multiple of 16), so
// each word carries its (row, word) position, stepped, not divided.
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
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= p.nblk) return;
  const int64_t blk = p.blk0 + t;
  uint32_t s[16] = {0x61707865u, 0x3320646eu, 0x79622d32u, 0x6b206574u,
                    p.key[0], p.key[1], p.key[2], p.key[3],
                    p.key[4], p.key[5], p.key[6], p.key[7],
                    p.counter0 + (uint32_t)blk, p.nonce0, p.nonce1, p.nonce2};
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
  // The block's first word as (row, word of the row) from row0 on; the
  // words before word0 (the first block of a range that starts mid-block)
  // are skipped, and the loop stops at word1.
  const int64_t first = blk * 16;
  int64_t rel = first - p.word0;
  int64_t row = rel >= 0 ? rel / p.nw : -1;
  int col = rel >= 0 ? (int)(rel - row * p.nw) : 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int64_t g = first + j;
    if (g >= p.word0 && g < p.word1) {
      if (row < 0) {  // the range's first word, inside this block
        row = 0;
        col = 0;
      }
      const uint32_t w = x[j] + s[j];
      int32_t* dst = out + row * p.lt + 2 * col;
      const int limb = 2 * col;
      dst[0] = (int32_t)((w & 0xffffu) & (limb == p.lt - 1 ? p.top_mask
                                                           : 0xffffu));
      if (limb + 1 < p.lt) {
        dst[1] = (int32_t)((w >> 16) & (limb + 1 == p.lt - 1 ? p.top_mask
                                                             : 0xffffu));
      }
      if (++col == p.nw) {
        col = 0;
        ++row;
      }
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

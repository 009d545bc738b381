// Native byte-tree array codec.
//
// Host-side hot path of the framework: serializing/parsing byte trees
// of N-element group arrays (N up to 10^6+) for bulletin-board messages
// and nizkp transcript files.  The reference's equivalent throughput
// path is VCR's ByteTree* + LargeIntegerArray native backing
// (reference: SURVEY.md §2.4 eio).
//
// Layout handled here: node(leaf(e_0), ..., leaf(e_{n-1})) with all
// leaves of equal byte length eb:
//
//   00 | be32(n) | ( 01 | be32(eb) | eb bytes ) * n
//
// Exposed as plain C functions consumed via ctypes (no Python.h
// dependency); built with `g++ -O3 -shared` by vmn_tpu_torch.native.build.

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

inline void put_be32(uint8_t *p, uint32_t v) {
    p[0] = (uint8_t)(v >> 24);
    p[1] = (uint8_t)(v >> 16);
    p[2] = (uint8_t)(v >> 8);
    p[3] = (uint8_t)(v);
}

inline uint32_t get_be32(const uint8_t *p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

} // namespace

extern "C" {

// Required output capacity for n elements of eb bytes each.
size_t bt_encoded_size(size_t n, size_t eb) {
    return 5 + n * (5 + eb);
}

// elems: n*eb contiguous big-endian element bytes -> out (node bytes).
// Returns number of bytes written.
size_t bt_encode_array(const uint8_t *elems, size_t n, size_t eb,
                       uint8_t *out) {
    uint8_t *p = out;
    *p++ = 0x00;
    put_be32(p, (uint32_t)n);
    p += 4;
    for (size_t i = 0; i < n; i++) {
        *p++ = 0x01;
        put_be32(p, (uint32_t)eb);
        p += 4;
        std::memcpy(p, elems + i * eb, eb);
        p += eb;
    }
    return (size_t)(p - out);
}

// Parse node-of-uniform-leaves. Returns 0 on success, negative error:
//   -1 malformed/truncated, -2 not a uniform leaf array.
// On success *n_out = element count and out holds n*eb element bytes.
// `eb` must match every leaf length.
int bt_decode_array(const uint8_t *buf, size_t len, size_t eb,
                    uint8_t *out, size_t *n_out) {
    if (len < 5 || buf[0] != 0x00)
        return -2;
    size_t n = get_be32(buf + 1);
    if (len != bt_encoded_size(n, eb))
        return -1;
    const uint8_t *p = buf + 5;
    for (size_t i = 0; i < n; i++) {
        if (p[0] != 0x01 || get_be32(p + 1) != (uint32_t)eb)
            return -2;
        p += 5;
        std::memcpy(out + i * eb, p, eb);
        p += eb;
    }
    *n_out = n;
    return 0;
}

// Probe: if buf is a uniform leaf array, set *n_out/*eb_out, return 0;
// else return -2.
int bt_probe_array(const uint8_t *buf, size_t len, size_t *n_out,
                   size_t *eb_out) {
    if (len < 5 || buf[0] != 0x00)
        return -2;
    size_t n = get_be32(buf + 1);
    if (n == 0 || len < 10)
        return -2;
    if (buf[5] != 0x01)
        return -2;
    size_t eb = get_be32(buf + 6);
    if (len != bt_encoded_size(n, eb))
        return -2;
    *n_out = n;
    *eb_out = eb;
    return 0;
}

// End offset of the byte-tree subtree starting at `start`, walked
// iteratively with a per-depth remaining-children stack (depth cap 64,
// matching the Python parser's _MAX_DEPTH).  Returns the end offset,
// -1 on malformed/truncated input, -2 on excessive depth.
long long bt_subtree_end(const uint8_t *buf, size_t len, size_t start) {
    if (start >= len)
        return -1;
    size_t off = start;
    unsigned long long stack[66];
    int depth = 0;
    stack[0] = 1;
    while (depth >= 0) {
        if (stack[depth] == 0) {
            depth--;
            continue;
        }
        stack[depth]--;
        if (off + 5 > len)
            return -1;
        uint8_t tag = buf[off];
        size_t cnt = get_be32(buf + off + 1);
        off += 5;
        if (tag == 0x01) {  // leaf
            if (off + cnt > len)
                return -1;
            off += cnt;
        } else if (tag == 0x00) {  // node
            if (depth + 1 >= 65)
                return -2;
            stack[++depth] = cnt;
        } else {
            return -1;
        }
    }
    return (long long)off;
}

// Start offsets of every child of the node spanning [0, len): writes
// n_children+1 entries into `out` (the last is the node's end offset).
// Returns the child count, -1 malformed, -2 too deep, -3 not a node or
// out_cap too small.
long long bt_child_offsets(const uint8_t *buf, size_t len,
                           unsigned long long *out, size_t out_cap) {
    if (len < 5 || buf[0] != 0x00)
        return -3;
    size_t cnt = get_be32(buf + 1);
    if (cnt + 1 > out_cap)
        return -3;
    size_t off = 5;
    for (size_t i = 0; i < cnt; i++) {
        out[i] = off;
        long long end = bt_subtree_end(buf, len, off);
        if (end < 0)
            return end;
        off = (size_t)end;
    }
    out[cnt] = off;
    return (long long)cnt;
}

} // extern "C"

// ---------------------------------------------------------------------
// SHA-256 counter-mode PRG expansion (PRGHeuristic hot path).
//
// The PRG stream H(seed||be32(0)) || H(seed||be32(1)) || ... expands
// Fiat-Shamir seeds into batching vectors and samples prover
// randomness; the Python per-block loop costs ~1-2us/block and large-N
// draws need 10^5-10^6 blocks.  (Reference equivalent: VCR
// PRGHeuristic backed by native hashing.)

namespace sha256impl {

inline uint32_t rotr(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
}

static const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b,
    0x59f111f1, 0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01,
    0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7,
    0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152,
    0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
    0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819,
    0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116, 0x1e376c08,
    0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f,
    0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
};

struct Ctx {
    uint32_t h[8];
};

inline void init(Ctx &c) {
    c.h[0] = 0x6a09e667; c.h[1] = 0xbb67ae85; c.h[2] = 0x3c6ef372;
    c.h[3] = 0xa54ff53a; c.h[4] = 0x510e527f; c.h[5] = 0x9b05688c;
    c.h[6] = 0x1f83d9ab; c.h[7] = 0x5be0cd19;
}

inline void block(Ctx &c, const uint8_t *p) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++) {
        w[i] = ((uint32_t)p[4 * i] << 24) | ((uint32_t)p[4 * i + 1] << 16)
             | ((uint32_t)p[4 * i + 2] << 8) | (uint32_t)p[4 * i + 3];
    }
    for (int i = 16; i < 64; i++) {
        uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18)
                    ^ (w[i - 15] >> 3);
        uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19)
                    ^ (w[i - 2] >> 10);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = c.h[0], b = c.h[1], cc = c.h[2], d = c.h[3];
    uint32_t e = c.h[4], f = c.h[5], g = c.h[6], hh = c.h[7];
    for (int i = 0; i < 64; i++) {
        uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
        uint32_t ch = (e & f) ^ (~e & g);
        uint32_t t1 = hh + S1 + ch + K[i] + w[i];
        uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
        uint32_t maj = (a & b) ^ (a & cc) ^ (b & cc);
        uint32_t t2 = S0 + maj;
        hh = g; g = f; f = e; e = d + t1;
        d = cc; cc = b; b = a; a = t1 + t2;
    }
    c.h[0] += a; c.h[1] += b; c.h[2] += cc; c.h[3] += d;
    c.h[4] += e; c.h[5] += f; c.h[6] += g; c.h[7] += hh;
}

// One-shot SHA-256 of a message that fits the caller's buffer; msg may
// be modified beyond len (padding written in place; caller provides
// capacity for padding: len + 72 bytes).
inline void digest(uint8_t *msg, size_t len, uint8_t *out) {
    size_t total = len + 1 + 8;
    size_t padded = (total + 63) / 64 * 64;
    msg[len] = 0x80;
    for (size_t i = len + 1; i < padded - 8; i++) msg[i] = 0;
    uint64_t bits = (uint64_t)len * 8;
    for (int i = 0; i < 8; i++)
        msg[padded - 1 - i] = (uint8_t)(bits >> (8 * i));
    Ctx c;
    init(c);
    for (size_t off = 0; off < padded; off += 64) block(c, msg + off);
    for (int i = 0; i < 8; i++) put_be32(out + 4 * i, c.h[i]);
}

}  // namespace sha256impl

extern "C" {

// out must hold 32*nblocks bytes; stream = H(seed||be32(ctr0)) || ...
void prg_expand_sha256(const uint8_t *seed, size_t seedlen,
                       int32_t counter0, size_t nblocks, uint8_t *out) {
    // message buffer: seed || counter, plus padding capacity
    uint8_t msg[512];
    if (seedlen > 256) return;  // PRG seeds are one digest long
    std::memcpy(msg, seed, seedlen);
    for (size_t i = 0; i < nblocks; i++) {
        int32_t ctr = counter0 + (int32_t)i;
        put_be32(msg + seedlen, (uint32_t)ctr);
        sha256impl::digest(msg, seedlen + 4, out + 32 * i);
    }
}

}  // extern "C"

// ------------------------------------------------------------------
// Batch Jacobi symbol — deterministic subgroup membership for
// safe-prime groups (x in QR(p) <=> (x|p) == 1).  The reference's
// equivalent is GMP's mpz_jacobi under VCR's ModPGroup element
// verification (reference: SURVEY.md §2.3 GMP layer); checking
// membership on the HOST during byte-tree parsing replaces a full
// batched device exponentiation x^q per parsed transcript array —
// the standalone verifier's dominant cost.
//
// Algorithm: binary (subtract/shift) Jacobi on 64-bit words,
// O(bits) iterations of O(words) work, multithreaded over elements.

#include <vector>
#include <thread>
#include <algorithm>

namespace {

typedef uint64_t u64;

inline int bignum_is_zero(const u64 *a, int W) {
    for (int i = 0; i < W; ++i)
        if (a[i]) return 0;
    return 1;
}

inline int bignum_cmp(const u64 *a, const u64 *b, int W) {
    for (int i = W - 1; i >= 0; --i)
        if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
    return 0;
}

inline void bignum_sub(u64 *a, const u64 *b, int W) {  // a -= b, a >= b
    u64 borrow = 0;
    for (int i = 0; i < W; ++i) {
        u64 bi = b[i] + borrow;
        u64 nb = (bi < borrow) || (a[i] < bi);
        a[i] -= bi;
        borrow = nb;
    }
}

inline void bignum_shr_small(u64 *a, int W, unsigned k) {  // k in [1,63]
    for (int i = 0; i < W - 1; ++i)
        a[i] = (a[i] >> k) | (a[i + 1] << (64 - k));
    a[W - 1] >>= k;
}

inline int bignum_ctz(const u64 *a, int W) {
    for (int i = 0; i < W; ++i)
        if (a[i]) return i * 64 + __builtin_ctzll(a[i]);
    return W * 64;
}

// Jacobi symbol (a|n) for odd n; destroys a and n.  Returns 0 when
// gcd(a, n) > 1.  The active width shrinks as the values shrink
// (they lose ~1 bit per subtract/shift round), roughly halving the
// average per-iteration work versus fixed-width loops.
int jacobi_one(u64 *a, u64 *n, int W) {
    int t = 1;
    int w = W;
    for (;;) {
        while (w > 1 && a[w - 1] == 0 && n[w - 1] == 0) --w;
        if (bignum_is_zero(a, w)) {
            u64 acc = n[0] ^ 1;
            for (int i = 1; i < w; ++i) acc |= n[i];
            return acc == 0 ? t : 0;
        }
        int k = bignum_ctz(a, w);
        if (k) {
            int big = k / 64;
            if (big) {
                for (int i = 0; i + big < w; ++i) a[i] = a[i + big];
                for (int i = w - big; i < w; ++i) a[i] = 0;
            }
            unsigned rem = (unsigned)(k % 64);
            if (rem) bignum_shr_small(a, w, rem);
            if (k & 1) {
                unsigned r = (unsigned)(n[0] & 7);
                if (r == 3 || r == 5) t = -t;
            }
        }
        // a odd
        if (bignum_cmp(a, n, w) < 0) {
            if ((a[0] & 3) == 3 && (n[0] & 3) == 3) t = -t;
            for (int i = 0; i < w; ++i) {
                u64 tmp = a[i];
                a[i] = n[i];
                n[i] = tmp;
            }
        }
        bignum_sub(a, n, w);
    }
}

inline void be_to_words(const uint8_t *src, size_t nb, u64 *dst, int W) {
    for (int i = 0; i < W; ++i) dst[i] = 0;
    for (size_t i = 0; i < nb; ++i)
        dst[i / 8] |= (u64)src[nb - 1 - i] << (8 * (i % 8));
}

}  // namespace

extern "C" int jacobi_batch(const uint8_t *data, size_t n, size_t eb,
                            const uint8_t *mod, size_t mb,
                            int nthreads, uint8_t *out) {
    if (mb == 0 || (mod[mb - 1] & 1) == 0) return -1;  // modulus must be odd
    const int W = (int)((mb + 7) / 8);
    if ((eb + 7) / 8 > (size_t)W) return -2;  // elements wider than modulus
    std::vector<u64> nref(W);
    be_to_words(mod, mb, nref.data(), W);

    auto work = [&](size_t lo, size_t hi) {
        std::vector<u64> a(W), nn(W);
        for (size_t j = lo; j < hi; ++j) {
            be_to_words(data + j * eb, eb, a.data(), W);
            std::copy(nref.begin(), nref.end(), nn.begin());
            out[j] = (uint8_t)(jacobi_one(a.data(), nn.data(), W) == 1);
        }
    };
    if (nthreads < 1) nthreads = 1;
    if ((size_t)nthreads > n) nthreads = (int)(n ? n : 1);
    if (nthreads == 1) {
        work(0, n);
        return 0;
    }
    std::vector<std::thread> ts;
    size_t chunk = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
        size_t lo = (size_t)t * chunk;
        size_t hi = lo + chunk < n ? lo + chunk : n;
        if (lo >= hi) break;
        ts.emplace_back(work, lo, hi);
    }
    for (auto &th : ts) th.join();
    return 0;
}

// ------------------------------------------------------------------
// Bulk limb<->byte conversion (the fixed-size transcript codec's hot
// loop).  A (n, L) matrix of 16-bit limbs (LSB-first) converts to/from
// (n, nbytes) big-endian unsigned encodings in ONE cache-friendly pass;
// the numpy equivalent needs several strided passes over hundreds of MB
// at transcript scale (measured 2.3s/3.6s per 2^20-element array vs
// ~0.2s here).  Reference equivalent: LargeInteger.toByteArray /
// byte-array ingestion under GMP (SURVEY.md §2.3).
//
// Returns 0 on success, -1 when a value does not fit the requested
// width (callers raise, matching the numpy paths' ValueError).

namespace limbcodec {

inline int limbs_to_be_rows(const uint16_t *limbs, size_t lo, size_t hi,
                            size_t L, size_t nbytes, uint8_t *out) {
    const size_t full = nbytes / 2;  // limb pairs fully inside the width
    for (size_t r = lo; r < hi; ++r) {
        const uint16_t *src = limbs + r * L;
        uint8_t *dst = out + r * nbytes;
        std::memset(dst, 0, nbytes);
        size_t k = 0;
        for (; k < L && k < full; ++k) {
            uint16_t v = src[k];
            dst[nbytes - 1 - 2 * k] = (uint8_t)(v & 0xff);
            dst[nbytes - 2 - 2 * k] = (uint8_t)(v >> 8);
        }
        if (k < L) {
            // top limb straddles (odd nbytes) or overflows the width
            if (2 * k < nbytes) {
                uint16_t v = src[k];
                if (v > 0xff) return -1;
                dst[nbytes - 1 - 2 * k] = (uint8_t)(v & 0xff);
                ++k;
            }
            for (; k < L; ++k)
                if (src[k]) return -1;
        }
    }
    return 0;
}

inline int be_to_limbs_rows(const uint8_t *data, size_t lo, size_t hi,
                            size_t nbytes, size_t L, uint16_t *out) {
    const size_t full = nbytes / 2;
    for (size_t r = lo; r < hi; ++r) {
        const uint8_t *src = data + r * nbytes;
        uint16_t *dst = out + r * L;
        size_t k = 0;
        for (; k < L && k < full; ++k)
            dst[k] = (uint16_t)src[nbytes - 1 - 2 * k] |
                     (uint16_t)(src[nbytes - 2 - 2 * k] << 8);
        if (k < L) {
            if (2 * k < nbytes) {
                dst[k] = src[nbytes - 1 - 2 * k];
                ++k;
            }
            for (; k < L; ++k) dst[k] = 0;
        } else {
            // input wider than 2L bytes: leading bytes must be zero
            for (size_t b = 0; b + 2 * L < nbytes; ++b)
                if (src[b]) return -1;
        }
    }
    return 0;
}

template <typename F>
int run_rows(size_t n, int nthreads, F f) {
    if (nthreads < 1) nthreads = 1;
    if ((size_t)nthreads > n) nthreads = (int)(n ? n : 1);
    if (nthreads == 1) return f((size_t)0, n);
    std::vector<std::thread> ts;
    std::vector<int> rcs(nthreads, 0);
    size_t chunk = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
        size_t lo = (size_t)t * chunk;
        size_t hi = lo + chunk < n ? lo + chunk : n;
        if (lo >= hi) break;
        ts.emplace_back([&rcs, t, lo, hi, &f] { rcs[t] = f(lo, hi); });
    }
    for (auto &th : ts) th.join();
    for (int rc : rcs)
        if (rc) return rc;
    return 0;
}

}  // namespace limbcodec

extern "C" {

int limbs_to_be(const uint16_t *limbs, size_t n, size_t L, size_t nbytes,
                uint8_t *out, int nthreads) {
    return limbcodec::run_rows(n, nthreads, [&](size_t lo, size_t hi) {
        return limbcodec::limbs_to_be_rows(limbs, lo, hi, L, nbytes, out);
    });
}

int be_to_limbs(const uint8_t *data, size_t n, size_t nbytes, size_t L,
                uint16_t *out, int nthreads) {
    return limbcodec::run_rows(n, nthreads, [&](size_t lo, size_t hi) {
        return limbcodec::be_to_limbs_rows(data, lo, hi, nbytes, L, out);
    });
}

}  // extern "C"

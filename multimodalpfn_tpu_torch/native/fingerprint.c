/* Native batch row-fingerprint for AddFingerprintFeaturesStep.
 *
 * The Python step (preprocess/steps.py::_stable_float_hash) hashes each row's
 * raw bytes with BLAKE2b-64 (digest_size=8) and maps the little-endian digest
 * to [0, 1) via (h % 10^12) / 10^12.  Doing that per row from Python costs a
 * hashlib object + a tobytes copy + interpreter dispatch per row — ~16% of a
 * member pipeline fit on the bench workload (profiled round 5).  This module
 * hashes every row of a contiguous byte matrix in ONE call.
 *
 * BLAKE2b implemented from the RFC 7693 specification (public algorithm; no
 * external deps).  Output is bit-exact with hashlib.blake2b(digest_size=8):
 * parameter block XOR = 0x01010000 ^ digest_length, no key, sequential mode.
 *
 * Reference parity anchor: the torch reference's fingerprint
 * (mmpfn/models/mmpfn/model/preprocessing.py:476-523) uses Python's salted
 * builtin hash() — not reproducible across processes; ours (blake2b) is the
 * documented deliberate divergence (see steps.py module docstring).  This
 * module only accelerates OUR hash; semantics are pinned by
 * tests/test_native_fingerprint.py (exact equality vs the hashlib path).
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

static const uint64_t IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL,
    0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
    0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
};

static const uint8_t SIGMA[10][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
};

static inline uint64_t rotr64(uint64_t x, unsigned n) {
    return (x >> n) | (x << (64 - n));
}

#define G(v, a, b, c, d, x, y)                         \
    do {                                               \
        v[a] = v[a] + v[b] + (x);                      \
        v[d] = rotr64(v[d] ^ v[a], 32);                \
        v[c] = v[c] + v[d];                            \
        v[b] = rotr64(v[b] ^ v[c], 24);                \
        v[a] = v[a] + v[b] + (y);                      \
        v[d] = rotr64(v[d] ^ v[a], 16);                \
        v[c] = v[c] + v[d];                            \
        v[b] = rotr64(v[b] ^ v[c], 63);                \
    } while (0)

/* Compression function F (RFC 7693 §3.2). t = total bytes hashed so far
 * including this block; rows here are far below 2^64 so t_hi == 0. */
static void blake2b_compress(uint64_t h[8], const uint8_t block[128],
                             uint64_t t, int last) {
    uint64_t m[16];
    uint64_t v[16];
    int i, r;
    for (i = 0; i < 16; i++) {
        uint64_t w;
        memcpy(&w, block + 8 * i, 8); /* little-endian host assumed (x86/ARM) */
        m[i] = w;
    }
    for (i = 0; i < 8; i++) v[i] = h[i];
    for (i = 0; i < 8; i++) v[8 + i] = IV[i];
    v[12] ^= t;
    /* v[13] ^= t_hi (0) */
    if (last) v[14] = ~v[14];
    for (r = 0; r < 12; r++) {
        const uint8_t *s = SIGMA[r % 10];
        G(v, 0, 4, 8, 12, m[s[0]], m[s[1]]);
        G(v, 1, 5, 9, 13, m[s[2]], m[s[3]]);
        G(v, 2, 6, 10, 14, m[s[4]], m[s[5]]);
        G(v, 3, 7, 11, 15, m[s[6]], m[s[7]]);
        G(v, 0, 5, 10, 15, m[s[8]], m[s[9]]);
        G(v, 1, 6, 11, 12, m[s[10]], m[s[11]]);
        G(v, 2, 7, 8, 13, m[s[12]], m[s[13]]);
        G(v, 3, 4, 9, 14, m[s[14]], m[s[15]]);
    }
    for (i = 0; i < 8; i++) h[i] ^= v[i] ^ v[8 + i];
}

/* BLAKE2b with digest_size=8, no key: returns the first state word (the
 * 8-byte digest read little-endian IS h[0] on a little-endian host). */
static uint64_t blake2b64(const uint8_t *data, size_t len) {
    uint64_t h[8];
    uint8_t block[128];
    size_t off = 0;
    memcpy(h, IV, sizeof(h));
    h[0] ^= 0x01010000ULL ^ 8ULL; /* param block: digest_length=8, fanout=1, depth=1 */
    /* All full blocks except the last block (the final block is always
     * processed with the finalization flag, even when exactly full). */
    while (len - off > 128) {
        blake2b_compress(h, data + off, (uint64_t)(off + 128), 0);
        off += 128;
    }
    memset(block, 0, sizeof(block));
    memcpy(block, data + off, len - off);
    blake2b_compress(h, block, (uint64_t)len, 1);
    return h[0];
}

#define HASH_CONSTANT 1000000000000ULL /* 10^12, matches steps.py */

/* Hash n_rows rows of row_bytes raw bytes each (contiguous, C-order) into
 * doubles in [0, 1).  `out` must hold n_rows doubles. */
void fp_hash_rows(const uint8_t *data, size_t n_rows, size_t row_bytes,
                  double *out) {
    size_t i;
    for (i = 0; i < n_rows; i++) {
        uint64_t h = blake2b64(data + i * row_bytes, row_bytes);
        out[i] = (double)(h % HASH_CONSTANT) / (double)HASH_CONSTANT;
    }
}

/* Self-test hook: digest of an arbitrary buffer, for parity checks from
 * ctypes without numpy plumbing. */
uint64_t fp_blake2b64(const uint8_t *data, size_t len) {
    return blake2b64(data, len);
}

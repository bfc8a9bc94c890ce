// Batched BLAKE3 of messages up to two chunks (2,048 bytes), and the
// lattice hash (lthash: BLAKE3's XOF to 2,048 bytes, read as 1,024 16-bit
// lanes) of the same messages.
//
// Replaces the JAX package's jitted device ops
// firedancer_tpu/ops/blake3.py:139 `blake3_batch` and :150 `lthash_batch`:
// masked compressions of every block position of both chunks for every
// lane (`_root_state`, :82-136), then one root compression, or a
// `lax.scan` of 32 root compressions over the output counter. Eagerly in
// PyTorch a compression is some 800 launches; here a thread runs it in
// registers.
//
// The root state of a message of n bytes (BLAKE3's chunk chaining values
// and left-leaning tree, cut to at most two chunks):
//  * n <= 1024, one chunk: its blocks chain from the IV with counter 0,
//    CHUNK_START on the first and CHUNK_END on the last; the root
//    compression runs that last block again, with its own length and
//    flags plus ROOT and the chaining value it started from (a message of
//    0 bytes is one block of length 0 with CHUNK_START | CHUNK_END);
//  * 1024 < n <= 2048, two chunks: chunk 0 (counter 0) and chunk 1
//    (counter 1) each give a chaining value, and the root is the parent
//    merge: block cv0 || cv1, length 64, PARENT | ROOT, from the IV.
// Message words are little-endian; bytes past n are 0.
//
// Entry `blake3` (fdtt_blake3): one thread a message; the digest is the
// first 8 output words of the root compression at counter 0, as 32
// little-endian bytes.
// Entry `lthash` (fdtt_lthash): one warp a message. Every lane computes the
// root state (the same instructions and addresses on all 32 lanes: the
// loads are broadcasts, and lanes that would otherwise wait cost nothing
// more), then lane c runs the root compression at output counter c and
// writes its 16 words w as 32 lanes (w & 0xFFFF, w >> 16), counter-major:
// out[msg, 32 c + 2 k + h]. The lanes are int32 in [0, 2^16).
//
// What bounds it on the H100: the integer operations (a compression is 7
// rounds of 8 G functions of 12 32-bit operations, and 8 or 16 output
// xors), far above the bytes it reads; the root state of one message is a
// chain of up to 33 dependent compressions.
//
// Plain PyTorch versions: firedancer_tpu_torch/ops/blake3.py
// `blake3_plain` and `lthash_plain`.
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FD_DEV __device__ __forceinline__
#define FD_LDG(p) __ldg(p)
#else
#define FD_DEV static inline
#define FD_LDG(p) (*(p))
#endif

#define B3_CHUNK_START 1u
#define B3_CHUNK_END 2u
#define B3_PARENT 4u
#define B3_ROOT 8u
#define B3_CHUNK_LEN 1024
#define B3_BLOCK_LEN 64
#define B3_MAX_LEN (2 * B3_CHUNK_LEN)

FD_DEV uint32_t b3_rotr(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

FD_DEV void b3_iv(uint32_t cv[8]) {
  cv[0] = 0x6a09e667u; cv[1] = 0xbb67ae85u; cv[2] = 0x3c6ef372u;
  cv[3] = 0xa54ff53au; cv[4] = 0x510e527fu; cv[5] = 0x9b05688cu;
  cv[6] = 0x1f83d9abu; cv[7] = 0x5be0cd19u;
}

#define B3_G(a, b, c, d, mx, my)        \
  v[a] = v[a] + v[b] + (mx);            \
  v[d] = b3_rotr(v[d] ^ v[a], 16);      \
  v[c] = v[c] + v[d];                   \
  v[b] = b3_rotr(v[b] ^ v[c], 12);      \
  v[a] = v[a] + v[b] + (my);            \
  v[d] = b3_rotr(v[d] ^ v[a], 8);       \
  v[c] = v[c] + v[d];                   \
  v[b] = b3_rotr(v[b] ^ v[c], 7);

// the fixed message permutation between rounds
// (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)
FD_DEV void b3_permute(uint32_t m[16]) {
  const uint32_t t[16] = {m[2], m[6], m[3],  m[10], m[7],  m[0],
                          m[4], m[13], m[1], m[11], m[12], m[5],
                          m[9], m[14], m[15], m[8]};
#pragma unroll
  for (int i = 0; i < 16; i++) m[i] = t[i];
}

// compression of block m (consumed) from chaining value cv -> the 16
// output words (out[0..8) the next chaining value or digest words; the
// upper 8 computed only when `full`)
FD_DEV void b3_compress(const uint32_t cv[8], uint32_t m[16], uint32_t ctr,
                        uint32_t blen, uint32_t flags, uint32_t out[16],
                        bool full) {
  uint32_t v[16] = {cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
                    0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                    ctr, 0u, blen, flags};
#pragma unroll
  for (int r = 0; r < 7; r++) {
    B3_G(0, 4, 8, 12, m[0], m[1])
    B3_G(1, 5, 9, 13, m[2], m[3])
    B3_G(2, 6, 10, 14, m[4], m[5])
    B3_G(3, 7, 11, 15, m[6], m[7])
    B3_G(0, 5, 10, 15, m[8], m[9])
    B3_G(1, 6, 11, 12, m[10], m[11])
    B3_G(2, 7, 8, 13, m[12], m[13])
    B3_G(3, 4, 9, 14, m[14], m[15])
    if (r < 6) b3_permute(m);
  }
#pragma unroll
  for (int i = 0; i < 8; i++) out[i] = v[i] ^ v[i + 8];
  if (full) {
#pragma unroll
    for (int i = 0; i < 8; i++) out[i + 8] = v[i + 8] ^ cv[i];
  }
}

// the 16 little-endian words of the 64-byte block at message offset off;
// bytes from n on are 0. ALIGNED reads 32-bit words (rows 4-byte aligned,
// the width a multiple of 4), else bytes.
template <bool ALIGNED>
FD_DEV void b3_block_words(uint32_t w[16], const uint8_t *m, int off,
                           int n) {
#pragma unroll
  for (int t = 0; t < 16; t++) {
    const int p = off + 4 * t, k = n - p;
    uint32_t x = 0;
    if (k > 0) {
      if (ALIGNED) {
        x = FD_LDG((const uint32_t *)(m + p));
        if (k < 4) x &= (1u << (8 * k)) - 1u;
      } else {
#pragma unroll
        for (int b = 0; b < 4; b++)
          x |= (b < k ? (uint32_t)FD_LDG(m + p + b) : 0u) << (8 * b);
      }
    }
    w[t] = x;
  }
}

// chaining value of a full or last chunk: its blocks from `first`
// (byte offset of the chunk) over its clen >= 1 bytes, counter `ctr`
template <bool ALIGNED>
FD_DEV void b3_chunk_cv(uint32_t cv[8], const uint8_t *m, int first,
                        int clen, int n, uint32_t ctr) {
  const int nb = (clen + B3_BLOCK_LEN - 1) / B3_BLOCK_LEN;
  b3_iv(cv);
#pragma unroll 1
  for (int bi = 0; bi < nb; bi++) {
    uint32_t w[16], out[16];
    b3_block_words<ALIGNED>(w, m, first + bi * B3_BLOCK_LEN, n);
    const int rem = clen - bi * B3_BLOCK_LEN;
    const uint32_t blen = rem < B3_BLOCK_LEN ? rem : B3_BLOCK_LEN;
    const uint32_t flags = (bi == 0 ? B3_CHUNK_START : 0u) |
                           (bi == nb - 1 ? B3_CHUNK_END : 0u);
    b3_compress(cv, w, ctr, blen, flags, out, false);
#pragma unroll
    for (int i = 0; i < 8; i++) cv[i] = out[i];
  }
}

// the root compression's inputs (without ROOT) of a message of n <= 2048
// bytes: chaining value, block, block length and flags
template <bool ALIGNED>
FD_DEV void b3_root_state(uint32_t cv[8], uint32_t m[16], uint32_t &blen,
                          uint32_t &flags, const uint8_t *msg, int n) {
  if (n <= B3_CHUNK_LEN) {
    const int nb = n ? (n + B3_BLOCK_LEN - 1) / B3_BLOCK_LEN : 1;
    b3_iv(cv);
#pragma unroll 1
    for (int bi = 0; bi < nb - 1; bi++) {
      uint32_t w[16], out[16];
      b3_block_words<ALIGNED>(w, msg, bi * B3_BLOCK_LEN, n);
      b3_compress(cv, w, 0u, B3_BLOCK_LEN, bi == 0 ? B3_CHUNK_START : 0u,
                  out, false);
#pragma unroll
      for (int i = 0; i < 8; i++) cv[i] = out[i];
    }
    b3_block_words<ALIGNED>(m, msg, (nb - 1) * B3_BLOCK_LEN, n);
    blen = (uint32_t)(n - (nb - 1) * B3_BLOCK_LEN);
    flags = (nb == 1 ? B3_CHUNK_START : 0u) | B3_CHUNK_END;
  } else {
    uint32_t cv0[8], cv1[8];
    b3_chunk_cv<ALIGNED>(cv0, msg, 0, B3_CHUNK_LEN, n, 0u);
    b3_chunk_cv<ALIGNED>(cv1, msg, B3_CHUNK_LEN, n - B3_CHUNK_LEN, n, 1u);
#pragma unroll
    for (int i = 0; i < 8; i++) {
      m[i] = cv0[i];
      m[8 + i] = cv1[i];
    }
    b3_iv(cv);
    blen = B3_BLOCK_LEN;
    flags = B3_PARENT;
  }
}

FD_DEV int b3_len(int32_t len, int64_t L) {
  return len < 0 ? 0 : (len > L ? (int)L : (int)len);
}

template <bool ALIGNED>
FD_DEV void blake3_lane(uint8_t *o, const uint8_t *msg, int n) {
  uint32_t cv[8], m[16], out[16], blen, flags;
  b3_root_state<ALIGNED>(cv, m, blen, flags, msg, n);
  b3_compress(cv, m, 0u, blen, flags | B3_ROOT, out, false);
#pragma unroll
  for (int i = 0; i < 8; i++)
#pragma unroll
    for (int b = 0; b < 4; b++) o[4 * i + b] = (uint8_t)(out[i] >> (8 * b));
}

// the 32 lanes of output counter c of a message's lthash
FD_DEV void lthash_counter(int32_t *o, const uint32_t cv[8],
                           const uint32_t m[16], uint32_t blen,
                           uint32_t flags, uint32_t c) {
  uint32_t mm[16], out[16];
#pragma unroll
  for (int i = 0; i < 16; i++) mm[i] = m[i];
  b3_compress(cv, mm, c, blen, flags | B3_ROOT, out, true);
#pragma unroll
  for (int k = 0; k < 16; k++) {
    o[2 * k] = (int32_t)(out[k] & 0xffffu);
    o[2 * k + 1] = (int32_t)(out[k] >> 16);
  }
}

#ifdef __CUDACC__
template <bool ALIGNED>
__global__ void __launch_bounds__(32)
blake3_kernel(const uint8_t *__restrict__ msg, int64_t L,
              const int32_t *__restrict__ lens, uint8_t *__restrict__ out,
              int n) {
  const int i = blockIdx.x * 32 + threadIdx.x;
  if (i >= n) return;
  blake3_lane<ALIGNED>(out + (int64_t)i * 32, msg + (int64_t)i * L,
                       b3_len(lens[i], L));
}

// four messages a block of 128 threads, one a warp
template <bool ALIGNED>
__global__ void __launch_bounds__(128)
lthash_kernel(const uint8_t *__restrict__ msg, int64_t L,
              const int32_t *__restrict__ lens, int32_t *__restrict__ out,
              int n) {
  const int i = blockIdx.x * 4 + threadIdx.x / 32, c = threadIdx.x & 31;
  if (i >= n) return;
  uint32_t cv[8], m[16], blen, flags;
  b3_root_state<ALIGNED>(cv, m, blen, flags, msg + (int64_t)i * L,
                         b3_len(lens[i], L));
  int32_t lanes[32];
  lthash_counter(lanes, cv, m, blen, flags, (uint32_t)c);
  int4 *o = (int4 *)(out + (int64_t)i * 1024 + 32 * c);
#pragma unroll
  for (int k = 0; k < 8; k++)
    o[k] = make_int4(lanes[4 * k], lanes[4 * k + 1], lanes[4 * k + 2],
                     lanes[4 * k + 3]);
}

static bool aligned4(const void *msg, long long L) {
  return ((uintptr_t)msg | (uintptr_t)L) % 4 == 0;
}

// msg (n, L <= 2048) uint8, lens (n,) int32 -> out (n, 32) uint8; device
// pointers; launches on `stream` and returns cudaGetLastError().
extern "C" int fdtt_blake3(const void *msg, long long L, const void *lens,
                           void *out, int n, void *stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((n + 31) / 32);
#define B3_ARGS (const uint8_t *)msg, (int64_t)L, (const int32_t *)lens, \
                (uint8_t *)out, n
  if (n > 0) {
    if (aligned4(msg, L))
      blake3_kernel<true><<<grid, 32, 0, st>>>(B3_ARGS);
    else
      blake3_kernel<false><<<grid, 32, 0, st>>>(B3_ARGS);
  }
#undef B3_ARGS
  return (int)cudaGetLastError();
}

// msg (n, L <= 2048) uint8, lens (n,) int32 -> out (n, 1024) int32 lanes
// (out 16-byte aligned); device pointers; launches on `stream` and
// returns cudaGetLastError().
extern "C" int fdtt_lthash(const void *msg, long long L, const void *lens,
                           void *out, int n, void *stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((n + 3) / 4);
#define B3_ARGS (const uint8_t *)msg, (int64_t)L, (const int32_t *)lens, \
                (int32_t *)out, n
  if (n > 0) {
    if (aligned4(msg, L))
      lthash_kernel<true><<<grid, 128, 0, st>>>(B3_ARGS);
    else
      lthash_kernel<false><<<grid, 128, 0, st>>>(B3_ARGS);
  }
#undef B3_ARGS
  return (int)cudaGetLastError();
}
#else
// Host build: message `i` of either entry; `aligned` picks the 32-bit
// load path (rows 4-byte aligned, L a multiple of 4). lthash runs the
// 32 counters of the warp one after another.
extern "C" void blake3_lane_host(const uint8_t *msg, int64_t L,
                                 const int32_t *lens, uint8_t *out,
                                 int aligned, int i) {
  const uint8_t *m = msg + (int64_t)i * L;
  const int n = b3_len(lens[i], L);
  if (aligned)
    blake3_lane<true>(out + (int64_t)i * 32, m, n);
  else
    blake3_lane<false>(out + (int64_t)i * 32, m, n);
}

extern "C" void lthash_lane_host(const uint8_t *msg, int64_t L,
                                 const int32_t *lens, int32_t *out,
                                 int aligned, int i) {
  uint32_t cv[8], m[16], blen, flags;
  const uint8_t *row = msg + (int64_t)i * L;
  const int n = b3_len(lens[i], L);
  if (aligned)
    b3_root_state<true>(cv, m, blen, flags, row, n);
  else
    b3_root_state<false>(cv, m, blen, flags, row, n);
  for (uint32_t c = 0; c < 32; c++)
    lthash_counter(out + (int64_t)i * 1024 + 32 * c, cv, m, blen, flags, c);
}
#endif

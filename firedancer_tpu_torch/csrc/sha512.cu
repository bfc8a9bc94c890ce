// Batched SHA-512 with per-lane lengths, one thread per message: the
// generic digest of (B, L) rows, and k = SHA-512(R || A || M) read in
// place from sig, pub and msg with the strict prechecks beside it.
//
// Replaces the Pallas kernel firedancer_tpu/ops/pallas_sha.py
// `_sha512_kernel` (hi/lo uint32 word pairs in (8,128) tiles, padding
// prepared outside by ops/sha2._pad_message), and the strict glue around
// it in pallas_ed.verify_batch: the R || A || M concat and the byte
// checks S < l, A.y < p, A and R not small-order. Here a word is a native
// uint64_t, the 80 rounds are unrolled over a 16-word ring in registers,
// and the Merkle-Damgard padding (0x80 byte, 128-bit big-endian bit
// length, an extra block when the length % 128 is in 112..127) is formed
// in registers: neither the padded buffer nor the R || A || M rows are
// materialised. The hashed stream of lane i is its `pre` prefix bytes
// (64 for sha512_ram: sig[i, :32] then pub[i]; 0 for the generic digest)
// and then msg[i, :len_i].
//
// Design:
//  * Blocks of one warp: 8192 lanes make 256 blocks, which cover all 132
//    SMs; the tile's 2048-lane chunk makes 64.
//  * Coalesced loads through shared memory: for each 128-byte block of
//    the stream, the warp copies its 32 lanes' bytes into a padded tile,
//    lane after lane (16-byte pieces, eight threads a lane and four lanes
//    an instruction), with cp.async, double-buffered, so block
//    b + 1 arrives while block b runs its 80 rounds. Each thread then
//    reads its own words from the tile (rows of 144 bytes, so the 32
//    lanes' reads spread over the banks). The warp loops to its longest
//    lane's block count; a lane past its own count does not update its
//    state, and pieces past a lane's length are not read.
//  * The staging needs sig, pub, msg and the row width 16-byte aligned,
//    as the verify tile's staging buffer is; otherwise each thread reads
//    its own bytes from the rows (sha512_lane, the path the host build
//    tests lane by lane).
//  * The prechecks run on the lane's thread from its sig and pub rows,
//    with the code MSM stage 1 runs (csrc/prechecks.cuh).
//
// What bounds it on the H100: the integer operations (80 rounds of about
// 28 32-bit operations and 64 schedule words of about 20 per 128-byte
// block), far above the bytes it must move; one message's 80-round chain
// is serial, so at 2048 lanes the chain, not the rate, sets the time.
//
// Plain PyTorch versions: firedancer_tpu_torch/ops/sha2.py `sha512` and
// `sha512_ram`.
#include "prechecks.cuh"

FD_CONST uint64_t kK512[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL,
    0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL,
    0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL,
    0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL,
    0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL,
    0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL,
    0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL,
    0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL,
    0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL,
    0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL,
    0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL,
    0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL,
    0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL,
    0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL,
};

FD_DEV uint64_t rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

FD_DEV uint64_t bswap64(uint64_t x) {
  x = ((x & 0x00ff00ff00ff00ffULL) << 8) | ((x >> 8) & 0x00ff00ff00ff00ffULL);
  x = ((x & 0x0000ffff0000ffffULL) << 16) | ((x >> 16) & 0x0000ffff0000ffffULL);
  return (x << 32) | (x >> 32);
}

FD_DEV void sha512_init(uint64_t st[8]) {
  const uint64_t h[8] = {
      0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
      0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
      0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
#pragma unroll
  for (int i = 0; i < 8; i++) st[i] = h[i];
}

// schedule word t >= 16 of a block, in the 16-word ring w
FD_DEV uint64_t sha512_sched(uint64_t w[16], int t) {
  const uint64_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
  const uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7);
  const uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6);
  return w[t & 15] += s0 + w[(t - 7) & 15] + s1;
}

// round t on the working variables v = (a, ..., h) with schedule word wt
FD_DEV void sha512_round(uint64_t v[8], int t, uint64_t wt) {
  const uint64_t a = v[0], e = v[4];
  const uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
  const uint64_t ch = (e & v[5]) ^ (~e & v[6]);
  const uint64_t t1 = v[7] + S1 + ch + kK512[t] + wt;
  const uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
  const uint64_t maj = (a & v[1]) ^ (a & v[2]) ^ (v[1] & v[2]);
#pragma unroll
  for (int i = 7; i > 0; i--) v[i] = v[i - 1];
  v[4] += t1;
  v[0] = t1 + S0 + maj;
}

// one 128-byte block: the 80 rounds over the message words w (consumed
// as the schedule ring) and the state update
FD_DEV void sha512_block(uint64_t st[8], uint64_t w[16]) {
  uint64_t v[8];
#pragma unroll
  for (int i = 0; i < 8; i++) v[i] = st[i];
#pragma unroll
  for (int t = 0; t < 80; t++)
    sha512_round(v, t, t < 16 ? w[t] : sha512_sched(w, t));
#pragma unroll
  for (int i = 0; i < 8; i++) st[i] += v[i];
}

// blocks a stream of n bytes pads to (0x80 and the 16-byte length fit)
FD_DEV int sha512_nblocks(int n) { return (n + 17 + 127) / 128; }

// big-endian word w of stream bytes [off, off + 8) with the padding
// applied: bytes from n on become 0, except the 0x80 at n. (The bit
// length, word 15 of the last block, is set by the caller.)
FD_DEV uint64_t pad_word(uint64_t w, int off, int n) {
  const int k = n - off;              // message bytes in the word
  if (k >= 8) return w;
  if (k < 0) return 0;
  const uint64_t keep = k ? ~0ULL << (64 - 8 * k) : 0;
  return (w & keep) | (0x80ULL << (56 - 8 * k));
}

// the padded big-endian word at stream offset off, read byte by byte
// from the rows (R = r[0..32), A = a[0..32) when pre = 64, then M = m)
FD_DEV uint64_t ram_word(const uint8_t *r, const uint8_t *a,
                         const uint8_t *m, int pre, int off, int n) {
  uint64_t w = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    const int p = off + k;
    const uint32_t v = p >= n ? 0u
                     : p >= pre ? m[p - pre] : p < 32 ? r[p] : a[p - 32];
    w = (w << 8) | v;
  }
  return pad_word(w, off, n);
}

// one lane's digest state over its n stream bytes, read from the rows
FD_DEV void sha512_lane(uint64_t st[8], const uint8_t *r, const uint8_t *a,
                        const uint8_t *m, int pre, int n) {
  const int nb = sha512_nblocks(n);
  sha512_init(st);
  for (int blk = 0; blk < nb; blk++) {
    uint64_t w[16];
#pragma unroll
    for (int t = 0; t < 16; t++)
      w[t] = ram_word(r, a, m, pre, blk * 128 + 8 * t, n);
    if (blk == nb - 1) w[15] = (uint64_t)n << 3;
    sha512_block(st, w);
  }
}

FD_DEV void sha512_store(uint8_t *o, const uint64_t st[8]) {
#pragma unroll
  for (int i = 0; i < 8; i++) ((uint64_t *)o)[i] = bswap64(st[i]);
}

// the strict prechecks of a lane from its sig and pub rows
FD_DEV int ram_prechecks(const uint8_t *sig, const uint8_t *pub) {
  uint64_t rw[4], sw[4], aw[4];
  load_words(rw, sig, 4);
  load_words(sw, sig + 32, 4);
  load_words(aw, pub, 4);
  return strict_prechecks(sw, aw, rw) ? 1 : 0;
}

#ifdef __CUDACC__
#define SHA_ROW 144    // a lane's 128-byte block in shared memory, padded

// stream bytes [128 blk, 128 blk + 128) of the warp's 32 lanes into buf
// in 16-byte pieces: thread t copies piece t % 8 of lanes t / 8 + 4 i, so
// eight neighbouring threads read one row's 128 contiguous bytes. Pieces
// past a lane's length, and lanes past the batch, are not read.
__device__ __forceinline__ void stage_block(
    uint8_t *buf, const uint8_t *sig, const uint8_t *pub, const uint8_t *msg,
    int64_t L, int pre, int base, int n, int mylen, int blk) {
  const int t = threadIdx.x & 31, piece = t % 8;
  const int p = blk * 128 + piece * 16;         // stream offset
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const int l = t / 8 + 4 * i;
    const int len = __shfl_sync(0xffffffffu, mylen, l);
    const int64_t gl = base + l;
    const uint8_t *src = nullptr;
    if (gl < n) {
      if (p < pre)
        src = p < 32 ? sig + gl * 64 + p : pub + gl * 32 + (p - 32);
      else if (p - pre < len)
        src = msg + gl * L + (p - pre);
    }
    if (src) {
      const unsigned sa = (unsigned)__cvta_generic_to_shared(
          buf + l * SHA_ROW + piece * 16);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
                   "l"(src));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// STAGED: the warp's copies through shared memory; else each thread
// reads its own rows
template <bool STAGED>
__global__ void __launch_bounds__(32)
sha512_kernel(const uint8_t *__restrict__ sig, const uint8_t *__restrict__ pub,
              const uint8_t *__restrict__ msg, int64_t L,
              const int32_t *__restrict__ lens, uint8_t *__restrict__ out,
              int32_t *__restrict__ pre_out, int n, int pre) {
  __shared__ __align__(16) uint8_t buf[2][32 * SHA_ROW];
  const int t = threadIdx.x, base = blockIdx.x * 32, lane = base + t;
  int len = 0;
  if (lane < n) {
    len = lens[lane];
    len = len < 0 ? 0 : (len > L ? (int)L : len);
  }
  const int nh = pre + len;                     // stream bytes hashed
  const int nb = lane < n ? sha512_nblocks(nh) : 0;
  const int64_t row = lane < n ? lane : n - 1;
  if (pre_out && lane < n)
    pre_out[lane] = ram_prechecks(sig + row * 64, pub + row * 32);
  uint64_t st[8];
  if constexpr (!STAGED) {
    sha512_lane(st, sig + row * 64, pub + row * 32, msg + row * L, pre, nh);
  } else {
    const int nbw = __reduce_max_sync(0xffffffffu, nb);
    sha512_init(st);
    stage_block(buf[0], sig, pub, msg, L, pre, base, n, len, 0);
#pragma unroll 1
    for (int blk = 0; blk < nbw; blk++) {
      if (blk + 1 < nbw)
        stage_block(buf[(blk + 1) & 1], sig, pub, msg, L, pre, base, n, len,
                    blk + 1);
      else
        asm volatile("cp.async.commit_group;\n" ::);   // an empty group
      asm volatile("cp.async.wait_group 1;\n" ::);     // block blk is in
      __syncwarp();
      if (blk < nb) {
        const uint8_t *r = buf[blk & 1] + t * SHA_ROW;
        uint64_t w[16];
#pragma unroll
        for (int k = 0; k < 16; k++)
          w[k] = pad_word(bswap64(*(const uint64_t *)(r + 8 * k)),
                          blk * 128 + 8 * k, nh);
        if (blk == nb - 1) w[15] = (uint64_t)nh << 3;
        sha512_block(st, w);
      }
      __syncwarp();                             // buf[blk & 1] is free
    }
  }
  if (lane < n) sha512_store(out + (int64_t)lane * 64, st);
}

static int launch(const void *sig, const void *pub, const void *msg,
                  long long L, const void *lens, void *out, void *pre_out,
                  int n, int pre, void *stream) {
  const uintptr_t al = (uintptr_t)sig | (uintptr_t)pub | (uintptr_t)msg |
                       (uintptr_t)L;
  const dim3 grid((n + 31) / 32);
  const cudaStream_t st = (cudaStream_t)stream;
#define SHA_ARGS                                                        \
  (const uint8_t *)sig, (const uint8_t *)pub, (const uint8_t *)msg,     \
      (int64_t)L, (const int32_t *)lens, (uint8_t *)out,                \
      (int32_t *)pre_out, n, pre
  if (n > 0) {
    if (al % 16 == 0)
      sha512_kernel<true><<<grid, 32, 0, st>>>(SHA_ARGS);
    else
      sha512_kernel<false><<<grid, 32, 0, st>>>(SHA_ARGS);
  }
#undef SHA_ARGS
  return (int)cudaGetLastError();
}

// k = SHA-512(sig[:, :32] || pub || msg[:, :lens]) and the prechecks:
// sig (n, 64), pub (n, 32), msg (n, L) uint8, lens (n,) int32 -> out
// (n, 64) uint8, pre_out (n,) int32; device pointers; launches on
// `stream` and returns cudaGetLastError().
extern "C" int fdtt_sha512_ram(const void *sig, const void *pub,
                               const void *msg, long long L,
                               const void *lens, void *out, void *pre_out,
                               int n, void *stream) {
  return launch(sig, pub, msg, L, lens, out, pre_out, n, 64, stream);
}

// msg (n, L) uint8, lens (n,) int32 -> out (n, 64) uint8 digests.
extern "C" int fdtt_sha512(const void *msg, long long L, const void *lens,
                           void *out, int n, void *stream) {
  return launch(nullptr, nullptr, msg, L, lens, out, nullptr, n, 0, stream);
}
#else
// Host build: lane `lane` of either entry (pre = 64: sha512_ram, with its
// prechecks into pre_out; pre = 0: the generic digest, sig and pub
// unused), its bytes read straight from the rows.
extern "C" void sha512_lane_host(const uint8_t *sig, const uint8_t *pub,
                                 const uint8_t *msg, int64_t L,
                                 const int32_t *lens, uint8_t *out,
                                 int32_t *pre_out, int pre, int lane) {
  int len = lens[lane];
  len = len < 0 ? 0 : (len > L ? (int)L : len);
  uint64_t st[8];
  sha512_lane(st, sig + (int64_t)lane * 64, pub + (int64_t)lane * 32,
              msg + (int64_t)lane * L, pre, pre + len);
  sha512_store(out + (int64_t)lane * 64, st);
  if (pre) pre_out[lane] = ram_prechecks(sig + (int64_t)lane * 64,
                                         pub + (int64_t)lane * 32);
}
#endif

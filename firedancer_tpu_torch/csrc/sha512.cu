// Batched SHA-512 with per-lane lengths, one thread per message.
//
// Replaces the Pallas kernel firedancer_tpu/ops/pallas_sha.py
// `_sha512_kernel` (hi/lo uint32 word pairs in (8,128) tiles, padding
// prepared outside by ops/sha2._pad_message). Here a word is a native
// uint64_t, the 80 rounds are unrolled over a 16-word ring in registers,
// and the Merkle-Damgard padding (0x80 byte, 128-bit big-endian bit
// length, an extra block when len % 128 is in 112..127) is done in
// registers from (msg, len): the padded (B, nblock*128) buffer is never
// materialised. Each thread loops over its own lane's block count.
//
// What bounds it on the H100: the integer operations (~80 rounds of
// ~60 ALU ops per 128-byte block), far above the bytes it must move.
// Row reads are per thread with a row stride of the message width
// (1296 B on the verify path), so neighbouring threads do not touch
// neighbouring addresses and the loads are uncoalesced; they are served
// through L1/L2 and accepted in this first version.
//
// Plain PyTorch version: firedancer_tpu_torch/ops/sha2.py `sha512`.
#include <stdint.h>

// Without nvcc (__CUDACC__ unset) the file compiles as plain C++: the
// kernel becomes a host function of one lane, which the CPU tests drive
// lane by lane against the plain PyTorch version.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FD_DEV __device__ __forceinline__
#define FD_CONST __constant__
#else
#define FD_DEV static inline
#define FD_CONST
#endif

static FD_CONST const uint64_t kK512[80] = {
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

// Big-endian message word at byte offset `off` of a lane, padding
// included: bytes past len are 0 except the 0x80 at len. The bit length
// (words 14..15 of the lane's last block) is handled by the caller.
FD_DEV uint64_t msg_word(const uint8_t *row, int off, int len, int aligned) {
  if (aligned && off + 8 <= len)
    return bswap64(*(const uint64_t *)(row + off));
  uint64_t w = 0;
  for (int k = 0; k < 8; k++) {
    int p = off + k;
    uint64_t b = p < len ? (uint64_t)row[p] : (p == len ? 0x80u : 0u);
    w = (w << 8) | b;
  }
  return w;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(128)
#else
extern "C" void
#endif
sha512_kernel(const uint8_t *__restrict__ msg, int64_t stride,
              const int32_t *__restrict__ lens, uint8_t *__restrict__ out,
              int n, int aligned, int lane) {
#ifdef __CUDACC__
  lane = blockIdx.x * blockDim.x + threadIdx.x;
#endif
  // (host build: `lane` is the caller's lane index)
  if (lane >= n) return;                    // ragged batch edge
  const uint8_t *row = msg + (int64_t)lane * stride;
  int len = lens[lane];
  len = len < 0 ? 0 : (len > stride ? (int)stride : len);
  const int nb = (len + 17 + 127) / 128;

  uint64_t st[8] = {
      0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
      0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
      0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

  for (int blk = 0; blk < nb; blk++) {
    uint64_t w[16];
    const bool last = blk == nb - 1;
#pragma unroll
    for (int t = 0; t < 16; t++) {
      if (last && t == 14) w[t] = 0;
      else if (last && t == 15) w[t] = (uint64_t)len * 8u;
      else w[t] = msg_word(row, blk * 128 + t * 8, len, aligned);
    }
    uint64_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint64_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
    for (int t = 0; t < 80; t++) {
      if (t >= 16) {
        uint64_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
        uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7);
        uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6);
        w[t & 15] += s0 + w[(t - 7) & 15] + s1;
      }
      uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
      uint64_t ch = (e & f) ^ (~e & g);
      uint64_t t1 = h + S1 + ch + kK512[t] + w[t & 15];
      uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
      uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
      h = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + S0 + maj;
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
  }
  uint8_t *o = out + (int64_t)lane * 64;
#pragma unroll
  for (int i = 0; i < 8; i++)
#pragma unroll
    for (int k = 0; k < 8; k++) o[8 * i + k] = (uint8_t)(st[i] >> (56 - 8 * k));
}

#ifdef __CUDACC__
// msg (n, stride) uint8, lens (n,) int32, out (n, 64) uint8; all device
// pointers; launches on `stream` and returns cudaGetLastError().
extern "C" int fdtt_sha512(const void *msg, long long stride,
                           const void *lens, void *out, int n,
                           void *stream) {
  const int aligned = ((uintptr_t)msg % 8 == 0) && (stride % 8 == 0);
  const int threads = 128;
  if (n > 0)
    sha512_kernel<<<(n + threads - 1) / threads, threads, 0,
                    (cudaStream_t)stream>>>(
        (const uint8_t *)msg, (int64_t)stride, (const int32_t *)lens,
        (uint8_t *)out, n, aligned, 0);
  return (int)cudaGetLastError();
}
#endif

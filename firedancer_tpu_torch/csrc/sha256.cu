// Batched SHA-256 with per-lane lengths, and batched Proof-of-History
// entry verification on it, one thread per row or entry.
//
// Replaces two jitted device ops of the JAX package:
//  * firedancer_tpu/ops/sha2.py:211 `sha256`, a `lax.scan` of 64 rounds
//    inside a scan over blocks on a padded (..., nblock, 64) buffer that
//    ops/sha2._pad_message prepares outside the rounds;
//  * firedancer_tpu/ops/poh.py:41 `poh_verify_entries`, which chains that
//    op max_hashes times over every entry, with masked steps past each
//    entry's own count, and hashes state || mixin once more.
// Eagerly in PyTorch each round would be some thirty launches; here a
// thread runs its row's or entry's whole chain in registers.
//
// Entry `sha256` (fdtt_sha256): thread i hashes msg[i, :len_i]. The state
// and the 16-word schedule ring live in registers, and the Merkle-Damgard
// padding (0x80, zeros, the 64-bit big-endian bit length) is formed in
// registers; a lane runs (len + 9 + 63) / 64 blocks and no more. Words are
// read as aligned 32-bit loads when the rows are 4-byte aligned and the
// row width a multiple of 4, else byte by byte (the path the host build
// tests lane by lane).
//
// Entry `poh_verify` (fdtt_poh_verify): thread i starts from prev[i] and
// hashes the 32-byte state min(n_plain, max_hashes) times, n_plain being
// num_hashes - 1 with a mixin and num_hashes without; each of those is one
// block whose padding is fixed (0x80 at byte 32, bit length 256). With a
// mixin it then hashes state || mixin (64 bytes: two blocks, the second
// all padding, bit length 512). The verdict is final == expected and
// num_hashes >= 1.
//
// What bounds it on the H100: for `sha256`, the integer operations (64
// rounds of about 14 32-bit operations and 48 schedule words of about 10
// per 64-byte block), far above the bytes it must move. For `poh_verify`,
// the critical chain: an entry is a sequence of dependent compressions
// (mainnet's 12,500 a tick), each 64 dependent rounds, so the time is one
// entry's chain of compressions and not the card's rate, as stage 2's
// Horner of csrc/ed25519_msm.cu is a chain of rounds on one group. Its
// floor is the longest entry's rounds at three dependent instructions
// each (the Sigma1 rotates, their xor3, the add into e) at one cycle an
// instruction; chip_smoke.py reports it as `chain_ms` beside `bound_ms`,
// which stays the operations bound. One warp a block spreads the entries
// over the SMs, so no two chains share a scheduler while SMs are free.
//
// Plain PyTorch versions: firedancer_tpu_torch/ops/sha2.py `sha256` and
// firedancer_tpu_torch/ops/poh.py `poh_verify_plain`.
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FD_DEV __device__ __forceinline__
#define FD_CONST __constant__
#define FD_LDG(p) __ldg(p)
#else
#define FD_DEV static inline
#define FD_CONST static const
#define FD_LDG(p) (*(p))
#endif

FD_CONST uint32_t kK256[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
    0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
    0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
    0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
    0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
    0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
    0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
    0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
};

FD_DEV uint32_t rotr32(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

FD_DEV uint32_t bswap32(uint32_t x) {
  return (x >> 24) | ((x >> 8) & 0xff00u) | ((x << 8) & 0xff0000u) |
         (x << 24);
}

FD_DEV void sha256_init(uint32_t st[8]) {
  const uint32_t h[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u,
                         0xa54ff53au, 0x510e527fu, 0x9b05688cu,
                         0x1f83d9abu, 0x5be0cd19u};
#pragma unroll
  for (int i = 0; i < 8; i++) st[i] = h[i];
}

// one 64-byte block: the 64 rounds over the message words w (consumed as
// the schedule ring) and the state update
FD_DEV void sha256_block(uint32_t st[8], uint32_t w[16]) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; i++) v[i] = st[i];
#pragma unroll
  for (int t = 0; t < 64; t++) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15] += s0 + w[(t - 7) & 15] + s1;
    }
    const uint32_t a = v[0], e = v[4];
    const uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
    const uint32_t ch = (e & v[5]) ^ (~e & v[6]);
    const uint32_t t1 = v[7] + S1 + ch + kK256[t] + wt;
    const uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
    const uint32_t maj = (a & v[1]) ^ (a & v[2]) ^ (v[1] & v[2]);
#pragma unroll
    for (int i = 7; i > 0; i--) v[i] = v[i - 1];
    v[4] += t1;
    v[0] = t1 + S0 + maj;
  }
#pragma unroll
  for (int i = 0; i < 8; i++) st[i] += v[i];
}

// blocks a message of n bytes pads to (0x80 and the 8-byte length fit)
FD_DEV int sha256_nblocks(int n) { return (n + 9 + 63) / 64; }

// the padded big-endian word at message offset off of a row of n bytes:
// bytes from n on become 0, except the 0x80 at n. ALIGNED reads the word
// with one 32-bit load (the row's 4 bytes at off lie inside it), else the
// bytes below n one by one. (The bit length is set by the caller.)
template <bool ALIGNED>
FD_DEV uint32_t msg_word(const uint8_t *m, int off, int n) {
  const int k = n - off;                  // message bytes in the word
  if (k <= 0) return k == 0 ? 0x80000000u : 0u;
  uint32_t w = 0;
  if (ALIGNED) {
    w = bswap32(FD_LDG((const uint32_t *)(m + off)));
  } else {
#pragma unroll
    for (int b = 0; b < 4; b++)
      w = (w << 8) | (b < k ? (uint32_t)FD_LDG(m + off + b) : 0u);
  }
  if (k >= 4) return w;
  return (w & (~0u << (32 - 8 * k))) | (0x80u << (24 - 8 * k));
}

// one row's digest state over its n bytes
template <bool ALIGNED>
FD_DEV void sha256_lane(uint32_t st[8], const uint8_t *m, int n) {
  const int nb = sha256_nblocks(n);
  sha256_init(st);
  for (int blk = 0; blk < nb; blk++) {
    uint32_t w[16];
#pragma unroll
    for (int t = 0; t < 16; t++) w[t] = msg_word<ALIGNED>(m, blk * 64 + 4 * t, n);
    if (blk == nb - 1) {
      w[14] = (uint32_t)((uint64_t)n >> 29);
      w[15] = (uint32_t)n << 3;
    }
    sha256_block(st, w);
  }
}

FD_DEV void load_be(uint32_t s[8], const uint8_t *p) {
#pragma unroll
  for (int i = 0; i < 8; i++)
    s[i] = ((uint32_t)FD_LDG(p + 4 * i) << 24) |
           ((uint32_t)FD_LDG(p + 4 * i + 1) << 16) |
           ((uint32_t)FD_LDG(p + 4 * i + 2) << 8) | FD_LDG(p + 4 * i + 3);
}

FD_DEV void store_be(uint8_t *o, const uint32_t st[8]) {
#pragma unroll
  for (int i = 0; i < 8; i++) {
    o[4 * i] = (uint8_t)(st[i] >> 24);
    o[4 * i + 1] = (uint8_t)(st[i] >> 16);
    o[4 * i + 2] = (uint8_t)(st[i] >> 8);
    o[4 * i + 3] = (uint8_t)st[i];
  }
}

// the verdict of one PoH entry (ops/poh.py:41-71 in the JAX package)
FD_DEV uint8_t poh_entry(const uint8_t *prev, int num, const uint8_t *mix,
                         bool has, const uint8_t *expected, int max_hashes) {
  uint32_t s[8];
  load_be(s, prev);
  int n_plain = has ? num - 1 : num;
  if (n_plain > max_hashes) n_plain = max_hashes;
#pragma unroll 1
  for (int i = 0; i < n_plain; i++) {
    uint32_t w[16];
#pragma unroll
    for (int k = 0; k < 8; k++) w[k] = s[k];
    w[8] = 0x80000000u;
#pragma unroll
    for (int k = 9; k < 15; k++) w[k] = 0u;
    w[15] = 256u;
    sha256_init(s);
    sha256_block(s, w);
  }
  if (has) {
    uint32_t w[16], m[8];
    load_be(m, mix);
#pragma unroll
    for (int k = 0; k < 8; k++) {
      w[k] = s[k];
      w[8 + k] = m[k];
    }
    sha256_init(s);
    sha256_block(s, w);
    w[0] = 0x80000000u;
#pragma unroll
    for (int k = 1; k < 15; k++) w[k] = 0u;
    w[15] = 512u;
    sha256_block(s, w);
  }
  uint32_t e[8];
  load_be(e, expected);
  bool eq = num >= 1;
#pragma unroll
  for (int k = 0; k < 8; k++) eq &= s[k] == e[k];
  return eq ? 1 : 0;
}

FD_DEV int clamp_len(int32_t len, int64_t L) {
  return len < 0 ? 0 : (len > L ? (int)L : (int)len);
}

#ifdef __CUDACC__
template <bool ALIGNED>
__global__ void __launch_bounds__(32)
sha256_kernel(const uint8_t *__restrict__ msg, int64_t L,
              const int32_t *__restrict__ lens, uint8_t *__restrict__ out,
              int n) {
  const int lane = blockIdx.x * 32 + threadIdx.x;
  if (lane >= n) return;
  uint32_t st[8];
  sha256_lane<ALIGNED>(st, msg + (int64_t)lane * L, clamp_len(lens[lane], L));
  store_be(out + (int64_t)lane * 32, st);
}

__global__ void __launch_bounds__(32)
poh_verify_kernel(const uint8_t *__restrict__ prev,
                  const int32_t *__restrict__ num,
                  const uint8_t *__restrict__ mix,
                  const uint8_t *__restrict__ has,
                  const uint8_t *__restrict__ expected,
                  uint8_t *__restrict__ ok, int n, int max_hashes) {
  const int i = blockIdx.x * 32 + threadIdx.x;
  if (i >= n) return;
  ok[i] = poh_entry(prev + (int64_t)i * 32, num[i], mix + (int64_t)i * 32,
                    has[i] != 0, expected + (int64_t)i * 32, max_hashes);
}

// msg (n, L) uint8, lens (n,) int32 -> out (n, 32) uint8 digests; device
// pointers; launches on `stream` and returns cudaGetLastError().
extern "C" int fdtt_sha256(const void *msg, long long L, const void *lens,
                           void *out, int n, void *stream) {
  const dim3 grid((n + 31) / 32);
  const cudaStream_t st = (cudaStream_t)stream;
  if (n > 0) {
    if (((uintptr_t)msg | (uintptr_t)L) % 4 == 0)
      sha256_kernel<true><<<grid, 32, 0, st>>>(
          (const uint8_t *)msg, (int64_t)L, (const int32_t *)lens,
          (uint8_t *)out, n);
    else
      sha256_kernel<false><<<grid, 32, 0, st>>>(
          (const uint8_t *)msg, (int64_t)L, (const int32_t *)lens,
          (uint8_t *)out, n);
  }
  return (int)cudaGetLastError();
}

// prev, mix, expected (n, 32) uint8, num (n,) int32, has (n,) bool ->
// ok (n,) bool; device pointers; launches on `stream` and returns
// cudaGetLastError().
extern "C" int fdtt_poh_verify(const void *prev, const void *num,
                               const void *mix, const void *has,
                               const void *expected, void *ok, int n,
                               int max_hashes, void *stream) {
  if (n > 0)
    poh_verify_kernel<<<(n + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)prev, (const int32_t *)num, (const uint8_t *)mix,
        (const uint8_t *)has, (const uint8_t *)expected, (uint8_t *)ok, n,
        max_hashes);
  return (int)cudaGetLastError();
}
#else
// Host build: lane `lane` of either entry. `aligned` picks the 32-bit
// load path of `sha256` (rows 4-byte aligned, L a multiple of 4).
extern "C" void sha256_lane_host(const uint8_t *msg, int64_t L,
                                 const int32_t *lens, uint8_t *out,
                                 int aligned, int lane) {
  uint32_t st[8];
  const uint8_t *m = msg + (int64_t)lane * L;
  const int n = clamp_len(lens[lane], L);
  if (aligned)
    sha256_lane<true>(st, m, n);
  else
    sha256_lane<false>(st, m, n);
  store_be(out + (int64_t)lane * 32, st);
}

extern "C" void poh_verify_host(const uint8_t *prev, const int32_t *num,
                                const uint8_t *mix, const uint8_t *has,
                                const uint8_t *expected, uint8_t *ok,
                                int max_hashes, int i) {
  ok[i] = poh_entry(prev + (int64_t)i * 32, num[i], mix + (int64_t)i * 32,
                    has[i] != 0, expected + (int64_t)i * 32, max_hashes);
}
#endif

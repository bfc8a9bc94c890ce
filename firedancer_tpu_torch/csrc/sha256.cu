// Batched SHA-256 with per-lane lengths, and batched Proof-of-History
// entry verification on it.
//
// Replaces two jitted device ops of the JAX package:
//  * firedancer_tpu/ops/sha2.py:211 `sha256`, a `lax.scan` of 64 rounds
//    inside a scan over blocks on a padded (..., nblock, 64) buffer that
//    ops/sha2._pad_message prepares outside the rounds;
//  * firedancer_tpu/ops/poh.py:41 `poh_verify_entries`, which chains that
//    op max_hashes times over every entry, with masked steps past each
//    entry's own count, and hashes state || mixin once more.
//
// What bounds them on the H100 (measured on an NVIDIA H100 80GB HBM3 at
// 700 W by tools/sha256_bench.py and tools/pipe_bench.cu; PERF.md §6):
// one warp's instruction stream. A SHA-256 round is
// 6 rotates and 4 LOP3s (Sigma0, Sigma1, Ch, Maj) and a schedule word 4
// rotates, 2 shifts and 2 LOP3s; all issue to the ALU pipe, 16 INT32
// lanes a sub-partition, so a warp issues one every 2.09 clocks, half a
// warp no faster, and an IMAD.HI (the one FMA-pipe form of a right shift)
// takes 6.3. A dependent instruction waits 4.4-4.6 clocks. Adds can go to
// the FMA pipe as IMADs, but an IMAD adds two terms where an IADD3 adds
// three, and an IMAD and an ALU instruction in turn issue at 1.25-1.7
// clocks each, not 1: a warp gains from the FMA pipe only where an IMAD
// replaces an instruction one for one. The operations bound is far below.
//
// The design does three things about it. The round core (sha_round)
// keeps the ALU count at the fewest, 6 rotates, 4 LOP3s and 2 IADD3s a
// round, puts its two two-term adds on the FMA pipe, and keeps each chain
// at three dependent instructions a round. Both entries run on blocks of
// two warps, each on its own sub-partition with its own issue slot: warp
// 0 issues only the rounds, warp 1 everything else (the schedule, K_t +
// W_t of rounds 16-63, and for `sha256` the loads and the message
// words), handed over in shared memory under named barriers. And
// `poh_verify`, whose time is one warp's chain, splits each round over a
// lane pair (pair_step): 7 ALU instructions a step on each lane instead
// of 12 a round on one.
//
// Entry `poh_verify` (fdtt_poh_verify): an entry's chain of compressions
// is serial (mainnet's 12,500 a tick), so the time is the round warp's
// stream for the longest entry. A block carries 16 entries: round-warp
// lane l holds entry l's e, f, g, h and lane l + 16 its a, b, c, d; one
// instruction stream serves both (Sigma's rotations and the Ch operands
// differ by lane, Maj(a, b, c) = Ch(a ^ c, b, c)), the a-lane two rounds
// behind the e-lane so that each lane takes the value its partner
// shuffled two steps before (d on the e-lane, new e on the a-lane): 66
// steps a hash. Warp 1 computes a hash's K_t + W_t of rounds 16-63 as
// soon as the round warp publishes the state (W0..W7), six rounds to a
// named barrier, while the round warp runs rounds 0-15 from the state in
// registers. The hash folds what a 32-byte message fixes: the padding
// words W8..W15 are literals, the schedule terms that read them sum to
// one literal or drop, K_t + W_t of rounds 8-15 are literals, and the
// feed-forward adds the lane's IV words. (Round 0's new e as W0 plus a
// constant made the kernel slower, 25.6 clocks a round against 23.5 on
// the same card; PERF.md §6.) Both warps run to the block's longest
// entry; a lane past its own count keeps its state. The mixin hash (two blocks) runs the
// generic block on lanes 0-15 after. The verdict is final == expected
// and num_hashes >= 1.
//
// Entry `sha256` (fdtt_sha256): thread i of each warp takes row i of
// msg[i, :len_i], both warps looping to the longest row's block count, a
// lane past its own count not updating its state. Warp 1 stages the rows
// through shared memory: for each 64-byte block it copies its 32 rows'
// 16-byte pieces of the 16-aligned window around the block (5 pieces, 4
// when the row is 16-aligned) with cp.async, neighbouring threads on
// neighbouring addresses, double-buffered so block b + 1 is in flight
// while block b is read; a piece that holds none of the lane's bytes of
// the block is not read. Each thread forms its 16 big-endian words from
// its slot with one PRMT each (the row's address mod 4 picks the bytes),
// the padding (0x80, zeros, the 64-bit bit length) without a branch,
// then the schedule, into one of two K + W buffers: warp 1 runs a block
// ahead of warp 0. One path for every row width and alignment: bmtree's
// 58- and 90-byte levels, the 1070-byte shred leaves and the 1296- and
// 1297-byte rows run the same code.
//
// Plain PyTorch versions: firedancer_tpu_torch/ops/sha2.py `sha256` and
// firedancer_tpu_torch/ops/poh.py `poh_verify_plain`.
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FD_DEV __device__ __forceinline__
#define FD_CX __host__ __device__ constexpr
#else
#include <string.h>
#define FD_DEV static inline
#define FD_CX static constexpr
#endif

// -- constants, usable at compile time and, indexed by an unrolled loop's
// counter, folded into literals in device code --

FD_CX uint32_t sha_k(int t) {
  constexpr uint32_t k[64] = {
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
      0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};
  return k[t];
}

FD_CX uint32_t sha_iv(int i) {
  constexpr uint32_t h[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u,
                             0xa54ff53au, 0x510e527fu, 0x9b05688cu,
                             0x1f83d9abu, 0x5be0cd19u};
  return h[i];
}

// the padding words W8..W15 of a 32-byte message's one block (PoH)
FD_CX uint32_t poh_pad(int i) {
  return i == 8 ? 0x80000000u : i == 15 ? 256u : 0u;
}

// -- the round core: rotates as funnel shifts and Ch, Maj and each xor3
// as one LOP3 on the ALU pipe; the adds that sum three terms as IADD3s,
// the two-term ones as IMADs on the FMA pipe --

#ifdef __CUDACC__
// 1 and 2^32 - 1 as operands ptxas cannot fold: a + b written as a * 1 +
// b (a - b as b * (2^32 - 1) + a) stays an IMAD, issued to the FMA pipe,
// where ptxas would emit an IADD3 on the ALU pipe that the rotates and
// LOP3s fill
__constant__ uint32_t kMadOne = 1u, kMadMinusOne = 0xffffffffu;

FD_DEV uint32_t fadd(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(kMadOne),
      "r"(b));
  return d;
}

FD_DEV uint32_t fsub(uint32_t a, uint32_t b) {    // a - b
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(b), "r"(kMadMinusOne),
      "r"(a));
  return d;
}

FD_DEV uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

FD_DEV uint32_t byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  return __byte_perm(x, y, s);
}
#else
FD_DEV uint32_t fadd(uint32_t a, uint32_t b) { return a + b; }
FD_DEV uint32_t fsub(uint32_t a, uint32_t b) { return a - b; }
FD_DEV uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }
// __byte_perm: byte i of the result is byte (s >> 4 i) & 7 of y:x
FD_DEV uint32_t byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; i++)
    r |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}
#endif

FD_DEV uint32_t s0(uint32_t x) { return rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3); }
FD_DEV uint32_t s1(uint32_t x) {
  return rotr(x, 17) ^ rotr(x, 19) ^ (x >> 10);
}

// round t on v, the working variables with a at v[-t & 7] (the rounds
// rename instead of moving), given hkw = h + K_t + W_t. New e = (d + hkw)
// + Sigma1 + Ch is one IADD3 after the rotates and the LOP3 of e, and new
// a = new e + Sigma0 + (Maj - d) one IADD3 after new e and those of a:
// each chain three dependent instructions a round. 6 rotates, 4 LOP3s
// and 2 IADD3s on the ALU pipe, 2 IMADs (d + hkw, Maj - d) on the FMA
// pipe.
FD_DEV void sha_round(uint32_t v[8], int t, uint32_t hkw) {
  const uint32_t a = v[-t & 7], b = v[(1 - t) & 7], c = v[(2 - t) & 7],
                 d = v[(3 - t) & 7], e = v[(4 - t) & 7], f = v[(5 - t) & 7],
                 g = v[(6 - t) & 7];
  const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
  const uint32_t ch = (e & f) ^ (~e & g);
  const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
  const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
  const uint32_t ne = fadd(d, hkw) + S1 + ch;
  v[(3 - t) & 7] = ne;
  v[(7 - t) & 7] = ne + S0 + fsub(maj, d);
}

// round t given kw = K_t + W_t, h not a literal: hkw as an IMAD
FD_DEV void sha_round_kw(uint32_t v[8], int t, uint32_t kw) {
  sha_round(v, t, fadd(v[(7 - t) & 7], kw));
}

// One step of a lane of a pair, the round split over two lanes: an
// e-lane holds x = (e, f, g, h), an a-lane (a, b, c, d), newest first;
// n0..n2 are its Sigma rotations, ma all ones on an a-lane, sgn 1 on an
// e-lane and 2^32 - 1 on an a-lane, kwl K_t + W_t on an e-lane and 0 on
// an a-lane, r the partner's value (d on an e-lane, new e on an a-lane).
// -> new e = h + kw + d + Sigma1(e) + Ch(e, f, g), or new a = new e - d
// + Sigma0(a) + Maj(a, b, c), with Maj(a, b, c) = Ch(a ^ c, b, c): one
// instruction stream for both lanes, 7 on the ALU pipe.
FD_DEV uint32_t pair_step(const uint32_t x[4], int n0, int n1, int n2,
                          uint32_t ma, uint32_t sgn, uint32_t kwl,
                          uint32_t r) {
  const uint32_t S = rotr(x[0], n0) ^ rotr(x[0], n1) ^ rotr(x[0], n2);
  const uint32_t p = x[0] ^ (ma & x[2]);
  const uint32_t F = (p & x[1]) ^ (~p & x[2]);
  return fadd(x[3] * sgn + kwl, r) + S + F;
}

// W_t (16 <= t < 64) into the ring w, returned. With poh, w[8..15] hold
// the padding literals poh_pad(8..15) until the schedule overwrites them:
// the terms that read them are summed as one literal at compile time
// (the zeros W9..W14 drop).
FD_DEV uint32_t sched(uint32_t w[16], int t, bool poh) {
  const auto lit = [&](int i) { return poh && i >= 8 && i < 16; };
  const uint32_t a = w[(t - 16) & 15], b = w[(t - 7) & 15],
                 c = s0(w[(t - 15) & 15]), d = s1(w[(t - 2) & 15]);
  return w[t & 15] = (lit(t - 16) ? a : 0) + (lit(t - 7) ? b : 0) +
                     (lit(t - 15) ? c : 0) + (lit(t - 2) ? d : 0) +
                     (lit(t - 16) ? 0 : a) + (lit(t - 7) ? 0 : b) +
                     (lit(t - 15) ? 0 : c) + (lit(t - 2) ? 0 : d);
}

// one 64-byte block: the 64 rounds over the message words w (consumed as
// the schedule ring) and the state update
FD_DEV void sha256_block(uint32_t st[8], uint32_t w[16]) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; i++) v[i] = st[i];
#pragma unroll
  for (int t = 0; t < 64; t++) {
    const uint32_t wt = t < 16 ? w[t] : sched(w, t, false);
    sha_round_kw(v, t, wt + sha_k(t));
  }
#pragma unroll
  for (int i = 0; i < 8; i++) st[i] = fadd(st[i], v[i]);
}

// state || mixin: two blocks from the IV, the second all padding (bit
// length 512)
FD_DEV void poh_mixin(uint32_t s[8], const uint32_t m[8]) {
  uint32_t w[16];
#pragma unroll
  for (int k = 0; k < 8; k++) {
    w[k] = s[k];
    w[8 + k] = m[k];
    s[k] = sha_iv(k);
  }
  sha256_block(s, w);
#pragma unroll
  for (int k = 0; k < 16; k++) w[k] = k == 0 ? 0x80000000u : k == 15 ? 512u : 0u;
  sha256_block(s, w);
}

// blocks a message of n bytes pads to (0x80 and the 8-byte length fit)
FD_DEV int sha256_nblocks(int n) { return (n + 9 + 63) / 64; }

// the padded big-endian word v of a row of n bytes at message offset
// off: bytes from n on become 0, except the 0x80 at n (the bit length is
// set by the caller); shifts of 64-bit masks by the k message bytes in
// the word, no branch
FD_DEV uint32_t pad_word(uint32_t v, int off, int n) {
  int k = n - off;
  k = k < -1 ? -1 : k > 4 ? 4 : k;
  const uint32_t keep = (uint32_t)(0xffffffff00000000ull >> (8 * (k < 0 ? 0 : k)));
  return (v & keep) | (uint32_t)(0x8000000000ull >> (8 * k + 8));
}

// A row's block in shared memory: the 16-byte pieces of the 16-aligned
// window around its 64 bytes, 80 bytes at most (an odd number of 16-byte
// units, so a warp's LDS.128 of one piece each spreads over the banks).
#define SLOT 80

// the block's 16 padded message words from a lane's slot, whose first
// message byte is at slot offset o (the row's address mod 16); sel picks
// and byte-swaps the 4 bytes at o & 3 from two neighbouring words
FD_DEV void slot_words(uint32_t w[16], const uint8_t *slot, int o, int blk,
                       int n) {
  const uint32_t *u = (const uint32_t *)(slot + (o & 12));
  const uint32_t b = o & 3;
  const uint32_t sel = (b + 3) | (b + 2) << 4 | (b + 1) << 8 | b << 12;
  uint32_t x[17];
#pragma unroll
  for (int k = 0; k < 17; k++) x[k] = u[k];
#pragma unroll
  for (int k = 0; k < 16; k++) w[k] = byte_perm(x[k], x[k + 1], sel);
  if (64 * blk + 64 > n) {
#pragma unroll
    for (int k = 0; k < 16; k++) w[k] = pad_word(w[k], 64 * blk + 4 * k, n);
  }
  if (blk == sha256_nblocks(n) - 1) {
    w[14] = (uint32_t)((uint64_t)n >> 29);
    w[15] = (uint32_t)n << 3;
  }
}

FD_DEV void load_be(uint32_t s[8], const uint8_t *p) {
#pragma unroll
  for (int i = 0; i < 8; i++)
    s[i] = (uint32_t)p[4 * i] << 24 | (uint32_t)p[4 * i + 1] << 16 |
           (uint32_t)p[4 * i + 2] << 8 | p[4 * i + 3];
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

// plain hashes entry i runs: num - 1 with a mixin, num without, at most
// max_hashes, at least 0
FD_DEV int poh_plain(int num, bool has, int max_hashes) {
  int n = has ? num - 1 : num;
  n = n > max_hashes ? max_hashes : n;
  return n < 0 ? 0 : n;
}

// the verdict from the chain's end state s (ops/poh.py:41-71 in the JAX
// package): the mixin hash where there is one, then s == expected and
// num >= 1
FD_DEV uint8_t poh_verdict(uint32_t s[8], int num, const uint8_t *mix,
                           bool has, const uint8_t *expected) {
  if (has) {
    uint32_t m[8];
    load_be(m, mix);
    poh_mixin(s, m);
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
FD_DEV void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}
FD_DEV void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}

// the block blk of the block's 32 rows into buffer blk & 1 by cp.async:
// copy i of this thread is piece p of lane l's window, (l, p) =
// divmod(t + 32 i, 5), so neighbouring threads read neighbouring
// addresses. src[i] is the piece's address at block 0, dst[i] its shared
// address in buffer 0, lim[i] its offset bound: the piece holds one of
// the lane's bytes of this block iff 64 blk < lim[i].
__device__ __forceinline__ void stage(const uint8_t *const src[5],
                                      const int lim[5],
                                      const unsigned dst[5], int blk) {
#pragma unroll
  for (int i = 0; i < 5; i++) {
    if (64 * blk < lim[i])
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       dst[i] + (blk & 1) * 32 * SLOT),
                   "l"(src[i] + 64 * blk));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// ---- sha256 on two warps a block: warp 1 stages the rows, forms the
// words and computes the schedule a block ahead into kwb[blk & 1]
// (barriers 1-2: full, 3-4: free again), warp 0 runs the rounds ----

__global__ void __launch_bounds__(64)
sha256_kernel(const uint8_t *__restrict__ msg, int64_t L,
              const int32_t *__restrict__ lens, uint8_t *__restrict__ out,
              int n) {
  __shared__ __align__(16) uint8_t buf[2][32 * SLOT];
  __shared__ uint32_t kwb[2][64][32];   // K_t + W_t of two blocks
  const int t = threadIdx.x & 31, base = blockIdx.x * 32, lane = base + t;
  const int len = lane < n ? clamp_len(lens[lane], L) : 0;
  const int nb = lane < n ? sha256_nblocks(len) : 0;
  const int nbw = __reduce_max_sync(0xffffffffu, nb);
  if (threadIdx.x >= 32) {
    const int o = (int)((uintptr_t)(msg + (int64_t)lane * L) & 15);
    const uint8_t *src[5];
    int lim[5];
    unsigned dst[5];
#pragma unroll
    for (int i = 0; i < 5; i++) {
      const int j = t + 32 * i, l = j / 5, p = j % 5;
      const int ln = __shfl_sync(0xffffffffu, len, l);
      const uint8_t *row = msg + (int64_t)(base + l) * L;
      const int a = 16 * p - (int)((uintptr_t)row & 15);
      src[i] = row + a;
      lim[i] = (base + l < n && a < 64) ? ln - a : -1;
      dst[i] = (unsigned)__cvta_generic_to_shared(buf[0] + l * SLOT + 16 * p);
    }
    stage(src, lim, dst, 0);
#pragma unroll 1
    for (int blk = 0; blk < nbw; blk++) {
      if (blk + 1 < nbw)
        stage(src, lim, dst, blk + 1);
      else
        asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);
      __syncwarp();
      uint32_t w[16];
      slot_words(w, buf[blk & 1] + t * SLOT, o, blk, len);
      __syncwarp();
      if (blk >= 2) bar_sync(3 + (blk & 1));    // kwb[blk & 1] is free
      uint32_t (*kw)[32] = kwb[blk & 1];
#pragma unroll
      for (int r = 0; r < 64; r++)
        kw[r][t] = (r < 16 ? w[r] : sched(w, r, false)) + sha_k(r);
      bar_arrive(1 + (blk & 1));
    }
    return;
  }
  uint32_t st[8];
#pragma unroll
  for (int i = 0; i < 8; i++) st[i] = sha_iv(i);
#pragma unroll 1
  for (int blk = 0; blk < nbw; blk++) {
    bar_sync(1 + (blk & 1));
    uint32_t (*kw)[32] = kwb[blk & 1];
    uint32_t v[8];
#pragma unroll
    for (int i = 0; i < 8; i++) v[i] = st[i];
#pragma unroll
    for (int r = 0; r < 64; r++) sha_round_kw(v, r, kw[r][t]);
    if (blk + 2 < nbw) bar_arrive(3 + (blk & 1));
    if (blk < nb) {
#pragma unroll
      for (int i = 0; i < 8; i++) st[i] = fadd(st[i], v[i]);
    }
  }
  if (lane < n) store_be(out + (int64_t)lane * 32, st);
}

// ---- poh_verify on lane pairs: warp 0 runs 16 entries, lane l their
// e-chain and lane l + 16 their a-chain, the a-lane two rounds behind;
// warp 1 the schedule (barriers 1: the state, 2-9: rounds 16-63 in
// chunks of 6) ----

__global__ void __launch_bounds__(64)
poh_verify_kernel(const uint8_t *__restrict__ prev,
                  const int32_t *__restrict__ num,
                  const uint8_t *__restrict__ mix,
                  const uint8_t *__restrict__ has,
                  const uint8_t *__restrict__ expected,
                  uint8_t *__restrict__ ok, int n, int max_hashes) {
  __shared__ uint32_t kw[48][32];     // K_t + W_t of rounds 16..63; 0 at
                                      // lanes 16-31
  __shared__ uint32_t state[8][16];   // W0..W7 of the next hash
  const int t = threadIdx.x & 31, el = t & 15, i0 = blockIdx.x * 16 + el;
  const int i = i0 < n ? i0 : n - 1;
  const int np = i0 < n ? poh_plain(num[i], has[i] != 0, max_hashes) : 0;
  const int iters = __reduce_max_sync(0xffffffffu, np);
  if (threadIdx.x >= 32) {            // the schedule warp
#pragma unroll 1
    for (int it = 0; it < iters; it++) {
      bar_sync(1);
      uint32_t w[16];
#pragma unroll
      for (int k = 0; k < 8; k++) w[k] = state[k][el];
#pragma unroll
      for (int k = 8; k < 16; k++) w[k] = poh_pad(k);
#pragma unroll
      for (int c = 0; c < 8; c++) {
#pragma unroll
        for (int j = 0; j < 6; j++) {
          const int r = 16 + 6 * c + j;
          const uint32_t v = sched(w, r, true) + sha_k(r);
          kw[r - 16][t] = t < 16 ? v : 0u;
        }
        bar_arrive(2 + c);
      }
    }
    return;
  }
  const bool ea = t < 16;             // e-lane
  const int off = ea ? 4 : 0;
  const int n0 = ea ? 6 : 2, n1 = ea ? 11 : 13, n2 = ea ? 25 : 22;
  const uint32_t ma = ea ? 0u : ~0u, sgn = ea ? 1u : ~0u, e01 = ea ? 1u : 0u;
  uint32_t st[4], ivl[4];
#pragma unroll
  for (int k = 0; k < 4; k++) {
    const uint8_t *p = prev + (int64_t)i * 32 + 4 * (off + k);
    st[k] = (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 |
            (uint32_t)p[2] << 8 | p[3];
    ivl[k] = ea ? sha_iv(4 + k) : sha_iv(k);
  }
#pragma unroll 1
  for (int it = 0; it < iters; it++) {
#pragma unroll
    for (int k = 0; k < 4; k++) state[off + k][el] = st[k];
    bar_arrive(1);
    st[0] = state[off][el];     // read back, so that no step moves above it
    uint32_t wp[4];             // W0..W3, the a-lane's words, on the e-lane
#pragma unroll
    for (int k = 0; k < 4; k++) wp[k] = __shfl_xor_sync(0xffffffffu, st[k], 16);
    uint32_t x[4], u0 = ea ? sha_iv(3) : 0u, u1 = ea ? sha_iv(2) : 0u;
#pragma unroll
    for (int k = 0; k < 4; k++) x[k] = ivl[k];
#pragma unroll
    for (int s = 0; s < 66; s++) {
      if (s >= 16 && s < 64 && (s - 16) % 6 == 0) bar_sync(2 + (s - 16) / 6);
      uint32_t kwl;
      if (s < 8)
        kwl = ((s < 4 ? wp[s] : st[s - 4]) + sha_k(s)) * e01;
      else if (s < 16)
        kwl = (sha_k(s) + poh_pad(s)) * e01;
      else if (s < 64)
        kwl = kw[s - 16][t];
      else
        kwl = 0u;
      const uint32_t xn = pair_step(x, n0, n1, n2, ma, sgn, kwl, u0);
      // the a-lane runs rounds from step 2 on, sending b then a before;
      // the e-lane ends at step 63
      const uint32_t snd = s < 2 && !ea ? x[1 - s] : xn;
      if (!((s < 2 && !ea) || (s >= 64 && ea))) {
        x[3] = x[2];
        x[2] = x[1];
        x[1] = x[0];
        x[0] = xn;
      }
      u0 = u1;
      u1 = __shfl_xor_sync(0xffffffffu, snd, 16);
    }
    if (it < np) {
#pragma unroll
      for (int k = 0; k < 4; k++) st[k] = fadd(x[k], ivl[k]);
    }
  }
  uint32_t s8[8];
#pragma unroll
  for (int k = 0; k < 4; k++) {
    s8[k] = __shfl_down_sync(0xffffffffu, st[k], 16);
    s8[4 + k] = st[k];
  }
  if (ea && i0 < n)
    ok[i] = poh_verdict(s8, num[i], mix + (int64_t)i * 32, has[i] != 0,
                        expected + (int64_t)i * 32);
}

// msg (n, L) uint8, lens (n,) int32 -> out (n, 32) uint8 digests; device
// pointers; launches on `stream` and returns cudaGetLastError().
extern "C" int fdtt_sha256(const void *msg, long long L, const void *lens,
                           void *out, int n, void *stream) {
  if (n > 0)
    sha256_kernel<<<(n + 31) / 32, 64, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)msg, (int64_t)L, (const int32_t *)lens,
        (uint8_t *)out, n);
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
    poh_verify_kernel<<<(n + 15) / 16, 64, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)prev, (const int32_t *)num, (const uint8_t *)mix,
        (const uint8_t *)has, (const uint8_t *)expected, (uint8_t *)ok, n,
        max_hashes);
  return (int)cudaGetLastError();
}
#else
// Host build: lane `lane` of either entry. sha256 stages each block as the
// kernel does, into a slot whose bytes outside the row's block are
// garbage, and forms the words with the kernel's slot_words.
extern "C" void sha256_lane_host(const uint8_t *msg, int64_t L,
                                 const int32_t *lens, uint8_t *out,
                                 int lane) {
  const uint8_t *row = msg + (int64_t)lane * L;
  const int n = clamp_len(lens[lane], L), o = (int)((uintptr_t)row & 15);
  uint32_t st[8];
  for (int i = 0; i < 8; i++) st[i] = sha_iv(i);
  for (int blk = 0; blk < sha256_nblocks(n); blk++) {
    alignas(16) uint8_t slot[SLOT];
    memset(slot, 0xa5, SLOT);
    for (int b = 64 * blk; b < n && b < 64 * blk + 64; b++)
      slot[o + b - 64 * blk] = row[b];
    uint32_t w[16];
    slot_words(w, slot, o, blk, n);
    sha256_block(st, w);
  }
  store_be(out + (int64_t)lane * 32, st);
}

// one PoH hash as a lane pair of poh_verify_kernel runs it: the e-lane
// (L = 0) and the a-lane (L = 1) stepped together, each step's values
// crossing as the kernel's shuffles carry them; s <- SHA-256(s), s the
// 32-byte state as 8 big-endian words
static void poh_hash(uint32_t s[8]) {
  uint32_t kw[64], w[16];
  for (int k = 0; k < 16; k++) w[k] = k < 8 ? s[k] : poh_pad(k);
  for (int r = 0; r < 64; r++)
    kw[r] = (r < 16 ? w[r] : sched(w, r, true)) + sha_k(r);
  const int rot[2][3] = {{6, 11, 25}, {2, 13, 22}};
  uint32_t x[2][4], u0[2] = {sha_iv(3), 0}, u1[2] = {sha_iv(2), 0};
  for (int k = 0; k < 4; k++) {
    x[0][k] = sha_iv(4 + k);
    x[1][k] = sha_iv(k);
  }
  for (int st = 0; st < 66; st++) {
    uint32_t snd[2];
    for (int L = 0; L < 2; L++) {
      const uint32_t kwl = L == 0 && st < 64 ? kw[st] : 0u;
      const uint32_t xn = pair_step(x[L], rot[L][0], rot[L][1], rot[L][2],
                                    L ? ~0u : 0u, L ? ~0u : 1u, kwl, u0[L]);
      snd[L] = st < 2 && L == 1 ? x[L][1 - st] : xn;
      if (!((st < 2 && L == 1) || (st >= 64 && L == 0))) {
        x[L][3] = x[L][2];
        x[L][2] = x[L][1];
        x[L][1] = x[L][0];
        x[L][0] = xn;
      }
    }
    for (int L = 0; L < 2; L++) {
      u0[L] = u1[L];
      u1[L] = snd[1 - L];
    }
  }
  for (int k = 0; k < 4; k++) {
    s[k] = x[1][k] + sha_iv(k);
    s[4 + k] = x[0][k] + sha_iv(4 + k);
  }
}

// n PoH hashes of a 32-byte state, in place
extern "C" void poh_hashes_host(uint8_t *state, int n) {
  uint32_t s[8];
  load_be(s, state);
  for (int i = 0; i < n; i++) poh_hash(s);
  store_be(state, s);
}

extern "C" void poh_verify_host(const uint8_t *prev, const int32_t *num,
                                const uint8_t *mix, const uint8_t *has,
                                const uint8_t *expected, uint8_t *ok,
                                int max_hashes, int i) {
  uint32_t s[8];
  load_be(s, prev + (int64_t)i * 32);
  const int np = poh_plain(num[i], has[i] != 0, max_hashes);
  for (int it = 0; it < np; it++) poh_hash(s);
  ok[i] = poh_verdict(s, num[i], mix + (int64_t)i * 32, has[i] != 0,
                      expected + (int64_t)i * 32);
}
#endif

// Batched BLAKE3 of messages up to two chunks (2,048 bytes), and the
// lattice hash (lthash: BLAKE3's XOF to 2,048 bytes, read as 1,024 16-bit
// lanes) of the same messages.
//
// Replaces the JAX package's jitted device ops
// firedancer_tpu/ops/blake3.py:139 `blake3_batch` and :150 `lthash_batch`:
// masked compressions of every block position of both chunks for every
// lane (`_root_state`, :82-136), then one root compression, or a
// `lax.scan` of 32 root compressions over the output counter.
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
// Message words are little-endian; bytes past n are 0. `blake3`'s digest
// is the first 8 output words of the root compression at counter 0, as
// 32 little-endian bytes; `lthash` runs the root compression at output
// counters 0..31 and writes each of its 16 words w as the two lanes
// (w & 0xFFFF, w >> 16), counter-major: out[msg, 32 c + 2 k + h], int32
// in [0, 2^16).
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3 at 700 W;
// tools/blake3_bench.py and tools/pipe_bench.cu, PERF.md §6): a
// compression is 7 rounds of 8 G functions of 12 32-bit integer
// operations whose rotates, xors and three-term adds issue to the ALU
// pipe, one warp instruction every 2.09 clocks on each of an SM's four
// sub-partitions (half a warp issues no faster); a shuffle takes 4.4
// clocks there and waits 26. Inside a G function every instruction waits
// on the one before (4.4-4.6 clocks), and a chunk is a chain of up to 16
// compressions. So at 4096 messages of up to 2,048 bytes the time is the
// chains: a thread a message fills 128 warps on 528 sub-partitions, each
// running the longest of its 32 chains of up to 33 compressions. lthash
// adds 32 independent XOF compressions a message, an issue-bound load,
// and 4 KB of int32 lanes a message, 16.8 MB at 4096 messages (0.005 ms
// of the card's 3.35 TB/s): at the bank hash's 81 bytes those two are
// the bound.
//
// The design (one kernel, both entries, a block of four warps a tile of
// 16 messages):
//  * Chunks, not messages, over lane groups. Warp 0 counts each message's
//    chunks (1, or 2 past 1,024 bytes) and scans them into the tile's
//    task table; group g of four lanes takes task g (a chunk of a
//    message), so a tile of one-chunk messages keeps two warps busy and
//    leaves two idle rather than running idle lanes in four, and a
//    two-chunk message's chunks run side by side: its chain is its longer
//    chunk's, then the root.
//  * Each chunk's compression chain split over its group: lane q holds
//    column q of the state (a, b, c, d = v[q], v[4+q], v[8+q], v[12+q]),
//    runs the column G function G_q, then, after a, c and d come from
//    lanes q - 1, q + 1 and q + 2 of the group by shuffles, the diagonal
//    G that holds its b; the shuffles back restore the columns (BLAKE3's
//    SIMD row layout). b stays in place and a moves, so the shuffle of a
//    issues five instructions before the end of a G function and its
//    latency hides behind them. A lane issues a quarter of a
//    compression's G work; its message words come from shared memory,
//    each lane at its own offsets (b3_word). Groups of two lanes, two
//    columns a lane, measured slower (PERF.md §6).
//  * Rows staged through shared memory: for each 64-byte block a group
//    copies the 16-byte pieces of the 16-aligned window around it by
//    cp.async (five pieces, four when the row is 16-aligned; a piece that
//    holds none of the chunk's bytes is not read), double-buffered, and
//    each lane forms four little-endian words with one PRMT each (the
//    row's address mod 4 picks the bytes), the bytes past the length
//    masked: one path for every row width and alignment.
//  * The root state once a message: the group ending a chunk writes its
//    chaining value, or the last block and its length and flags, into the
//    tile's root area in shared memory. `blake3` then runs each message's
//    root compression on a group; `lthash` spreads the 32 XOF compressions
//    of every message of the tile over all 128 threads (a warp four
//    messages, a lane a counter, the compression in one thread's
//    registers) and writes each message's 4 KB of lanes through shared
//    memory as contiguous 16-byte stores, neighbouring lanes on
//    neighbouring addresses.
//
// Plain PyTorch versions: firedancer_tpu_torch/ops/blake3.py
// `blake3_plain` and `lthash_plain`.
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FD_DEV __device__ __forceinline__
#define FD_CX __host__ __device__ constexpr
#define B3_TABLE __constant__
#else
#include <string.h>
#define FD_DEV static inline
#define FD_CX static constexpr
#define B3_TABLE static const
#endif

#define B3_CHUNK_START 1u
#define B3_CHUNK_END 2u
#define B3_PARENT 4u
#define B3_ROOT 8u
#define B3_CHUNK_LEN 1024
#define B3_BLOCK_LEN 64
#define B3_TILE 16            // messages a block of 128 threads
#define B3_GROUPS 32          // groups of four lanes a block
#define B3_SLOT 80            // a block's 16-aligned window: five 16-byte
                              // pieces
#define B3_RS 32              // words of a root state: cv[8], m[16], blen,
                              // flags
#define B3_STAGE 144          // bytes of a lane's 128 lthash bytes in the
                              // stage (padded: a quarter warp's 16-byte
                              // stores hit distinct banks)

B3_TABLE uint32_t kB3Iv[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u,
                              0xa54ff53au, 0x510e527fu, 0x9b05688cu,
                              0x1f83d9abu, 0x5be0cd19u};

// kB3Perm[r][k]: the block word at position k of round r, P^r(k) for the
// message permutation P = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14,
// 15, 8); read at positions known only at run time (a lane's columns)
B3_TABLE uint8_t kB3Perm[7][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8},
    {3, 4, 10, 12, 13, 2, 7, 14, 6, 5, 9, 0, 11, 15, 8, 1},
    {10, 7, 12, 9, 14, 3, 13, 15, 4, 0, 11, 2, 5, 8, 1, 6},
    {12, 13, 9, 11, 15, 10, 14, 8, 7, 2, 5, 3, 0, 1, 6, 4},
    {9, 14, 11, 5, 8, 12, 15, 1, 13, 3, 0, 10, 2, 6, 4, 7},
    {11, 15, 5, 0, 1, 9, 8, 6, 14, 10, 2, 12, 3, 4, 7, 13}};

// The state's 16 words as 4 columns (a, b, c, d) = v[q], v[4+q], v[8+q],
// v[12+q], lane q of a group holding column q. The column step runs G_q;
// the diagonal step runs the diagonal G function that holds lane q's b,
// G_{4 + ((q + 3) & 3)} = (a_{q-1}, b_q, c_{q+1}, d_{q+2}). b stays in
// place: register s (0 a, 2 c, 3 d) of lane q comes from lane q +
// b3_xoff(e, s) of its group (mod 4) into the diagonals (e = 0) and back
// to the columns (e = 1).
FD_CX int b3_xoff(int e, int s) {
  return s == 3 ? 2 : (s == 0) == (e == 0) ? 3 : 1;
}

// the block word that G's x (xy 0) or y (1) reads at round r in step e
// (0 the column G, 1 the diagonal G) on lane q
FD_DEV int b3_word(int r, int e, int q, int xy) {
  const int k = e == 0 ? q : (q + 3) & 3;
  return kB3Perm[r][8 * e + 2 * k + xy];
}

FD_DEV uint32_t b3_rotr(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

// the G function on x = (a, b, c, d)
FD_DEV void b3_g(uint32_t x[4], uint32_t mx, uint32_t my) {
  x[0] = x[0] + x[1] + mx;
  x[3] = b3_rotr(x[3] ^ x[0], 16);
  x[2] = x[2] + x[3];
  x[1] = b3_rotr(x[1] ^ x[2], 12);
  x[0] = x[0] + x[1] + my;
  x[3] = b3_rotr(x[3] ^ x[0], 8);
  x[2] = x[2] + x[3];
  x[1] = b3_rotr(x[1] ^ x[2], 7);
}

FD_DEV void b3_gv(uint32_t v[16], int a, int b, int c, int d, uint32_t mx,
                  uint32_t my) {
  uint32_t x[4] = {v[a], v[b], v[c], v[d]};
  b3_g(x, mx, my);
  v[a] = x[0];
  v[b] = x[1];
  v[c] = x[2];
  v[d] = x[3];
}

// A whole compression in one thread (lthash's XOF): block m (consumed)
// from chaining value cv -> the 16 output words (out[0..8) the digest
// words, out[8..16) the XOF's second half)
FD_DEV void b3_compress(const uint32_t cv[8], uint32_t m[16], uint32_t ctr,
                        uint32_t blen, uint32_t flags, uint32_t out[16]) {
  uint32_t v[16] = {cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
                    kB3Iv[0], kB3Iv[1], kB3Iv[2], kB3Iv[3],
                    ctr, 0u, blen, flags};
#pragma unroll
  for (int r = 0; r < 7; r++) {
    b3_gv(v, 0, 4, 8, 12, m[0], m[1]);
    b3_gv(v, 1, 5, 9, 13, m[2], m[3]);
    b3_gv(v, 2, 6, 10, 14, m[4], m[5]);
    b3_gv(v, 3, 7, 11, 15, m[6], m[7]);
    b3_gv(v, 0, 5, 10, 15, m[8], m[9]);
    b3_gv(v, 1, 6, 11, 12, m[10], m[11]);
    b3_gv(v, 2, 7, 8, 13, m[12], m[13]);
    b3_gv(v, 3, 4, 9, 14, m[14], m[15]);
    if (r < 6) {   // the message permutation, a renaming once unrolled
      const uint32_t t[16] = {m[2], m[6], m[3], m[10], m[7], m[0],
                              m[4], m[13], m[1], m[11], m[12], m[5],
                              m[9], m[14], m[15], m[8]};
#pragma unroll
      for (int i = 0; i < 16; i++) m[i] = t[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; i++) {
    out[i] = v[i] ^ v[i + 8];
    out[i + 8] = v[i + 8] ^ cv[i];
  }
}

// lane q's column at the start of a compression from the chaining value
// words cv[q], cv[4 + q] (ivq: IV word q)
FD_DEV void b3_lane_init(uint32_t x[4], int q, uint32_t ivq, uint32_t cvq,
                         uint32_t cvq4, uint32_t ctr, uint32_t blen,
                         uint32_t flags) {
  x[0] = cvq;
  x[1] = cvq4;
  x[2] = ivq;
  x[3] = q == 0 ? ctr : q == 1 ? 0u : q == 2 ? blen : flags;
}

FD_DEV int b3_len(int32_t len, int64_t L) {
  return len < 0 ? 0 : (len > L ? (int)L : (int)len);
}

// chunks of a message of n bytes (n < 0: no message)
FD_DEV int b3_chunks(int n) { return n < 0 ? 0 : n > B3_CHUNK_LEN ? 2 : 1; }

// chunk c of a message of n bytes: its bytes, the blocks its group
// stages and the compressions it chains (a one-chunk message's last
// block is kept for the root)
FD_DEV void b3_geom(int c, int n, int &clen, int &nb, int &ncomp) {
  clen = c ? n - B3_CHUNK_LEN : (n < B3_CHUNK_LEN ? n : B3_CHUNK_LEN);
  nb = clen > 0 ? (clen + B3_BLOCK_LEN - 1) / B3_BLOCK_LEN : 1;
  ncomp = n > B3_CHUNK_LEN ? nb : nb - 1;
}

// block b's length and flags in a chunk of clen bytes and nb blocks
FD_DEV uint32_t b3_blen(int b, int clen) {
  const int r = clen - b * B3_BLOCK_LEN;
  return r < B3_BLOCK_LEN ? (uint32_t)r : B3_BLOCK_LEN;
}
FD_DEV uint32_t b3_flags(int b, int nb) {
  return (b == 0 ? B3_CHUNK_START : 0u) | (b == nb - 1 ? B3_CHUNK_END : 0u);
}

// piece p (16 bytes from block offset 16 p - o) of block b holds one of
// the chunk's clen bytes
FD_DEV bool b3_piece_live(int p, int o, int b, int clen) {
  const int lo = 16 * p - o > 0 ? 16 * p - o : 0;
  return lo < B3_BLOCK_LEN && b * B3_BLOCK_LEN + lo < clen;
}

#ifdef __CUDACC__
FD_DEV uint32_t b3_prmt(uint32_t x, uint32_t y, uint32_t s) {
  return __byte_perm(x, y, s);
}
#else
// __byte_perm: byte i of the result is byte (s >> 4 i) & 7 of y:x
FD_DEV uint32_t b3_prmt(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; i++)
    r |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}
#endif

// lane q's words 4q..4q+3 of block b from its slot, whose first block
// byte is at slot offset o (the row's address mod 16): each picked from
// two neighbouring words by one PRMT, the bytes from the chunk's clen on
// zeroed
FD_DEV void b3_lane_words(uint32_t w[4], const uint8_t *slot, int o, int q,
                          int b, int clen) {
  const uint32_t *p = (const uint32_t *)(slot + (o & 12) + 16 * q);
  const uint32_t s = o & 3;
  const uint32_t sel = s | (s + 1) << 4 | (s + 2) << 8 | (s + 3) << 12;
  uint32_t x[5];
#pragma unroll
  for (int k = 0; k < 5; k++) x[k] = p[k];
#pragma unroll
  for (int k = 0; k < 4; k++) w[k] = b3_prmt(x[k], x[k + 1], sel);
  if ((b + 1) * B3_BLOCK_LEN > clen) {
#pragma unroll
    for (int k = 0; k < 4; k++) {
      int keep = clen - b * B3_BLOCK_LEN - 4 * (4 * q + k);
      keep = keep < 0 ? 0 : keep > 4 ? 4 : keep;
      w[k] &= (uint32_t)((1ull << (8 * keep)) - 1u);
    }
  }
}

// lane q's part of a message's root state rs (cv, m, blen, flags) once
// its group has chained chunk c (nb blocks) of a message of n bytes to
// the chaining value words cvq, cvq4; a one-chunk message's last block
// is already in rs[8..24) (ivq, ivq4: IV words q and 4 + q)
FD_DEV void b3_task_end(uint32_t *rs, int q, int c, int n, int nb,
                        uint32_t ivq, uint32_t ivq4, uint32_t cvq,
                        uint32_t cvq4) {
  if (n > B3_CHUNK_LEN) {
    rs[8 + 8 * c + q] = cvq;
    rs[12 + 8 * c + q] = cvq4;
    if (c == 0) {
      rs[q] = ivq;
      rs[4 + q] = ivq4;
      if (q == 0) {
        rs[24] = B3_BLOCK_LEN;
        rs[25] = B3_PARENT;
      }
    }
  } else {
    rs[q] = cvq;
    rs[4 + q] = cvq4;
    if (q == 0) {
      rs[24] = (uint32_t)(n - (nb - 1) * B3_BLOCK_LEN);
      rs[25] = B3_CHUNK_END | (nb == 1 ? B3_CHUNK_START : 0u);
    }
  }
}

// a message's 32 lthash lanes of one XOF output block (words o)
FD_DEV void b3_xof_lanes(int32_t l[32], const uint32_t o[16]) {
#pragma unroll
  for (int k = 0; k < 16; k++) {
    l[2 * k] = (int32_t)(o[k] & 0xffffu);
    l[2 * k + 1] = (int32_t)(o[k] >> 16);
  }
}

#ifdef __CUDACC__
#define B3_FULL 0xffffffffu

// One compression on a group: x lane q's column, its message words at
// the shared-memory byte offsets wa (into ws) in b3_word's order
FD_DEV void b3_group_compress(uint32_t x[4], const uint8_t *ws,
                              const uint32_t wa[28], int q) {
#define B3_W(i) (*(const uint32_t *)(ws + wa[i]))
#define B3_X(e)                                                          \
  x[0] = __shfl_sync(B3_FULL, x[0], q + b3_xoff(e, 0), 4);               \
  x[2] = __shfl_sync(B3_FULL, x[2], q + b3_xoff(e, 2), 4);               \
  x[3] = __shfl_sync(B3_FULL, x[3], q + b3_xoff(e, 3), 4);
#pragma unroll
  for (int r = 0; r < 7; r++) {
    b3_g(x, B3_W(4 * r), B3_W(4 * r + 1));
    B3_X(0)
    b3_g(x, B3_W(4 * r + 2), B3_W(4 * r + 3));
    B3_X(1)
  }
#undef B3_X
#undef B3_W
}

FD_DEV void b3_stage(const uint8_t *src, unsigned dst, int o, int q, int b,
                     int clen) {
#pragma unroll
  for (int p = q; p < 5; p += 4) {
    if (b3_piece_live(p, o, b, clen))
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       dst + (b & 1) * B3_SLOT + 16 * p),
                   "l"(src + b * B3_BLOCK_LEN + 16 * p - o));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <bool XOF>
__global__ void __launch_bounds__(128)
b3_kernel(const uint8_t *__restrict__ msg, int64_t L,
          const int32_t *__restrict__ lens, void *__restrict__ out, int n) {
  __shared__ __align__(16) uint8_t slot[B3_GROUPS][2 * B3_SLOT];
  __shared__ __align__(16) uint8_t wbuf[B3_GROUPS][64];
  __shared__ __align__(16) uint32_t root[B3_TILE][B3_RS];
  __shared__ __align__(16) uint8_t stage[XOF ? 4 : 1][XOF ? 32 * B3_STAGE : 16];
  __shared__ int task[B3_GROUPS], slen[B3_TILE], ntask;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5, g = t >> 2, q = t & 3;
  const int base = blockIdx.x * B3_TILE;
  // lane q's shared-memory byte offsets of its message words, into wbuf,
  // and the IV words of its column
  uint32_t wa[28];
#pragma unroll
  for (int i = 0; i < 28; i++)
    wa[i] = (uint32_t)(g * 64 + 4 * b3_word(i / 4, (i / 2) & 1, q, i & 1));
  const uint32_t ivq = kB3Iv[q], ivq4 = kB3Iv[4 + q];
  // the task table: message j's chunks at the exclusive scan of the
  // tile's chunk counts, each as j | c << 8
  if (w == 0) {
    const int ln = lane < B3_TILE && base + lane < n
                       ? b3_len(lens[base + lane], L) : -1;
    const int ch = b3_chunks(ln);
    int inc = ch;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(B3_FULL, inc, d);
      if (lane >= d) inc += y;
    }
    if (ch > 0) task[inc - ch] = lane;
    if (ch > 1) task[inc - 1] = lane | 256;
    if (lane < B3_TILE) slen[lane] = ln;
    if (lane == 31) ntask = inc;
  }
  __syncthreads();
  const uint8_t *ws = &wbuf[0][0];
  // the chains: group g runs task g
  int j = 0, c = 0, ln = 0, clen = 0, nb = 0, ncomp = 0;
  if (g < ntask) {
    const int tk = task[g];
    j = tk & 255;
    c = tk >> 8;
    ln = slen[j];
    b3_geom(c, ln, clen, nb, ncomp);
  }
  const int nbw = __reduce_max_sync(B3_FULL, nb);
  if (nbw > 0) {
    const uint8_t *row = msg + (int64_t)(base + j) * L + c * B3_CHUNK_LEN;
    const int o = (int)((uintptr_t)row & 15);
    const unsigned dst = (unsigned)__cvta_generic_to_shared(&slot[g][0]);
    uint32_t cvq = ivq, cvq4 = ivq4;
    b3_stage(row, dst, o, q, 0, clen);
#pragma unroll 1
    for (int b = 0; b < nbw; b++) {
      if (b + 1 < nbw)
        b3_stage(row, dst, o, q, b + 1, clen);
      else
        asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncwarp();
      if (b < nb) {
        uint32_t wq[4];
        b3_lane_words(wq, &slot[g][(b & 1) * B3_SLOT], o, q, b, clen);
        uint32_t *d = b < ncomp ? (uint32_t *)&wbuf[g][0] : &root[j][8];
        *(uint4 *)(d + 4 * q) = make_uint4(wq[0], wq[1], wq[2], wq[3]);
      }
      __syncwarp();
      uint32_t x[4];
      b3_lane_init(x, q, ivq, cvq, cvq4, (uint32_t)c, b3_blen(b, clen),
                   b3_flags(b, nb));
      b3_group_compress(x, ws, wa, q);
      if (b < ncomp) {
        cvq = x[0] ^ x[2];
        cvq4 = x[1] ^ x[3];
      }
    }
    if (nb > 0) b3_task_end(root[j], q, c, ln, nb, ivq, ivq4, cvq, cvq4);
  }
  __syncthreads();
  if (!XOF) {
    // the digests: group g runs message g's root compression
    if (g >= B3_TILE) return;
    const uint32_t *rs = root[g];
    *(uint4 *)&wbuf[g][16 * q] = *(const uint4 *)&rs[8 + 4 * q];
    __syncwarp();
    uint32_t x[4];
    b3_lane_init(x, q, ivq, rs[q], rs[4 + q], 0u, rs[24], rs[25] | B3_ROOT);
    b3_group_compress(x, ws, wa, q);
    if (base + g < n) {
      uint32_t *o = (uint32_t *)((uint8_t *)out + (int64_t)(base + g) * 32);
      o[q] = x[0] ^ x[2];
      o[4 + q] = x[1] ^ x[3];
    }
    return;
  }
  // the XOF: warp w runs messages 4w..4w+3, lane c output counter c
  uint8_t *st = stage[XOF ? w : 0];
#pragma unroll 1
  for (int s = 0; s < 4; s++) {
    const int m = 4 * w + s;
    if (base + m >= n) break;
    const uint32_t *rs = root[m];
    uint32_t cvw[8], mm[16], o16[16];
#pragma unroll
    for (int i = 0; i < 8; i++) cvw[i] = rs[i];
#pragma unroll
    for (int i = 0; i < 16; i++) mm[i] = rs[8 + i];
    b3_compress(cvw, mm, (uint32_t)lane, rs[24], rs[25] | B3_ROOT, o16);
    int32_t l[32];
    b3_xof_lanes(l, o16);
#pragma unroll
    for (int k = 0; k < 8; k++)
      *(int4 *)(st + lane * B3_STAGE + 16 * k) =
          make_int4(l[4 * k], l[4 * k + 1], l[4 * k + 2], l[4 * k + 3]);
    __syncwarp();
    int4 *o = (int4 *)((int32_t *)out + (int64_t)(base + m) * 1024);
#pragma unroll
    for (int k = 0; k < 8; k++) {
      const int qq = 32 * k + lane;
      o[qq] = *(const int4 *)(st + (qq >> 3) * B3_STAGE + 16 * (qq & 7));
    }
    __syncwarp();
  }
}

// msg (n, L <= 2048) uint8, lens (n,) int32 -> out (n, 32) uint8; device
// pointers; launches on `stream` and returns cudaGetLastError().
extern "C" int fdtt_blake3(const void *msg, long long L, const void *lens,
                           void *out, int n, void *stream) {
  if (n > 0)
    b3_kernel<false><<<(n + B3_TILE - 1) / B3_TILE, 128, 0,
                       (cudaStream_t)stream>>>(
        (const uint8_t *)msg, (int64_t)L, (const int32_t *)lens, out, n);
  return (int)cudaGetLastError();
}

// msg (n, L <= 2048) uint8, lens (n,) int32 -> out (n, 1024) int32 lanes
// (out 16-byte aligned); device pointers; launches on `stream` and
// returns cudaGetLastError().
extern "C" int fdtt_lthash(const void *msg, long long L, const void *lens,
                           void *out, int n, void *stream) {
  if (n > 0)
    b3_kernel<true><<<(n + B3_TILE - 1) / B3_TILE, 128, 0,
                      (cudaStream_t)stream>>>(
        (const uint8_t *)msg, (int64_t)L, (const int32_t *)lens, out, n);
  return (int)cudaGetLastError();
}
#else
// Host build. A group's four lanes run one after another, each step's
// values crossing as the kernel's shuffles carry them (b3_xoff), with the
// kernel's G function, word order and lane start.

// one compression on a group: cv[q], cv[4 + q] of each lane q updated
// to the first 8 output words; w the block's 16 words
static void b3_group_compress_lanes(uint32_t cv[8], const uint32_t w[16],
                                    uint32_t ctr, uint32_t blen,
                                    uint32_t flags) {
  uint32_t x[4][4], y[4][4];
  for (int q = 0; q < 4; q++)
    b3_lane_init(x[q], q, kB3Iv[q], cv[q], cv[4 + q], ctr, blen, flags);
  for (int r = 0; r < 7; r++) {
    for (int e = 0; e < 2; e++) {
      for (int q = 0; q < 4; q++)
        b3_g(x[q], w[b3_word(r, e, q, 0)], w[b3_word(r, e, q, 1)]);
      memcpy(y, x, sizeof(x));
      for (int q = 0; q < 4; q++)
        for (int s = 0; s < 4; s++)
          if (s != 1) x[q][s] = y[(q + b3_xoff(e, s)) & 3][s];
    }
  }
  for (int q = 0; q < 4; q++) {
    cv[q] = x[q][0] ^ x[q][2];
    cv[4 + q] = x[q][1] ^ x[q][3];
  }
}

// block b of chunk `cs` (a row's chunk start, its address mod 16 = o) as
// a group stages it: the live pieces copied into a slot whose other bytes
// are garbage, each lane's four words formed from it
static void b3_stage_words(uint32_t w[16], const uint8_t *cs, int b,
                           int clen) {
  const int o = (int)((uintptr_t)cs & 15);
  alignas(16) uint8_t sl[B3_SLOT];
  memset(sl, 0xa5, sizeof(sl));
  for (int p = 0; p < 5; p++)
    if (b3_piece_live(p, o, b, clen))
      memcpy(sl + 16 * p, cs + b * B3_BLOCK_LEN + 16 * p - o, 16);
  for (int q = 0; q < 4; q++) b3_lane_words(w + 4 * q, sl, o, q, b, clen);
}

// The kernel's block for the tile of messages base..base+B3_TILE-1 of n:
// the task table, each task's chain on its group, then the digests (xof
// 0) or the lthash lanes (xof 1) of the tile's messages.
static void b3_tile(const uint8_t *msg, int64_t L, const int32_t *lens,
                    int n, int base, int xof, void *out) {
  int slen[B3_TILE], task[B3_GROUPS], ntask = 0;
  for (int j = 0; j < B3_TILE; j++) {
    slen[j] = base + j < n ? b3_len(lens[base + j], L) : -1;
    for (int c = 0; c < b3_chunks(slen[j]); c++) task[ntask++] = j | c << 8;
  }
  uint32_t root[B3_TILE][B3_RS];
  memset(root, 0x5a, sizeof(root));
  for (int g = 0; g < ntask; g++) {
    const int j = task[g] & 255, c = task[g] >> 8, ln = slen[j];
    int clen, nb, ncomp;
    b3_geom(c, ln, clen, nb, ncomp);
    const uint8_t *cs = msg + (int64_t)(base + j) * L + c * B3_CHUNK_LEN;
    uint32_t cv[8];
    memcpy(cv, kB3Iv, sizeof(cv));
    for (int b = 0; b < nb; b++) {
      uint32_t w[16];
      b3_stage_words(w, cs, b, clen);
      if (b < ncomp)
        b3_group_compress_lanes(cv, w, (uint32_t)c, b3_blen(b, clen),
                                b3_flags(b, nb));
      else
        memcpy(&root[j][8], w, sizeof(w));
    }
    for (int q = 0; q < 4; q++)
      b3_task_end(root[j], q, c, ln, nb, kB3Iv[q], kB3Iv[4 + q], cv[q],
                  cv[4 + q]);
  }
  for (int j = 0; j < B3_TILE && base + j < n; j++) {
    const uint32_t *rs = root[j];
    if (!xof) {
      uint32_t cv[8];
      memcpy(cv, rs, sizeof(cv));
      b3_group_compress_lanes(cv, rs + 8, 0u, rs[24], rs[25] | B3_ROOT);
      memcpy((uint8_t *)out + (int64_t)(base + j) * 32, cv, 32);
      continue;
    }
    for (uint32_t ctr = 0; ctr < 32; ctr++) {
      uint32_t mm[16], o16[16];
      memcpy(mm, rs + 8, sizeof(mm));
      b3_compress(rs, mm, ctr, rs[24], rs[25] | B3_ROOT, o16);
      b3_xof_lanes((int32_t *)out + (int64_t)(base + j) * 1024 + 32 * ctr,
                   o16);
    }
  }
}

// message i of either entry, as a tile of its own (the kernel's one path
// serves every alignment: `aligned` is not read)
extern "C" void blake3_lane_host(const uint8_t *msg, int64_t L,
                                 const int32_t *lens, uint8_t *out,
                                 int aligned, int i) {
  (void)aligned;
  b3_tile(msg, L, lens, i + 1, i, 0, out);
}

extern "C" void lthash_lane_host(const uint8_t *msg, int64_t L,
                                 const int32_t *lens, int32_t *out,
                                 int aligned, int i) {
  (void)aligned;
  b3_tile(msg, L, lens, i + 1, i, 1, out);
}

// the messages of a block (a tile)
extern "C" int b3_tile_messages_host(void) { return B3_TILE; }

// the kernel's block at tile `base` of a batch of n messages
extern "C" void b3_tile_host(const uint8_t *msg, int64_t L,
                             const int32_t *lens, void *out, int n, int base,
                             int xof) {
  b3_tile(msg, L, lens, n, base, xof, out);
}

// one compression on a group, the lanes stepped together: cv (8 words)
// updated to the first 8 output words
extern "C" void b3_group_compress_host(uint32_t cv[8], const uint32_t m[16],
                                       uint32_t ctr, uint32_t blen,
                                       uint32_t flags) {
  b3_group_compress_lanes(cv, m, ctr, blen, flags);
}

// the 16 words of block b of chunk c of a row (at its real address) of n
// bytes, staged as a group stages it
extern "C" void b3_stage_host(const uint8_t *row, int n, int c, int b,
                              uint32_t w[16]) {
  int clen, nb, ncomp;
  b3_geom(c, n, clen, nb, ncomp);
  b3_stage_words(w, row + c * B3_CHUNK_LEN, b, clen);
}
#endif

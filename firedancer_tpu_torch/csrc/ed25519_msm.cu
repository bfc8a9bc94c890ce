// RLC batch verification as one multi-scalar multiplication: two kernels,
// stage 1 with a group of four threads per signature, stage 2 with one
// block a window and its tail on a group.
//
// Replaces the Pallas kernels firedancer_tpu/ops/pallas_msm.py
// `_msm_stage1_kernel` and `_msm_stage2_kernel`, and the scalar glue
// around them (pallas_msm.py:307-327). Together they test
//
//   sum_i ( [zk_i](-A_i) + [z_i](-R_i) ) + [s]B == identity,
//   zk_i = z_i k_i mod l,  s = sum_i z_i S_i mod l,
//
// which is sum_i z_i ([S_i]B - [k_i]A_i - R_i) == identity, over the
// lanes that pass lane_ok: S < l, A.y < p, R.y < p, A and R not
// small-order encodings, A and R decompress. z counts as zero elsewhere.
//
// Stage 1 (a grid of blocks of MSM_L lanes, four threads a lane): per
// lane the prechecks, k = k64 mod l, zk = z k mod l and zs = z S mod l;
// A and R decompressed on one thread each (the block's first 2 MSM_L
// threads) and handed over in shared memory to threads 0 and 2 of the
// group (A) and 1 and 3 (R); tables of w(-A), extended, and w(-R),
// precomputed, w = 0..15,
// built with the group's point code (ed25519_common.cuh), component c on
// thread c. The windows are then summed over the block's lanes without a
// tree: in passes of MSM_W windows every group writes its lane's
// contributions [zk_j](-A) + [z_j](-R) to shared memory; group g then sums
// window g / MSM_C of the pass over the MSM_S lanes of chunk g % MSM_C,
// one add after another, into a partial in shared memory; after the last
// pass group g sums window g's MSM_C partials. Every group adds at every
// step; two barriers per pass. Out: lane_ok, the block's 64 window sums,
// and the block's column sums of zs's thirteen 21-bit digits over its
// lane_ok lanes (sdig, int64, each below 2^27).
//
// Stage 2 (a grid of 64 blocks of 128 threads, block j for window j):
// window j summed over the stage-1 blocks in chunks (msm_chunk_sum: C
// chunks of S blocks, S^2 >= nblk, one chunk a group, then the chunk sums
// in order), its total written to a scratch; the last block to finish
// takes the tail: warp 0 runs the Horner over the 64 totals on a group of
// four (252 doublings, 63 adds), while one thread of warp 1 sums sdig over
// the blocks, carries and folds it with sc_reduce64 into s and sums the
// fixed-base terms table[j][s_j] (64 adds and no doubling: row j of the
// table carries the factor 16^j); then one add and the identity test X =
// 0, Y = Z on canonical limbs. One launch, not two: the tail starts as
// the last window total lands, with no second launch's gap.
//
// What differs from the TPU kernels: the TPU merge-folds the windows into
// bit-reversed lanes and runs a fold-Horner because pltpu.roll needs
// power-of-two distances on a 128-lane vector unit. On Hopper blocks run
// in no order and carry nothing between them, so stage 1 sums inside each
// block in shared memory and stage 2 sums the blocks' results; the Horner
// is written as the plain reference (ops/ed25519.py of the JAX package)
// writes it.
//
// What bounds it on the H100: integer multiply-adds (field multiplies of
// 100 IMAD.WIDE each). Stage 1 runs 8 warps a block and one block an SM
// (163,840 B of dynamic shared memory): every step has a multiply chain a
// quarter as long as one thread's, and the sums over lanes keep every
// group busy. Stage 2 is a fixed cost per batch, latency bound: its chain
// is the block sums ((S - 1) + (C - 1) adds of 3 rounds) and the Horner
// (693 rounds of one field multiply a thread), so the design shortens
// each round (four threads, not one) and spreads the block sums over 64
// SMs.
//
// Plain PyTorch versions: ops/msm.py `msm_stage1` and `msm_stage2`, which
// perform the same limb operations in the same order on int64 tensors.
// Field, scalar and point code: csrc/ed25519_common.cuh.
#include "ed25519_common.cuh"

#define MSM_L 64          // lanes per stage-1 block (ops/msm.py LANES)
#define MSM_S 8           // lanes per chunk of a window's first sum
#define MSM_C (MSM_L / MSM_S)   // chunks per window
#define MSM_W 8           // windows per pass
static_assert(MSM_W * MSM_C == MSM_L, "one group per (window, chunk)");
// contributions (MSM_W, MSM_L) and partials (64, MSM_C), 4 coordinates each
#define MSM_SMEM ((MSM_W * MSM_L + 64 * MSM_C) * 4 * (int)sizeof(fe))

FD_DEV void ge_store(i32 *o, const ge &p) {
#pragma unroll
  for (int i = 0; i < 10; i++) {
    o[i] = p.X.v[i];
    o[10 + i] = p.Y.v[i];
    o[20 + i] = p.Z.v[i];
    o[30 + i] = p.T.v[i];
  }
}

// ---- stage 1, per lane (msm.lane_part) -----------------------------------

struct msm_lane {
  g4v<fe> a[16];          // w(-A), extended, coordinate c on thread c
  g4v<fe> r[16];          // w(-R), precomputed, component c on thread c
  uint64_t k[4];          // k = k64 mod l
  uint64_t zk[4];         // z k mod l: 64 windows
  uint64_t zs[4];         // z S mod l: the digits of s
  uint64_t z[2];          // z: 32 windows (windows 32..63 are zero)
  bool pre, a_ok, r_ok, ok;
};

// the prechecks and the scalars, on every thread of the group
FD_DEV void msm_lane_scalars(msm_lane &L, const uint8_t *pub,
                             const uint8_t *sig, const uint8_t *k64,
                             const uint8_t *z) {
  uint64_t aw[4], rw[4], sw[4], hw[8];
  load_words(aw, pub, 4);
  load_words(rw, sig, 4);
  load_words(sw, sig + 32, 4);
  load_words(hw, k64, 8);
  load_words(L.z, z, 2);
  L.pre = strict_prechecks(sw, aw, rw) && words_lt(rw, FE_P, true);
  sc_reduce64(L.k, hw);
  sc_mul_mod_l(L.zk, L.k, L.z);
  sc_mul_mod_l(L.zs, sw, L.z);
}

// the tables, from A decompressed as (x, y, t) with verdict dec on
// threads 0 and 2 of the group and R on threads 1 and 3
FD_DEV void msm_lane_tables(msm_lane &L, const g4v<fe> &x, const g4v<fe> &y,
                            const g4v<fe> &t, const g4v<i32> &dec) {
  g4v<fe> q;
  g4pt cur;
  L.a_ok = g4_get_i(dec, 0) != 0;
  L.r_ok = g4_get_i(dec, 1) != 0;
  L.ok = L.pre && L.a_ok && L.r_ok;
  g4_neg_start(cur, q, x, y, t, 0);
  g4_identity(L.a[0]);
  L.a[1] = cur;
#pragma unroll 1
  for (int w = 2; w < 16; w++) {
    g4_madd_aff(cur, q);
    L.a[w] = cur;
  }
  g4_neg_start(cur, q, x, y, t, 1);
  g4_pre_identity(L.r[0]);
  g4_to_pre(L.r[1], cur);
#pragma unroll 1
  for (int w = 2; w < 16; w++) {
    g4_madd_aff(cur, q);
    g4_to_pre(L.r[w], cur);
  }
}

// window j's contribution [zk_j](-A) + [z_j](-R); the identity when the
// lane is not ok (computed all the same: the group's shuffles need every
// thread)
FD_DEV void msm_lane_window(g4pt &o, const msm_lane &L, int j) {
  g4pt id;
  o = L.a[nibble(L.zk, j)];
  g4_add_pre(o, L.r[j < 32 ? nibble(L.z, j) : 0]);
  g4_identity(id);
  g4_each([&](int c) { fe_cmov(o[c], id[c], !L.ok); });
}

// ---- stage 2 (msm.msm_stage2) --------------------------------------------

// Stage 2 sums window j over the nblk stage-1 blocks in C chunks of S
// consecutive blocks (S = msm_chunk(nblk), the least S with S^2 >= nblk,
// C = ceil(nblk / S)): each chunk in block order, then the C chunk sums
// in chunk order: 11 + 10 dependent adds at 8192 lanes (128 blocks).
static int msm_chunk(int nblk) {
  int s = 1;
  while (s * s < nblk) s++;
  return s;
}

// coordinate c of window j's sum in stage-1 block b, on thread c
FD_DEV void wsum_get(g4pt &q, const i32 *wsum, int b, int j) {
  g4_each([&](int c) {
    const i32 *s = wsum + (((int64_t)b * 64 + j) * 4 + c) * 10;
#pragma unroll
    for (int i = 0; i < 10; i++) q[c].v[i] = s[i];
  });
}

// chunk k of window j: blocks k S .. min(k S + S, nblk) - 1 in block
// order. Every group runs S - 1 steps (the group's shuffles need the
// whole warp): a step past the last block adds a repeated block and
// keeps acc. The next block's loads are issued before each add.
FD_DEV void msm_chunk_sum(g4pt &acc, const i32 *wsum, int nblk, int S,
                          int k, int j) {
  const int b0 = k * S, last = nblk - 1;
  g4pt q, qn, t;
  wsum_get(acc, wsum, b0 < last ? b0 : last, j);
  wsum_get(q, wsum, b0 + 1 < last ? b0 + 1 : last, j);
#pragma unroll 1
  for (int i = 1; i < S; i++) {
    wsum_get(qn, wsum, b0 + i + 1 < last ? b0 + i + 1 : last, j);
    t = acc;
    g4_add_full(t, q);
    const bool in = b0 + i < nblk;
    g4_each([&](int c) { fe_cmov(acc[c], t[c], in); });
    q = qn;
  }
}

// the window total from the C chunk sums cs[k][c], in chunk order
FD_DEV void msm_chunks_total(g4pt &tot, const fe *cs, int C) {
  g4pt q;
  g4_each([&](int c) { tot[c] = cs[c]; });
#pragma unroll 1
  for (int k = 1; k < C; k++) {
    g4_each([&](int c) { q[c] = cs[k * 4 + c]; });
    g4_add_full(tot, q);
  }
}

// s = (sum over the blocks of sdig) mod l: digit sums, carried to 25
// 21-bit digits, folded by sc_reduce64 (ed25519.sc_reduce_digits)
FD_DEV void msm_scalar_s(uint64_t s[4], const i64 *sdig, int nblk) {
  i64 d[25];
  uint64_t w[8];
#pragma unroll
  for (int i = 0; i < 25; i++) d[i] = 0;
#pragma unroll 1
  for (int g = 0; g < nblk; g++)
#pragma unroll
    for (int i = 0; i < 13; i++) d[i] += sdig[(int64_t)g * 13 + i];
  sc_carry21(d, 0, 24);
  sc_pack(w, 8, d, 25);
  sc_reduce64(s, w);
}

// h = sum_j 16^j W[j] over the window totals W[j][c], msb-first, on the
// group: 4 doublings (2 rounds each) and one add (3 rounds) a window, 693
// rounds of one field multiply a thread in all
FD_DEV void g4_horner(g4pt &h, const fe *W) {
  g4pt q;
  g4_each([&](int c) { h[c] = W[63 * 4 + c]; });
#pragma unroll 1
  for (int j = 62; j >= 0; j--) {
    g4_dbl(h, false);
    g4_dbl(h, false);
    g4_dbl(h, false);
    g4_dbl(h, true);
    g4_each([&](int c) { q[c] = W[j * 4 + c]; });
    g4_add_full(h, q);
  }
}

// f = [s]B = sum_j table[j][s_j], doubling-free
FD_NOINLINE void msm_fixed_base(ge &f, const uint64_t sw[4], const i32 *fb) {
  pre_aff q;
  ge_identity(f);
#pragma unroll 1
  for (int j = 0; j < 64; j++) {
    fb_entry(q, fb, j, nibble(sw, j));
    ge_madd_aff(f, q);
  }
}

// out[0] = (h + f == identity); out[1..40] = canonical limbs of h + f
FD_DEV void msm_finish(i32 *out, ge &h, const ge &f) {
  fe t;
  ge c;
  ge_add_full(h, f);
  fe_sub(t, h.Y, h.Z);
  out[0] = (fe_is_zero(h.X) && fe_is_zero(t)) ? 1 : 0;
  fe_canon(c.X, h.X);
  fe_canon(c.Y, h.Y);
  fe_canon(c.Z, h.Z);
  fe_canon(c.T, h.T);
  ge_store(out + 1, c);
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(MSM_L * 4, 1)
msm_stage1_kernel(const uint8_t *__restrict__ pub,
                  const uint8_t *__restrict__ sig,
                  const uint8_t *__restrict__ k64,
                  const uint8_t *__restrict__ z, i32 *__restrict__ wsum,
                  i32 *__restrict__ lane_ok, i64 *__restrict__ sdig, int n) {
  extern __shared__ fe smem[];
  fe *cb = smem;                        // [MSM_W][MSM_L][4] contributions
  fe *pb = smem + MSM_W * MSM_L * 4;    // [64][MSM_C][4] partials
  __shared__ unsigned long long sd[13];
  __shared__ int sok[2 * MSM_L];
  const int tid = threadIdx.x, g = tid >> 2, c = tid & 3;
  const int lane0 = blockIdx.x * MSM_L + g;
  const int lane = lane0 < n ? lane0 : n - 1;   // the ragged edge
  if (tid < 13) sd[tid] = 0;
  // decompression on one thread a point (threads < MSM_L: A of lane tid,
  // the next MSM_L: R of lane tid - MSM_L), into the contributions'
  // space before the passes use it
  if (tid < 2 * MSM_L) {
    const int q = blockIdx.x * MSM_L + tid % MSM_L;
    const int ql = q < n ? q : n - 1;
    sok[tid] = ge_decompress(cb[tid], cb[2 * MSM_L + tid],
                             cb[4 * MSM_L + tid],
                             tid < MSM_L ? pub + (int64_t)ql * 32
                                         : sig + (int64_t)ql * 64);
  }
  msm_lane L;
  msm_lane_scalars(L, pub + (int64_t)lane * 32, sig + (int64_t)lane * 64,
                   k64 + (int64_t)lane * 64, z + (int64_t)lane * 16);
  __syncthreads();
  {
    const int src = (c & 1) * MSM_L + g;   // A on threads 0 and 2, R on 1, 3
    g4v<fe> x, y, t;
    g4v<i32> dec;
    x.v = cb[src];
    y.v = cb[2 * MSM_L + src];
    t.v = cb[4 * MSM_L + src];
    dec.v = sok[src];
    __syncthreads();
    msm_lane_tables(L, x, y, t, dec);
  }
  if (lane0 >= n) L.ok = false;         // contributes the identity
  if (c == 0) {
    if (lane0 < n) lane_ok[lane0] = L.ok ? 1 : 0;
    if (L.ok)
      for (int d = 0; d < 13; d++)
        atomicAdd(&sd[d], (unsigned long long)sc_digit(L.zs, 4, d, d == 12));
  }
  const int cw = g / MSM_C, ck = g % MSM_C;    // this group's (window, chunk)
#pragma unroll 1
  for (int p = 0; p < 64 / MSM_W; p++) {
#pragma unroll 1
    for (int w = 0; w < MSM_W; w++) {
      g4pt o;
      msm_lane_window(o, L, p * MSM_W + w);
      cb[(w * MSM_L + g) * 4 + c] = o.v;
    }
    __syncthreads();
    g4pt acc, q;
    acc.v = cb[(cw * MSM_L + ck * MSM_S) * 4 + c];
#pragma unroll 1
    for (int i = 1; i < MSM_S; i++) {
      q.v = cb[(cw * MSM_L + ck * MSM_S + i) * 4 + c];
      g4_add_full(acc, q);
    }
    pb[((p * MSM_W + cw) * MSM_C + ck) * 4 + c] = acc.v;
    __syncthreads();
  }
  g4pt acc, q;                          // group g: window g's partials
  acc.v = pb[(g * MSM_C) * 4 + c];
#pragma unroll 1
  for (int k = 1; k < MSM_C; k++) {
    q.v = pb[(g * MSM_C + k) * 4 + c];
    g4_add_full(acc, q);
  }
  i32 *o = wsum + (((int64_t)blockIdx.x * 64 + g) * 4 + c) * 10;
#pragma unroll
  for (int i = 0; i < 10; i++) o[i] = acc.v.v[i];
  if (tid < 13) sdig[(int64_t)blockIdx.x * 13 + tid] = (i64)sd[tid];
}

#define S2_T 128      // threads of a stage-2 block: 32 groups
#define S2_TOT (64 * 4 * 10)   // the window totals in the scratch, int32

// One block per window j (grid 64): the groups sum the window's chunks
// (msm_chunk_sum) into shared memory, warp 0 sums the chunk sums and
// group 0 writes the total to the scratch. The last block to finish (a
// ticket taken after __threadfence) runs the tail: warp 0 the Horner on a
// group, warp 1's first thread s and the fixed base meanwhile, then one
// add and the identity test.
__global__ void __launch_bounds__(S2_T)
msm_stage2_kernel(const i32 *__restrict__ wsum, int nblk, int S, int C,
                  const i64 *__restrict__ sdig, const i32 *__restrict__ fb,
                  i32 *tot, unsigned *ticket, i32 *__restrict__ out) {
  extern __shared__ fe cs[];          // [C][4] the window's chunk sums
  __shared__ fe W[64 * 4], H[4];      // the tail: totals, the Horner's h
  __shared__ ge F;                    // the tail: [s]B
  __shared__ int last;
  const int tid = threadIdx.x, g = tid >> 2, c = tid & 3, j = blockIdx.x;
#pragma unroll 1
  for (int k0 = 0; k0 < C; k0 += S2_T / 4) {
    const int k = k0 + g;
    g4pt acc;
    msm_chunk_sum(acc, wsum, nblk, S, k < C ? k : C - 1, j);
    if (k < C) cs[k * 4 + c] = acc.v;
  }
  __syncthreads();
  if (tid < 32) {                     // every group of warp 0 alike
    g4pt t;
    msm_chunks_total(t, cs, C);
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < 10; i++) tot[(j * 4 + c) * 10 + i] = t.v.v[i];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < S2_TOT; i += S2_T) ((i32 *)W)[i] = __ldcg(tot + i);
  __syncthreads();
  if (tid < 32) {
    g4pt h;
    g4_horner(h, W);
    if (g == 0) H[c] = h.v;
  } else if (tid == 32) {
    uint64_t sw[4];
    ge f;
    msm_scalar_s(sw, sdig, nblk);
    msm_fixed_base(f, sw, fb);
    F = f;
  }
  __syncthreads();
  if (tid == 0) {
    ge h = {H[0], H[1], H[2], H[3]};
    const ge f = F;
    msm_finish(out, h, f);
  }
}

// pub (n, 32), sig (n, 64), k64 (n, 64), z (n, 16) uint8 -> wsum
// (ceil(n / 64), 64, 4, 10) int32, lane_ok (n,) int32, sdig
// (ceil(n / 64), 13) int64; device pointers; launches on `stream` and
// returns the first CUDA error.
extern "C" int fdtt_msm_stage1(const void *pub, const void *sig,
                               const void *k64, const void *z, void *wsum,
                               void *lane_ok, void *sdig, int n,
                               void *stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      msm_stage1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MSM_SMEM);
  if (e != cudaSuccess) return (int)e;
  if (n > 0)
    msm_stage1_kernel<<<(n + MSM_L - 1) / MSM_L, MSM_L * 4, MSM_SMEM,
                        (cudaStream_t)stream>>>(
        (const uint8_t *)pub, (const uint8_t *)sig, (const uint8_t *)k64,
        (const uint8_t *)z, (i32 *)wsum, (i32 *)lane_ok, (i64 *)sdig, n);
  return (int)cudaGetLastError();
}

// wsum (nblk, 64, 4, 10) int32, sdig (nblk, 13) int64, fb (64, 16, 3, 10)
// int32 -> out (41,) int32; scratch (S2_TOT + 1,) int32 holds the window
// totals and the ticket, which is zeroed here on `stream`. Grid: one block
// a window.
extern "C" int fdtt_msm_stage2(const void *wsum, int nblk, const void *sdig,
                               const void *fb, void *scratch, void *out,
                               void *stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int S = msm_chunk(nblk), C = (nblk + S - 1) / S;
  const int smem = C * 4 * (int)sizeof(fe);
  i32 *tot = (i32 *)scratch;
  cudaError_t e = cudaFuncSetAttribute(
      msm_stage2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(tot + S2_TOT, 0, sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  msm_stage2_kernel<<<64, S2_T, smem, st>>>(
      (const i32 *)wsum, nblk, S, C, (const i64 *)sdig, (const i32 *)fb, tot,
      (unsigned *)(tot + S2_TOT), (i32 *)out);
  return (int)cudaGetLastError();
}
#else
#include <vector>

// Host build: stage 1's per-lane part for one lane, the group's four
// threads in turn (flags = pre, a_ok, r_ok, ok; scal = k, zk, zs as 32
// LE bytes each; contrib = the 64 window contributions, (64, 4, 10)),
// and stage 2 with its threads run one after another.
static void store_words(uint8_t *o, const uint64_t w[4]) {
  for (int b = 0; b < 32; b++) o[b] = (uint8_t)(w[b >> 3] >> (8 * (b & 7)));
}

// the whole per-lane setup on the group (the kernel decompresses on one
// thread a point instead; the arithmetic is the same)
FD_DEV void msm_lane_setup(msm_lane &L, const uint8_t *pub,
                           const uint8_t *sig, const uint8_t *k64,
                           const uint8_t *z) {
  g4v<fe> x, y, t;
  g4v<i32> dec;
  msm_lane_scalars(L, pub, sig, k64, z);
  g4_each([&](int c) {
    dec[c] = ge_decompress(x[c], y[c], t[c], (c & 1) ? sig : pub);
  });
  msm_lane_tables(L, x, y, t, dec);
}

extern "C" void msm_lane_host(const uint8_t *pub, const uint8_t *sig,
                              const uint8_t *k64, const uint8_t *z, int lane,
                              i32 *flags, uint8_t *scal, i32 *contrib) {
  msm_lane L;
  msm_lane_setup(L, pub + (int64_t)lane * 32, sig + (int64_t)lane * 64,
                 k64 + (int64_t)lane * 64, z + (int64_t)lane * 16);
  flags[0] = L.pre;
  flags[1] = L.a_ok;
  flags[2] = L.r_ok;
  flags[3] = L.ok;
  store_words(scal, L.k);
  store_words(scal + 32, L.zk);
  store_words(scal + 64, L.zs);
  for (int j = 0; j < 64; j++) {
    g4pt o;
    msm_lane_window(o, L, j);
    for (int c = 0; c < 4; c++)
      for (int i = 0; i < 10; i++) contrib[(j * 4 + c) * 10 + i] = o[c].v[i];
  }
}

// the small-order table of the prechecks, (N_SMALL_ORDER, 32) bytes
extern "C" int small_order_host(uint8_t *out) {
  for (int i = 0; i < N_SMALL_ORDER; i++) store_words(out + 32 * i,
                                                      SMALL_ORDER[i]);
  return N_SMALL_ORDER;
}

// stage 2: every window's chunks and their sum, then the Horner, each
// group's four threads in turn
extern "C" void msm_stage2_host(const i32 *wsum, int nblk, const i64 *sdig,
                                const i32 *fb, i32 *out) {
  const int S = msm_chunk(nblk), C = (nblk + S - 1) / S;
  std::vector<fe> cs(C * 4), W(64 * 4);
  for (int j = 0; j < 64; j++) {
    g4pt t;
    for (int k = 0; k < C; k++) {
      msm_chunk_sum(t, wsum, nblk, S, k, j);
      for (int c = 0; c < 4; c++) cs[k * 4 + c] = t[c];
    }
    msm_chunks_total(t, cs.data(), C);
    for (int c = 0; c < 4; c++) W[j * 4 + c] = t[c];
  }
  g4pt hg;
  g4_horner(hg, W.data());
  ge h = {hg[0], hg[1], hg[2], hg[3]}, f;
  uint64_t sw[4];
  msm_scalar_s(sw, sdig, nblk);
  msm_fixed_base(f, sw, fb);
  msm_finish(out, h, f);
}
#endif

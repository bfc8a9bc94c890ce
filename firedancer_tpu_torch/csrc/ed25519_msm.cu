// RLC batch verification as one multi-scalar multiplication: two kernels,
// stage 1 with one thread per signature, stage 2 in one block.
//
// Replaces the Pallas kernels firedancer_tpu/ops/pallas_msm.py
// `_msm_stage1_kernel` and `_msm_stage2_kernel`. Together they test
//
//   sum_i ( [zk_i](-A_i) + [z_i](-R_i) ) + [s]B == identity,
//   zk_i = z_i k_i mod l,  s = sum_i z_i S_i mod l,
//
// which is sum_i z_i ([S_i]B - [k_i]A_i - R_i) == identity. The scalars
// (k = SHA-512(R || A || M) mod l, z k, the lane sum s, the lane masks)
// are the glue's, ops/ed25519.py `rlc_verify`, as they were outside the
// Pallas kernels.
//
// Stage 1 (a grid of blocks of MSM_T lanes): decompress A and R (a lane
// that fails, or that the glue masked, contributes the identity and
// reports 0 in lane_ok); build per-lane tables of w(-A), extended, and
// w(-R), precomputed, w = 0..15, in local memory; then for each of the 64
// 4-bit windows j each thread forms its contribution
// [zk_j](-A) + [z_j](-R) with one add, and the block sums the MSM_T
// contributions in shared memory (a 6-level tree over MSM_T x 160 B).
// One thread writes the block's sum of window j: out (blocks, 64) points.
//
// Stage 2 (one block of 64 threads): thread j sums window j over the
// blocks; then thread 0 runs the Horner over the 64 window sums (252
// doublings, 63 adds) while thread 32, in another warp, sums the
// fixed-base terms table[j][s_j] (64 adds and no doubling: row j of the
// table carries the factor 16^j); then one add and the identity test
// X = 0, Y = Z on canonical limbs.
//
// What differs from the TPU kernels: the TPU merge-folds the windows into
// bit-reversed lanes and runs a fold-Horner because pltpu.roll needs
// power-of-two distances on a 128-lane vector unit. On Hopper blocks run
// in no order and carry nothing between them, so stage 1 reduces inside
// each block in shared memory and stage 2 sums the blocks' results; the
// Horner is written as the plain reference (ops/ed25519.py of the JAX
// package) writes it.
//
// What bounds it on the H100: integer multiply-adds (field multiplies of
// 100 IMAD.WIDE each). Stage 1 keeps two warps per block, and each
// window's tree is 6 dependent adds: latency bound, as the strict kernel
// is. Stage 2 is a fixed cost per batch whose tail (about 2,600 field
// multiplies of the Horner) runs on one thread: latency bound. Both are
// first versions, correct and simple.
//
// Plain PyTorch versions: ops/msm.py `msm_stage1` and `msm_stage2`, which
// perform the same limb operations in the same order on int64 tensors.
// Field, scalar and point code: csrc/ed25519_common.cuh.
#include "ed25519_common.cuh"

#define MSM_T 64          // lanes per stage-1 block (ops/msm.py LANES)

FD_DEV void ge_store(i32 *o, const ge &p) {
#pragma unroll
  for (int i = 0; i < 10; i++) {
    o[i] = p.X.v[i];
    o[10 + i] = p.Y.v[i];
    o[20 + i] = p.Z.v[i];
    o[30 + i] = p.T.v[i];
  }
}

FD_DEV void ge_load(ge &p, const i32 *o) {
#pragma unroll
  for (int i = 0; i < 10; i++) {
    p.X.v[i] = o[i];
    p.Y.v[i] = o[10 + i];
    p.Z.v[i] = o[20 + i];
    p.T.v[i] = o[30 + i];
  }
}

// ---- stage 1, per lane (msm.lane_contributions) --------------------------

struct msm_lane {
  ge a[16];               // w(-A), extended
  pre_proj r[16];         // w(-R), precomputed
  uint64_t kw[4];         // zk: 64 windows
  uint64_t zw[2];         // z: 32 windows (windows 32..63 are zero)
  bool a_ok, r_ok, ok;
};

FD_NOINLINE void msm_lane_setup(msm_lane &L, const uint8_t *pub,
                                const uint8_t *sig, const uint8_t *zk,
                                const uint8_t *z, i32 mask) {
  fe x, y, t;
  ge cur;
  pre_aff q;
  load_words(L.kw, zk, 4);
  load_words(L.zw, z, 2);
  L.a_ok = ge_decompress(x, y, t, pub);
  ge_neg_start(cur, q, x, y, t);
  ge_identity(L.a[0]);
  L.a[1] = cur;
#pragma unroll 1
  for (int w = 2; w < 16; w++) {
    ge_madd_aff(cur, q);
    L.a[w] = cur;
  }
  L.r_ok = ge_decompress(x, y, t, sig);          // R: the first 32 bytes
  ge_neg_start(cur, q, x, y, t);
  pre_identity(L.r[0]);
  ge_to_pre(L.r[1], cur);
#pragma unroll 1
  for (int w = 2; w < 16; w++) {
    ge_madd_aff(cur, q);
    ge_to_pre(L.r[w], cur);
  }
  L.ok = mask != 0 && L.a_ok && L.r_ok;
}

// window j's contribution [zk_j](-A) + [z_j](-R); the identity when the
// lane is masked
FD_DEV void msm_lane_window(ge &c, const msm_lane &L, int j) {
  if (!L.ok) {
    ge_identity(c);
    return;
  }
  c = L.a[nibble(L.kw, j)];
  ge_add_pre(c, L.r[j < 32 ? nibble(L.zw, j) : 0]);
}

// ---- stage 2 (msm.msm_stage2) --------------------------------------------

// window j summed over the blocks, in block order
FD_DEV void msm_window_total(ge &acc, const i32 *wsum, int nblk, int j) {
  ge q;
  ge_load(acc, wsum + j * 40);
#pragma unroll 1
  for (int g = 1; g < nblk; g++) {
    ge_load(q, wsum + ((int64_t)g * 64 + j) * 40);
    ge_add_full(acc, q);
  }
}

// h = sum_j 16^j W[j]: msb-first, 4 doublings and one add per window
FD_NOINLINE void msm_horner(ge &h, const ge *W) {
  h = W[63];
#pragma unroll 1
  for (int j = 62; j >= 0; j--) {
    ge_dbl(h, false);
    ge_dbl(h, false);
    ge_dbl(h, false);
    ge_dbl(h, true);
    ge_add_full(h, W[j]);
  }
}

// f = [s]B = sum_j table[j][s_j], doubling-free
FD_NOINLINE void msm_fixed_base(ge &f, const uint8_t *s, const i32 *fb) {
  uint64_t sw[4];
  pre_aff q;
  load_words(sw, s, 4);
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
__global__ void __launch_bounds__(MSM_T)
msm_stage1_kernel(const uint8_t *__restrict__ pub,
                  const uint8_t *__restrict__ sig,
                  const uint8_t *__restrict__ zk,
                  const uint8_t *__restrict__ z,
                  const i32 *__restrict__ mask, i32 *__restrict__ wsum,
                  i32 *__restrict__ lane_ok, int n) {
  __shared__ ge sh[MSM_T];
  const int tid = threadIdx.x;
  const int lane = blockIdx.x * MSM_T + tid;
  msm_lane L;
  L.ok = false;                           // the ragged edge: identity
  if (lane < n) {
    msm_lane_setup(L, pub + (int64_t)lane * 32, sig + (int64_t)lane * 64,
                   zk + (int64_t)lane * 32, z + (int64_t)lane * 16,
                   mask[lane]);
    lane_ok[lane] = L.ok ? 1 : 0;
  }
  i32 *out = wsum + (int64_t)blockIdx.x * 64 * 40;
#pragma unroll 1
  for (int j = 0; j < 64; j++) {
    ge c;
    msm_lane_window(c, L, j);
    sh[tid] = c;
    __syncthreads();
#pragma unroll 1
    for (int s = MSM_T / 2; s > 0; s >>= 1) {
      if (tid < s) {
        ge p = sh[tid];
        ge_add_full(p, sh[tid + s]);
        sh[tid] = p;
      }
      __syncthreads();
    }
    if (tid == 0) ge_store(out + j * 40, sh[0]);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(64)
msm_stage2_kernel(const i32 *__restrict__ wsum, int nblk,
                  const uint8_t *__restrict__ s_sum,
                  const i32 *__restrict__ fb, i32 *__restrict__ out) {
  __shared__ ge W[64];
  __shared__ ge F;
  const int j = threadIdx.x;
  ge acc;
  msm_window_total(acc, wsum, nblk, j);
  W[j] = acc;
  __syncthreads();
  if (j == 32) {
    ge f;
    msm_fixed_base(f, s_sum, fb);
    F = f;
  }
  if (j == 0) msm_horner(acc, W);
  __syncthreads();
  if (j == 0) {
    const ge f = F;
    msm_finish(out, acc, f);
  }
}

// pub (n, 32), sig (n, 64), zk (n, 32), z (n, 16) uint8, mask (n,) int32
// -> wsum (ceil(n / 64), 64, 4, 10) int32, lane_ok (n,) int32; device
// pointers; launches on `stream` and returns cudaGetLastError().
extern "C" int fdtt_msm_stage1(const void *pub, const void *sig,
                               const void *zk, const void *z,
                               const void *mask, void *wsum, void *lane_ok,
                               int n, void *stream) {
  if (n > 0)
    msm_stage1_kernel<<<(n + MSM_T - 1) / MSM_T, MSM_T, 0,
                        (cudaStream_t)stream>>>(
        (const uint8_t *)pub, (const uint8_t *)sig, (const uint8_t *)zk,
        (const uint8_t *)z, (const i32 *)mask, (i32 *)wsum, (i32 *)lane_ok,
        n);
  return (int)cudaGetLastError();
}

// wsum (nblk, 64, 4, 10) int32, s_sum (32,) uint8, fb (64, 16, 3, 10)
// int32 -> out (41,) int32; one block.
extern "C" int fdtt_msm_stage2(const void *wsum, int nblk, const void *s_sum,
                               const void *fb, void *out, void *stream) {
  msm_stage2_kernel<<<1, 64, 0, (cudaStream_t)stream>>>(
      (const i32 *)wsum, nblk, (const uint8_t *)s_sum, (const i32 *)fb,
      (i32 *)out);
  return (int)cudaGetLastError();
}
#else
// Host build: stage 1's per-lane part for one lane (flags = a_ok, r_ok,
// ok; contrib = the 64 window contributions, (64, 4, 10)) and stage 2
// with its threads run one after another.
extern "C" void msm_lane_host(const uint8_t *pub, const uint8_t *sig,
                              const uint8_t *zk, const uint8_t *z,
                              const i32 *mask, int lane, i32 *flags,
                              i32 *contrib) {
  msm_lane L;
  msm_lane_setup(L, pub + (int64_t)lane * 32, sig + (int64_t)lane * 64,
                 zk + (int64_t)lane * 32, z + (int64_t)lane * 16,
                 mask[lane]);
  flags[0] = L.a_ok;
  flags[1] = L.r_ok;
  flags[2] = L.ok;
  for (int j = 0; j < 64; j++) {
    ge c;
    msm_lane_window(c, L, j);
    ge_store(contrib + j * 40, c);
  }
}

extern "C" void msm_stage2_host(const i32 *wsum, int nblk,
                                const uint8_t *s_sum, const i32 *fb,
                                i32 *out) {
  ge W[64], h, f;
  for (int j = 0; j < 64; j++) msm_window_total(W[j], wsum, nblk, j);
  msm_horner(h, W);
  msm_fixed_base(f, s_sum, fb);
  msm_finish(out, h, f);
}
#endif

// Fused strict ed25519 verify core, one signature on a group of four
// threads.
//
// Replaces the Pallas kernel firedancer_tpu/ops/pallas_ed.py
// `_verify_kernel` (body `_verify_core`): k = k64 mod l, RFC 8032
// decompression of A, R' = [S]B + [k](-A) over 64 msb-first 4-bit
// windows, one inversion, and the canonical compare of R' with R. The
// glue (S < l, A.y < p, small-order A and R, SHA-512) stays outside, in
// ops/cuda_ed.py, as it does on the TPU.
//
// Design, and what differs from the TPU kernel:
//  * Field elements are 10 int32 limbs in radix 2^25.5 with int64
//    product sums (Hopper has 32x32->64 multiplies), not the TPU's
//    20 x radix-2^13 int32 limbs with the wrap-tolerant _reduce39 and
//    pltpu.roll products. Every limb stays inside the loose bound of
//    ops/fe25519.py; tests/test_torch_bounds.py proves it.
//  * Four consecutive threads carry one signature through the window
//    walk (the g4_* point code of ed25519_common.cuh): thread c owns
//    coordinate c of the accumulators vacc and facc and component c of
//    each entry of the per-signature table of w(-A) (16 x 40 B in local
//    memory), and every step of the point formulas is two or three
//    rounds of one field multiply per thread, operands exchanged with
//    __shfl_sync. The serial parts (k mod l and the decompression's
//    square-root chain before the walk, the inversion and compare after
//    it) run on one thread a signature, the block's first T / 4 threads,
//    so that a warp carries 32 signatures there and not 8; shared memory
//    hands over between the phases.
//  * Blocks of 256 threads from 8192 signatures up, else 128: measured
//    on the H100 (PERF.md, kernel 2), the larger block is faster when the
//    batch fills every SM and slower when it leaves most of them idle.
//  * Tables are indexed directly: verification works on public data, so
//    the TPU's 4-level select tree is not needed. The fixed-base table
//    (64 x 16 x 3 elements x 40 B = 122,880 B) is larger than the 64 KB
//    constant bank and is read with divergent indices, so it stays in
//    global memory, read through __ldg; each thread reads its component.
//  * The ragged batch edge: a group past it repeats the last signature
//    (the shuffles need every thread of the warp) and writes nothing.
//
// What bounds it on the H100: integer multiply-adds (3,481 field
// multiplies of 100 IMAD.WIDE each per signature). One thread per
// signature left a batch of 8192 at 256 warps, two per SM, latency
// bound; the group of four gives 1,024 warps and a walk a quarter as
// long, at the price of shuffles, selects and the adds each thread of a
// group repeats. At 2048 signatures the chain of one signature still
// sets the time.
//
// Plain PyTorch version: ops/ed25519.py `verify_core`, which performs the
// same limb operations in the same order on int64 tensors. The field,
// scalar and point code is csrc/ed25519_common.cuh, shared with the MSM
// kernels.
#include "ed25519_common.cuh"

// the table of w(-A) and the 64 msb-first windows: vacc = [S]B + [k](-A)
FD_DEV void verify_walk(g4pt &vacc, const uint64_t kw[4],
                        const uint64_t sw[4], const g4v<fe> &ax,
                        const g4v<fe> &ay, const g4v<fe> &at,
                        const i32 *fb) {
  // per-signature table: vb[w] = precomputed w(-A), w = 0..15
  g4v<fe> vb[16], a_neg;
  g4pt cur;
  g4_neg_start(cur, a_neg, ax, ay, at, 0);
  g4_pre_identity(vb[0]);
  g4_to_pre(vb[1], cur);
#pragma unroll 1
  for (int w = 2; w < 16; w++) {
    g4_madd_aff(cur, a_neg);
    g4_to_pre(vb[w], cur);
  }

  // vacc = 16 vacc + k_j(-A); facc += (s_j 16^j)B
  g4pt facc;
  g4_identity(vacc);
  g4_identity(facc);
#pragma unroll 1
  for (int j = 63; j >= 0; j--) {
    g4_dbl(vacc, false);
    g4_dbl(vacc, false);
    g4_dbl(vacc, false);
    g4_dbl(vacc, true);
    g4_add_pre(vacc, vb[nibble(kw, j)]);
    g4v<fe> q;
    const int s = nibble(sw, j);
    g4_each([&](int c) { fb_comp(q[c], fb, j, s, c < 3 ? c : 0); });
    g4_madd_aff(facc, q);
  }
  g4_add_full(vacc, facc);
}

// encode R' = (x : y : z) and compare with R's bytes (y digits and the
// sign of x)
FD_DEV bool verify_match(const fe &x, const fe &y, const fe &z,
                         const uint64_t rw[4]) {
  fe zinv, e;
  uint64_t ew[4];
  fe_invert(zinv, z);
  fe_mul(e, y, zinv);
  fe_canon(e, e);
  fe_towords(ew, e);
  fe_mul(e, x, zinv);
  fe_canon(e, e);
  ew[3] |= (uint64_t)(e.v[0] & 1) << 63;
  return ew[0] == rw[0] && ew[1] == rw[1] && ew[2] == rw[2] && ew[3] == rw[3];
}

#ifdef __CUDACC__
// The serial parts (k mod l and the decompression before the walk, the
// inversion and compare after it) on one thread a signature, the first
// T / 4 threads of the block, so a warp carries 32 signatures
// there rather than 8; the walk on the groups. Shared memory hands over.
template <int T>
__global__ void __launch_bounds__(T)
ed25519_verify_kernel(const uint8_t *__restrict__ sig,
                      const uint8_t *__restrict__ pub,
                      const uint8_t *__restrict__ k64,
                      const i32 *__restrict__ fb, i32 *__restrict__ out,
                      int n) {
  constexpr int S = T / 4;
  __shared__ fe sx[S], sy[S], st[S], sv[S][3];
  __shared__ uint64_t sk[S][4];
  __shared__ int sok[S];
  const int tid = threadIdx.x, g = tid >> 2, c = tid & 3;
  const int base = blockIdx.x * S;
  if (tid < S) {
    const int l = base + tid < n ? base + tid : n - 1;
    uint64_t hw[8];
    load_words(hw, k64 + (int64_t)l * 64, 8);
    sc_reduce64(sk[tid], hw);
    sok[tid] = ge_decompress(sx[tid], sy[tid], st[tid], pub + (int64_t)l * 32);
  }
  __syncthreads();
  {
    const int l = base + g < n ? base + g : n - 1;
    uint64_t sw[4], kw[4];
    load_words(sw, sig + (int64_t)l * 64 + 32, 4);
#pragma unroll
    for (int k = 0; k < 4; k++) kw[k] = sk[g][k];
    g4v<fe> ax, ay, at;
    ax.v = sx[g];
    ay.v = sy[g];
    at.v = st[g];
    g4pt vacc;
    verify_walk(vacc, kw, sw, ax, ay, at, fb);
    if (c < 3) sv[g][c] = vacc.v;
  }
  __syncthreads();
  if (tid < S && base + tid < n) {
    uint64_t rw[4];
    load_words(rw, sig + (int64_t)(base + tid) * 64, 4);
    const bool match = verify_match(sv[tid][0], sv[tid][1], sv[tid][2], rw);
    out[base + tid] = (sok[tid] && match) ? 1 : 0;
  }
}

template <int T>
static void verify_launch(const void *sig, const void *pub, const void *k64,
                          const void *fb, void *out, int n,
                          cudaStream_t stream) {
  ed25519_verify_kernel<T><<<(n + T / 4 - 1) / (T / 4), T, 0, stream>>>(
      (const uint8_t *)sig, (const uint8_t *)pub, (const uint8_t *)k64,
      (const i32 *)fb, (i32 *)out, n);
}

// sig (n, 64), pub (n, 32), k64 (n, 64) uint8, fb (64, 16, 3, 10) int32,
// out (n,) int32; device pointers; launches on `stream` and returns
// cudaGetLastError(). Blocks of 256 threads from 8192 signatures up (one
// block an SM fills 128 SMs), else of 128: the faster of the two at 8192
// and at 2048 signatures on the H100 (PERF.md).
extern "C" int fdtt_ed25519_verify(const void *sig, const void *pub,
                                   const void *k64, const void *fb,
                                   void *out, int n, void *stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n > 0) {
    if (n >= 128 * 64)
      verify_launch<256>(sig, pub, k64, fb, out, n, st);
    else
      verify_launch<128>(sig, pub, k64, fb, out, n, st);
  }
  return (int)cudaGetLastError();
}
#else
// Host build: signature `lane`, every part on the group, its four threads
// in turn (the kernel runs the serial parts on one thread instead; the
// arithmetic is the same).
extern "C" void ed25519_verify_kernel(const uint8_t *sig, const uint8_t *pub,
                                      const uint8_t *k64, const i32 *fb,
                                      i32 *out, int n, int lane) {
  uint64_t rw[4], sw[4], kw[4], hw[8];
  load_words(rw, sig + (int64_t)lane * 64, 4);
  load_words(sw, sig + (int64_t)lane * 64 + 32, 4);
  load_words(hw, k64 + (int64_t)lane * 64, 8);
  sc_reduce64(kw, hw);
  g4v<fe> ax, ay, at;
  g4v<i32> dec;
  g4_each([&](int c) {
    dec[c] = ge_decompress(ax[c], ay[c], at[c], pub + (int64_t)lane * 32);
  });
  g4pt vacc;
  verify_walk(vacc, kw, sw, ax, ay, at, fb);
  const bool match = verify_match(vacc[0], vacc[1], vacc[2], rw);
  if (lane < n) out[lane] = (dec[0] && match) ? 1 : 0;
}
#endif

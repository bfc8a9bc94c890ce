// Fused strict ed25519 verify core, one thread per signature.
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
//  * Tables are indexed directly: verification works on public data, so
//    the TPU's 4-level select tree is not needed. The fixed-base table
//    (64 x 16 x 3 elements x 40 B = 122,880 B) is larger than the 64 KB
//    constant bank and is read with divergent indices, so it stays in
//    global memory, read through __ldg. The per-lane 16-entry table of
//    w(-A) (2,560 B) lives in local memory.
//  * The ragged batch edge is masked here; the batch is not padded.
//
// What bounds it on the H100: integer multiply-adds (3,481 field
// multiplies of 100 IMAD.WIDE each per signature). With one thread per
// signature, a batch of 8192 fills 256 warps, about two per SM, so the
// dependent multiply chains are latency bound: this first version is
// correct and simple, and spreading a signature over several threads is
// later work.
//
// Plain PyTorch version: ops/ed25519.py `verify_core`, which performs the
// same limb operations in the same order on int64 tensors. The field,
// scalar and point code is csrc/ed25519_common.cuh, shared with the MSM
// kernels.
#include "ed25519_common.cuh"

#ifdef __CUDACC__
__global__ void __launch_bounds__(64)
#else
extern "C" void
#endif
ed25519_verify_kernel(const uint8_t *__restrict__ sig,
                      const uint8_t *__restrict__ pub,
                      const uint8_t *__restrict__ k64,
                      const i32 *__restrict__ fb, i32 *__restrict__ out,
                      int n, int lane) {
#ifdef __CUDACC__
  lane = blockIdx.x * blockDim.x + threadIdx.x;
#endif
  // (host build: `lane` is the caller's lane index)
  if (lane >= n) return;                    // ragged batch edge
  uint64_t rw[4], sw[4], kw[4], hw[8];
  load_words(rw, sig + (int64_t)lane * 64, 4);
  load_words(sw, sig + (int64_t)lane * 64 + 32, 4);
  load_words(hw, k64 + (int64_t)lane * 64, 8);
  sc_reduce64(kw, hw);

  // decompress A
  fe ay, ax, at;
  const bool dec_ok = ge_decompress(ax, ay, at, pub + (int64_t)lane * 32);

  // per-lane table: vb[w] = precomputed w(-A), w = 0..15
  pre_proj vb[16];
  ge cur;
  pre_aff a_neg;
  ge_neg_start(cur, a_neg, ax, ay, at);
  pre_identity(vb[0]);
  ge_to_pre(vb[1], cur);
#pragma unroll 1
  for (int w = 2; w < 16; w++) {
    ge_madd_aff(cur, a_neg);
    ge_to_pre(vb[w], cur);
  }

  // 64 msb-first windows: vacc = 16 vacc + k_j(-A); facc += (s_j 16^j)B
  ge vacc, facc;
  ge_identity(vacc);
  ge_identity(facc);
#pragma unroll 1
  for (int j = 63; j >= 0; j--) {
    ge_dbl(vacc, false);
    ge_dbl(vacc, false);
    ge_dbl(vacc, false);
    ge_dbl(vacc, true);
    ge_add_pre(vacc, vb[nibble(kw, j)]);
    pre_aff q;
    fb_entry(q, fb, j, nibble(sw, j));
    ge_madd_aff(facc, q);
  }
  ge_add_full(vacc, facc);

  // encode R' and compare with R's bytes (y digits and the sign of x)
  fe zinv, c;
  uint64_t ew[4];
  fe_invert(zinv, vacc.Z);
  fe_mul(c, vacc.Y, zinv);
  fe_canon(c, c);
  fe_towords(ew, c);
  fe_mul(c, vacc.X, zinv);
  fe_canon(c, c);
  ew[3] |= (uint64_t)(c.v[0] & 1) << 63;
  const bool match = ew[0] == rw[0] && ew[1] == rw[1] && ew[2] == rw[2] &&
                     ew[3] == rw[3];
  out[lane] = (dec_ok && match) ? 1 : 0;
}

#ifdef __CUDACC__
// sig (n, 64), pub (n, 32), k64 (n, 64) uint8, fb (64, 16, 3, 10) int32,
// out (n,) int32; device pointers; launches on `stream` and returns
// cudaGetLastError().
extern "C" int fdtt_ed25519_verify(const void *sig, const void *pub,
                                   const void *k64, const void *fb,
                                   void *out, int n, void *stream) {
  const int threads = 64;
  if (n > 0)
    ed25519_verify_kernel<<<(n + threads - 1) / threads, threads, 0,
                            (cudaStream_t)stream>>>(
        (const uint8_t *)sig, (const uint8_t *)pub, (const uint8_t *)k64,
        (const i32 *)fb, (i32 *)out, n, 0);
  return (int)cudaGetLastError();
}
#endif

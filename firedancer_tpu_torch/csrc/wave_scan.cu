// The bank's wave scan: a block of system-program transfers, staged into
// conflict-free waves, executed wave after wave against one balance table.
//
// Replaces firedancer_tpu/svm/executor.py `_scan_packed` (:111), a jitted
// `lax.scan` over waves (not a Pallas kernel): each scan step gathers the
// wave's source and destination balances as (hi, lo) uint32 pairs,
// charges fee and amount where payable, and scatters the results back.
// Here the whole scan is one launch of one thread block:
//  * the (A,) balances sit in shared memory as native 64-bit words when
//    they fit (8 B an account: 29,056 accounts in the 227 KB a block may
//    have), else in a global scratch the wrapper allocates;
//  * the lanes of a wave are strided over the block's threads, one
//    thread a lane, and one __syncthreads() separates two waves. Lanes
//    of one wave are account-disjoint by the conflict DAG's construction
//    (a transfer writes src and dst), so a wave's reads and writes never
//    race;
//  * within a lane the order is the reference's: src is charged and
//    written first, then dst is read, credited and written, so a
//    self-transfer nets to the fee alone;
//  * an inactive lane (act = 0: padding) does nothing and reports
//    STATUS_PAD; so does a lane whose src or dst is not below A, which
//    the stage never builds (the plain version does the same).
//
// Lamports are u64 with mod-2^64 arithmetic, as the reference's carry and
// borrow chains on uint32 halves: fee + amount may wrap, and every
// compare is unsigned.
//
// What bounds it on the H100: neither bytes (28 B a lane, 16 B an
// account) nor operations (some 20 integer operations a lane), but the
// chain of W dependent wave steps: each is a shared-memory round trip and
// a barrier, and no two waves may overlap. One block on one SM is the
// design: more blocks would need a grid-wide barrier between waves.
//
// Plain PyTorch version: firedancer_tpu_torch/ops/cuda_wave.py
// `wave_scan_plain`.
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FD_DEV __device__ __forceinline__
#else
#define FD_DEV static inline
#endif

#define STATUS_PAD (-1)
#define STATUS_OK 0
#define STATUS_INSUFFICIENT 1
#define STATUS_FEE_FAIL 2
#define LANE_WORDS 7    // src, dst, amt_hi, amt_lo, fee_hi, fee_lo, act

// One lane of one wave against the balance table bal (A accounts).
FD_DEV int32_t wave_lane(uint64_t *bal, const uint32_t *row, int64_t A) {
  const uint32_t s = row[0], d = row[1];
  if (!row[6] || s >= A || d >= A) return STATUS_PAD;
  const uint64_t amt = ((uint64_t)row[2] << 32) | row[3];
  const uint64_t fee = ((uint64_t)row[4] << 32) | row[5];
  const uint64_t need = amt + fee;                    // wraps mod 2^64
  const uint64_t sb = bal[s];
  const bool fee_ok = sb >= fee, ok = sb >= need;
  bal[s] = sb - (ok ? need : (fee_ok ? fee : 0));
  bal[d] += ok ? amt : 0;                            // after the src write
  return ok ? STATUS_OK : (fee_ok ? STATUS_INSUFFICIENT : STATUS_FEE_FAIL);
}

#ifdef __CUDACC__
// SHARED: balances in dynamic shared memory; else in gbal (A words)
template <bool SHARED>
__global__ void wave_scan_kernel(const uint32_t *__restrict__ packed, int W,
                                 int C, const uint32_t *__restrict__ bal_hi,
                                 const uint32_t *__restrict__ bal_lo, int A,
                                 uint32_t *__restrict__ out_hi,
                                 uint32_t *__restrict__ out_lo,
                                 int32_t *__restrict__ status,
                                 uint64_t *gbal) {
  extern __shared__ uint64_t sbal[];
  uint64_t *bal = SHARED ? sbal : gbal;
  for (int a = threadIdx.x; a < A; a += blockDim.x)
    bal[a] = ((uint64_t)bal_hi[a] << 32) | bal_lo[a];
  __syncthreads();
#pragma unroll 1
  for (int w = 0; w < W; w++) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const int64_t lane = (int64_t)w * C + c;
      status[lane] = wave_lane(bal, packed + lane * LANE_WORDS, A);
    }
    __syncthreads();                 // wave w's writes before wave w + 1
  }
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    out_hi[a] = (uint32_t)(bal[a] >> 32);
    out_lo[a] = (uint32_t)bal[a];
  }
}

#define SMEM_DEFAULT (48 * 1024)
#define SMEM_MAX (227 * 1024)

// packed (W, C, 7) uint32, bal_hi / bal_lo (A,) uint32 -> out_hi / out_lo
// (A,) uint32, status (W, C) int32; gbal: A uint64 of scratch, used only
// when the balances do not fit in shared memory (may be null otherwise).
// Device pointers; launches on `stream` and returns cudaGetLastError().
extern "C" int fdtt_wave_scan(const void *packed, int W, int C,
                              const void *bal_hi, const void *bal_lo, int A,
                              void *out_hi, void *out_lo, void *status,
                              void *gbal, void *stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  int threads = ((C + 31) / 32) * 32;
  threads = threads < 128 ? 128 : (threads > 1024 ? 1024 : threads);
  const size_t smem = (size_t)A * 8;
#define WAVE_ARGS                                                       \
  (const uint32_t *)packed, W, C, (const uint32_t *)bal_hi,             \
      (const uint32_t *)bal_lo, A, (uint32_t *)out_hi, (uint32_t *)out_lo, \
      (int32_t *)status, (uint64_t *)gbal
  if (smem <= SMEM_MAX) {
    if (smem > SMEM_DEFAULT) {
      static bool opted = false;     // once per process
      if (!opted) {
        const cudaError_t e = cudaFuncSetAttribute(
            wave_scan_kernel<true>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
        if (e != cudaSuccess) return (int)e;
        opted = true;
      }
    }
    wave_scan_kernel<true><<<1, threads, smem, st>>>(WAVE_ARGS);
  } else {
    if (!gbal) return (int)cudaErrorInvalidValue;
    wave_scan_kernel<false><<<1, threads, 0, st>>>(WAVE_ARGS);
  }
#undef WAVE_ARGS
  return (int)cudaGetLastError();
}
#else
// Host build: the whole scan, wave after wave and lane after lane (a
// wave's lanes are account-disjoint, so their order within the wave does
// not matter); the same arguments as fdtt_wave_scan, host pointers.
extern "C" void wave_scan_host(const uint32_t *packed, int W, int C,
                               const uint32_t *bal_hi, const uint32_t *bal_lo,
                               int A, uint32_t *out_hi, uint32_t *out_lo,
                               int32_t *status, uint64_t *bal) {
  for (int a = 0; a < A; a++) bal[a] = ((uint64_t)bal_hi[a] << 32) | bal_lo[a];
  for (int64_t lane = 0; lane < (int64_t)W * C; lane++)
    status[lane] = wave_lane(bal, packed + lane * LANE_WORDS, A);
  for (int a = 0; a < A; a++) {
    out_hi[a] = (uint32_t)(bal[a] >> 32);
    out_lo[a] = (uint32_t)bal[a];
  }
}
#endif

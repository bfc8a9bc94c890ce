// Issue rates of the integer instructions the SHA-256 rounds are made of,
// on one warp of an SM: a loop of CH independent chains of one kind of
// instruction (or of two kinds in turn), timed by clock64() on lane 0.
// Cycles per warp instruction = cycles / (iters x 16 x CH); with CH = 1
// the same number is the instruction's dependent latency. `active` lanes
// of the warp run (16: does half a warp issue at twice the rate?).
// place_kernel: where the warps of a launch land (%smid, %warpid, whose
// value mod 4 is the SM sub-partition) and how long each takes for the
// same LOP3 work, so warps sharing a sub-partition show as twice as slow.
// pingpong_kernel: one handoff each way between two warps of a block by
// bar.arrive / bar.sync on named barriers, in clocks.
// Built and run by tools/sha256_bench.py (--pipes); not part of the port.
#include <stdint.h>
#include <cuda_runtime.h>

#define LOP3(a, b, c) \
  asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;" : "+r"(a) : "r"(b), "r"(c))
#define SHF(a) asm volatile("shf.r.wrap.b32 %0, %0, %0, 7;" : "+r"(a))
#define MAD(a, b, c) \
  asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(a) : "r"(b), "r"(c))
#define MADHI(a, b, c) \
  asm volatile("mad.hi.u32 %0, %0, %1, %2;" : "+r"(a) : "r"(b), "r"(c))
#define ADD(a, b) asm volatile("add.u32 %0, %0, %1;" : "+r"(a) : "r"(b))
#define PRMT(a, b) \
  asm volatile("prmt.b32 %0, %0, %1, 0x1230;" : "+r"(a) : "r"(b))
// a lane takes the value of the next lane of its group of four
#define SHFL(a, src, mask)                                                  \
  asm volatile("shfl.sync.idx.b32 %0, %0, %1, 0x1c1f, %2;" : "+r"(a)       \
               : "r"(src), "r"(mask))

// kinds: 0 LOP3, 1 SHF (funnel rotate), 2 IMAD, 3 IMAD.HI, 4 IADD (ptxas
// picks IADD3 or an IMAD form), 5 PRMT, 6 LOP3 / IMAD in turn, 7 SHF /
// IMAD in turn, 8 LOP3 / SHF in turn, 9 SHF / IMAD.HI in turn, 10 SHFL
// within groups of four lanes, 11 SHF / SHFL in turn
__device__ constexpr int op_of(int kind, int k) {
  return kind < 6 ? kind
       : kind == 6 ? ((k & 1) ? 2 : 0)
       : kind == 7 ? ((k & 1) ? 2 : 1)
       : kind == 8 ? ((k & 1) ? 1 : 0)
       : kind == 9 ? ((k & 1) ? 3 : 1)
       : kind == 10 ? 6
                    : ((k & 1) ? 6 : 1);
}

template <int KIND, int CH>
__global__ void pipe_kernel(long long *out, int iters, uint32_t mul,
                            int active) {
  if ((int)threadIdx.x >= active) return;
  uint32_t a[CH], x[CH];
#pragma unroll
  for (int k = 0; k < CH; k++) {
    a[k] = threadIdx.x * 2654435761u + 977u * k;
    x[k] = mul * (k + 3u);
  }
  const uint32_t mask = __activemask(), src = (threadIdx.x + 1) & 3;
  __syncwarp(mask);
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < iters; i++) {
#pragma unroll
    for (int u = 0; u < 16; u++) {
#pragma unroll
      for (int k = 0; k < CH; k++) {
        const int o = op_of(KIND, k);
        if (o == 0) LOP3(a[k], x[k], mul);
        else if (o == 1) SHF(a[k]);
        else if (o == 2) MAD(a[k], mul, x[k]);
        else if (o == 3) MADHI(a[k], mul, x[k]);
        else if (o == 4) ADD(a[k], x[k]);
        else if (o == 5) PRMT(a[k], x[k]);
        else SHFL(a[k], src, mask);
      }
    }
  }
  const long long t1 = clock64();
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < CH; k++) s ^= a[k];
  if (threadIdx.x == 0) out[2 * blockIdx.x] = t1 - t0;
  if (s == 0x12345678u) out[2 * blockIdx.x + 1] = s;
}

template <int KIND>
static void launch_kind(long long *out, int iters, uint32_t mul, int active,
                        int chains, int blocks, cudaStream_t st) {
  if (chains == 1)
    pipe_kernel<KIND, 1><<<blocks, 32, 0, st>>>(out, iters, mul, active);
  else
    pipe_kernel<KIND, 8><<<blocks, 32, 0, st>>>(out, iters, mul, active);
}

// out (2 x blocks) int64: lane 0's cycles of each block (one warp a
// block, one block an SM at blocks <= the SM count)
extern "C" int fdtt_pipe_bench(int kind, int chains, int iters, int active,
                               unsigned mul, void *out, int blocks,
                               void *stream) {
  long long *o = (long long *)out;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case 0: launch_kind<0>(o, iters, mul, active, chains, blocks, st); break;
    case 1: launch_kind<1>(o, iters, mul, active, chains, blocks, st); break;
    case 2: launch_kind<2>(o, iters, mul, active, chains, blocks, st); break;
    case 3: launch_kind<3>(o, iters, mul, active, chains, blocks, st); break;
    case 4: launch_kind<4>(o, iters, mul, active, chains, blocks, st); break;
    case 5: launch_kind<5>(o, iters, mul, active, chains, blocks, st); break;
    case 6: launch_kind<6>(o, iters, mul, active, chains, blocks, st); break;
    case 7: launch_kind<7>(o, iters, mul, active, chains, blocks, st); break;
    case 8: launch_kind<8>(o, iters, mul, active, chains, blocks, st); break;
    case 9: launch_kind<9>(o, iters, mul, active, chains, blocks, st); break;
    case 10: launch_kind<10>(o, iters, mul, active, chains, blocks, st); break;
    case 11: launch_kind<11>(o, iters, mul, active, chains, blocks, st); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

__global__ void place_kernel(long long *out, int iters, uint32_t mul) {
  uint32_t a[8];
#pragma unroll
  for (int k = 0; k < 8; k++) a[k] = threadIdx.x * 2654435761u + 977u * k;
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < iters; i++) {
#pragma unroll
    for (int u = 0; u < 16; u++) {
#pragma unroll
      for (int k = 0; k < 8; k++) LOP3(a[k], mul, mul + k);
    }
  }
  const long long t1 = clock64();
  uint32_t s = 0, smid, warpid;
#pragma unroll
  for (int k = 0; k < 8; k++) s ^= a[k];
  asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
  asm volatile("mov.u32 %0, %%warpid;" : "=r"(warpid));
  const int w = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    out[3 * w] = t1 - t0;
    out[3 * w + 1] = smid;
    out[3 * w + 2] = warpid + (s == 0x12345678u);
  }
}

__global__ void pingpong_kernel(long long *out, int iters) {
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < iters; i++) {
    if (threadIdx.x < 32) {
      asm volatile("bar.arrive 1, 64;" ::: "memory");
      asm volatile("bar.sync 2, 64;" ::: "memory");
    } else {
      asm volatile("bar.sync 1, 64;" ::: "memory");
      asm volatile("bar.arrive 2, 64;" ::: "memory");
    }
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) out[blockIdx.x] = t1 - t0;
}

// out (3 x warps) int64: cycles, SM and warp slot of each warp
extern "C" int fdtt_place_bench(int blocks, int warps, int iters,
                                unsigned mul, void *out, void *stream) {
  place_kernel<<<blocks, 32 * warps, 0, (cudaStream_t)stream>>>(
      (long long *)out, iters, mul);
  return (int)cudaGetLastError();
}

extern "C" int fdtt_pingpong_bench(int blocks, int iters, void *out,
                                   void *stream) {
  pingpong_kernel<<<blocks, 64, 0, (cudaStream_t)stream>>>(
      (long long *)out, iters);
  return (int)cudaGetLastError();
}

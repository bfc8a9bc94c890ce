// The build macros shared by every kernel source, and the strict
// prechecks on encodings (ed25519._bytes_lt and is_small_order_encoding):
// the SHA-512 kernel (csrc/sha512.cu) runs them beside k = SHA-512(R ||
// A || M), and MSM stage 1 (csrc/ed25519_msm.cu, through
// ed25519_common.cuh) beside its scalars.
#pragma once
#include <stdint.h>

// Without nvcc (__CUDACC__ unset) the sources compile as plain C++: a
// kernel's per-lane part becomes a host function, which the CPU tests
// drive lane by lane against the plain PyTorch version.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FD_DEV __device__ __forceinline__
#define FD_NOINLINE __device__ __noinline__
#define FD_LDG(p) __ldg(p)
#define FD_CONST __constant__
#else
#define FD_DEV static inline
#define FD_NOINLINE static
#define FD_LDG(p) (*(p))
#define FD_CONST static const
#endif

// nwords little-endian 64-bit words from bytes
FD_DEV void load_words(uint64_t *w, const uint8_t *p, int nwords) {
  for (int k = 0; k < nwords; k++) {
    uint64_t v = 0;
#pragma unroll
    for (int b = 7; b >= 0; b--) v = (v << 8) | p[8 * k + b];
    w[k] = v;
  }
}

FD_CONST uint64_t SC_L[4] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL,
                             0x0000000000000000ULL, 0x1000000000000000ULL};
FD_CONST uint64_t FE_P[4] = {0xffffffffffffffedULL, 0xffffffffffffffffULL,
                             0xffffffffffffffffULL, 0x7fffffffffffffffULL};
// every encoding of an 8-torsion point (ed25519._small_order_encodings,
// in its order; tests/test_torch_csrc_host.py holds the two equal)
#define N_SMALL_ORDER 11
FD_CONST uint64_t SMALL_ORDER[N_SMALL_ORDER][4] = {
    {0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
     0x0000000000000000ULL},
    {0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
     0x8000000000000000ULL},
    {0x0000000000000001ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
     0x0000000000000000ULL},
    {0xb027b2c28f95e826ULL, 0xf098eff289f4c345ULL, 0x3933c6d305acdfd5ULL,
     0x05fc536d880238b1ULL},
    {0xb027b2c28f95e826ULL, 0xf098eff289f4c345ULL, 0x3933c6d305acdfd5ULL,
     0x85fc536d880238b1ULL},
    {0x4fd84d3d706a17c7ULL, 0x0f67100d760b3cbaULL, 0xc6cc392cfa53202aULL,
     0x7a03ac9277fdc74eULL},
    {0x4fd84d3d706a17c7ULL, 0x0f67100d760b3cbaULL, 0xc6cc392cfa53202aULL,
     0xfa03ac9277fdc74eULL},
    {0xffffffffffffffecULL, 0xffffffffffffffffULL, 0xffffffffffffffffULL,
     0x7fffffffffffffffULL},
    {0xffffffffffffffedULL, 0xffffffffffffffffULL, 0xffffffffffffffffULL,
     0x7fffffffffffffffULL},
    {0xffffffffffffffedULL, 0xffffffffffffffffULL, 0xffffffffffffffffULL,
     0xffffffffffffffffULL},
    {0xffffffffffffffeeULL, 0xffffffffffffffffULL, 0xffffffffffffffffULL,
     0x7fffffffffffffffULL}};

// w < c as 256-bit LE integers; top7: bit 255 of w (a sign) ignored
FD_DEV bool words_lt(const uint64_t w[4], const uint64_t c[4], bool top7) {
  bool lt = false, done = false;
#pragma unroll
  for (int k = 3; k >= 0; k--) {
    const uint64_t v = (k == 3 && top7) ? w[k] & 0x7fffffffffffffffULL : w[k];
    if (!done && v != c[k]) {
      lt = v < c[k];
      done = true;
    }
  }
  return lt;
}

FD_DEV bool is_small_order(const uint64_t w[4]) {
  bool hit = false;
#pragma unroll 1
  for (int i = 0; i < N_SMALL_ORDER; i++)
    hit |= w[0] == SMALL_ORDER[i][0] && w[1] == SMALL_ORDER[i][1] &&
           w[2] == SMALL_ORDER[i][2] && w[3] == SMALL_ORDER[i][3];
  return hit;
}

// the strict verify's prechecks on S, A and R as words
// (ed25519.strict_prechecks): S < l, A.y < p, A and R not small-order
FD_DEV bool strict_prechecks(const uint64_t sw[4], const uint64_t aw[4],
                             const uint64_t rw[4]) {
  return words_lt(sw, SC_L, false) && words_lt(aw, FE_P, true) &&
         !is_small_order(aw) && !is_small_order(rw);
}

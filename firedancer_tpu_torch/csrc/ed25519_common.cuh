// Field, scalar and point device code shared by the ed25519 kernels
// (csrc/ed25519_verify.cu, csrc/ed25519_msm.cu), so that a fix such as
// the limb negation below lands in every kernel at once.
//
// Every function performs the same limb operations, in the same order,
// as its plain PyTorch counterpart in ops/fe25519.py and ops/ed25519.py
// (named beside each), so each kernel is held to its plain version bit
// for bit.
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
#else
#define FD_DEV static inline
#define FD_NOINLINE static
#define FD_LDG(p) (*(p))
#endif

typedef int32_t i32;
typedef int64_t i64;

struct fe { i32 v[10]; };
struct ge { fe X, Y, Z, T; };            // extended coordinates
struct pre_aff { fe ymx, ypx, t2d; };    // affine precomputed, Z = 1
struct pre_proj { fe ymx, ypx, z2, t2d; };

#define W_(i) (((i) & 1) ? 25 : 26)
#define M_(i) ((((i) & 1) ? (1 << 25) : (1 << 26)) - 1)

// ---- field: the primitives of ops/fe25519.py -----------------------------

FD_DEV void fe_set(fe &o, i32 v0) {
  o.v[0] = v0;
#pragma unroll
  for (int i = 1; i < 10; i++) o.v[i] = 0;
}

// one parallel carry pass over raw sums (fe25519.carry)
FD_DEV void fe_carry(fe &o, const i32 h[10]) {
  i32 c[10];
#pragma unroll
  for (int i = 0; i < 10; i++) c[i] = h[i] >> W_(i);
  o.v[0] = (h[0] & M_(0)) + 19 * c[9];
#pragma unroll
  for (int i = 1; i < 10; i++) o.v[i] = (h[i] & M_(i)) + c[i - 1];
}

FD_DEV void fe_add(fe &o, const fe &f, const fe &g) {
  i32 h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = f.v[i] + g.v[i];
  fe_carry(o, h);
}

FD_DEV void fe_sub(fe &o, const fe &f, const fe &g) {
  i32 h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = f.v[i] - g.v[i];
  fe_carry(o, h);
}

// 2p - f, not -f: with -f, nvcc 12.8 at -O3 (ptxas -O1 and above; -O0
// was right) carried one too little out of negated 25-bit limbs on the
// H100, so every negation is written with positive raw limbs
FD_DEV void fe_neg(fe &o, const fe &f) {
  i32 h[10];
#pragma unroll
  for (int i = 0; i < 10; i++)
    h[i] = (i == 0 ? 2 * ((1 << 26) - 19) : 2 * (M_(i))) - f.v[i];
  fe_carry(o, h);
}

FD_DEV void fe_mul2(fe &o, const fe &f) {
  i32 h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = 2 * f.v[i];
  fe_carry(o, h);
}

#define FE_CARRY64(i)                         \
  {                                           \
    i64 c_ = h[i] >> W_(i);                   \
    h[i] &= M_(i);                            \
    if ((i) == 9) h[0] += 19 * c_;            \
    else h[((i) + 1) % 10] += c_;             \
  }

// schoolbook product, int64 sums, interleaved carry (fe25519.mul)
FD_DEV void fe_mul(fe &o, const fe &f, const fe &g) {
  i32 g19[10], f2[10];
  i64 h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    g19[i] = 19 * g.v[i];
    f2[i] = 2 * f.v[i];
    h[i] = 0;
  }
#pragma unroll
  for (int i = 0; i < 10; i++)
#pragma unroll
    for (int j = 0; j < 10; j++) {
      const i32 a = ((i & 1) && (j & 1)) ? f2[i] : f.v[i];
      const i32 b = (i + j >= 10) ? g19[j] : g.v[j];
      h[(i + j) % 10] += (i64)a * b;
    }
  FE_CARRY64(0) FE_CARRY64(4) FE_CARRY64(1) FE_CARRY64(5) FE_CARRY64(2)
  FE_CARRY64(6) FE_CARRY64(3) FE_CARRY64(7) FE_CARRY64(4) FE_CARRY64(8)
  FE_CARRY64(9) FE_CARRY64(0)
#pragma unroll
  for (int i = 0; i < 10; i++) o.v[i] = (i32)h[i];
}

FD_DEV void fe_sq(fe &o, const fe &f) { fe_mul(o, f, f); }

FD_DEV void fe_nsq(fe &o, const fe &f, int n) {
  fe_sq(o, f);
#pragma unroll 1
  for (int i = 1; i < n; i++) fe_sq(o, o);
}

FD_DEV void fe_from_consts(fe &o, const i32 *c) {
#pragma unroll
  for (int i = 0; i < 10; i++) o.v[i] = c[i];
}

#define FE_CONST(name, ...)                                  \
  FD_DEV void name(fe &o) {                                  \
    const i32 c_[10] = {__VA_ARGS__};                        \
    fe_from_consts(o, c_);                                   \
  }
FE_CONST(fe_d, 56195235, 13857412, 51736253, 6949390, 114729, 24766616,
         60832955, 30306712, 48412415, 21499315)
FE_CONST(fe_d2, 45281625, 27714825, 36363642, 13898781, 229458, 15978800,
         54557047, 27058993, 29715967, 9444199)
FE_CONST(fe_sqrtm1, 34513072, 25610706, 9377949, 3500415, 12389472,
         33281959, 41962654, 31548777, 326685, 11406482)

// x^(2^250 - 1) and x^11 (fe25519._chain_z250)
FD_NOINLINE void fe_chain_z250(fe &z250, fe &x11, const fe &x) {
  fe x2, x9, t, z5, z10, z20, z50, z100;
  fe_sq(x2, x);
  fe_sq(t, x2);
  fe_sq(t, t);
  fe_mul(x9, x, t);
  fe_mul(x11, x2, x9);
  fe_sq(t, x11);
  fe_mul(z5, x9, t);
  fe_nsq(t, z5, 5);    fe_mul(z10, t, z5);
  fe_nsq(t, z10, 10);  fe_mul(z20, t, z10);
  fe_nsq(t, z20, 20);  fe_mul(t, t, z20);       // z40
  fe_nsq(t, t, 10);    fe_mul(z50, t, z10);
  fe_nsq(t, z50, 50);  fe_mul(z100, t, z50);
  fe_nsq(t, z100, 100); fe_mul(t, t, z100);     // z200
  fe_nsq(t, t, 50);    fe_mul(z250, t, z50);
}

FD_DEV void fe_pow_p58(fe &o, const fe &x) {
  fe z250, x11;
  fe_chain_z250(z250, x11, x);
  fe_nsq(z250, z250, 2);
  fe_mul(o, z250, x);
}

FD_DEV void fe_invert(fe &o, const fe &x) {
  fe z250, x11;
  fe_chain_z250(z250, x11, x);
  fe_nsq(z250, z250, 5);
  fe_mul(o, z250, x11);
}

// sequential floor carry 0..9 (fe25519._chain)
FD_DEV void fe_chain(i32 h[10], bool fold) {
#pragma unroll
  for (int i = 0; i < 10; i++) {
    i32 c = h[i] >> W_(i);
    h[i] &= M_(i);
    if (i < 9) h[i + 1] += c;
    else if (fold) h[0] += 19 * c;
  }
}

// exact digits in [0, p) (fe25519.canon)
FD_DEV void fe_canon(fe &o, const fe &x) {
  i32 h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = x.v[i];
  fe_chain(h, true);
  fe_chain(h, true);
  i32 q = (h[0] + 19) >> 26;
#pragma unroll
  for (int i = 1; i < 10; i++) q = (h[i] + q) >> W_(i);
  h[0] += 19 * q;
  fe_chain(h, false);
#pragma unroll
  for (int i = 0; i < 10; i++) o.v[i] = h[i];
}

FD_DEV bool fe_is_zero(const fe &x) {
  fe c;
  fe_canon(c, x);
  i32 acc = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) acc |= c.v[i];
  return acc == 0;
}

FD_DEV void fe_cmov(fe &o, const fe &a, bool take) {
#pragma unroll
  for (int i = 0; i < 10; i++) o.v[i] = take ? a.v[i] : o.v[i];
}

// limb i = bits [O_i, O_i + W_i) of 32 LE bytes held as 4 words; bit 255
// is never part of a limb (fe25519.frombytes)
FD_DEV void fe_frombytes(fe &o, const uint64_t w[4]) {
  const int off[10] = {0, 26, 51, 77, 102, 128, 153, 179, 204, 230};
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int k = off[i] >> 6, s = off[i] & 63;
    uint64_t v = w[k] >> s;
    if (s + W_(i) > 64) v |= w[k + 1] << (64 - s);
    o.v[i] = (i32)(v & (uint64_t)M_(i));
  }
}

// canonical limbs -> 4 LE words of the 255-bit value
FD_DEV void fe_towords(uint64_t w[4], const fe &c) {
  const int off[10] = {0, 26, 51, 77, 102, 128, 153, 179, 204, 230};
  w[0] = w[1] = w[2] = w[3] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int k = off[i] >> 6, s = off[i] & 63;
    const uint64_t v = (uint64_t)(uint32_t)c.v[i];
    w[k] |= v << s;
    if (s + W_(i) > 64) w[k + 1] |= v >> (64 - s);
  }
}

FD_DEV void load_words(uint64_t *w, const uint8_t *p, int nwords) {
  for (int k = 0; k < nwords; k++) {
    uint64_t v = 0;
#pragma unroll
    for (int b = 7; b >= 0; b--) v = (v << 8) | p[8 * k + b];
    w[k] = v;
  }
}

// ---- scalars: k64 mod l (ed25519.sc_reduce64) ----------------------------

#define SC_FOLD(n)                                                   \
  {                                                                  \
    s[(n) - 12] += s[n] * 666643;  s[(n) - 11] += s[n] * 470296;     \
    s[(n) - 10] += s[n] * 654183;  s[(n) - 9] -= s[n] * 997805;      \
    s[(n) - 8] += s[n] * 136657;   s[(n) - 7] -= s[n] * 683901;      \
    s[n] = 0;                                                        \
  }

FD_DEV void sc_carry21(i64 *s, int lo, int hi) {
#pragma unroll
  for (int i = lo; i < hi; i++) {
    i64 c = s[i] >> 21;
    s[i] &= (1 << 21) - 1;
    s[i + 1] += c;
  }
}

// 64 LE bytes (as 8 words) -> 4 LE words of the canonical value mod l
FD_NOINLINE void sc_reduce64(uint64_t out[4], const uint64_t w[8]) {
  i64 s[24];
#pragma unroll
  for (int n = 0; n < 24; n++) {
    const int k = (21 * n) >> 6, sh = (21 * n) & 63;
    uint64_t v = w[k] >> sh;
    if (sh + 21 > 64 && k < 7) v |= w[k + 1] << (64 - sh);
    s[n] = n < 23 ? (i64)(v & ((1u << 21) - 1)) : (i64)v;
  }
  SC_FOLD(23) SC_FOLD(22) SC_FOLD(21) SC_FOLD(20) SC_FOLD(19) SC_FOLD(18)
  sc_carry21(s, 6, 17);
  SC_FOLD(17) SC_FOLD(16) SC_FOLD(15) SC_FOLD(14) SC_FOLD(13) SC_FOLD(12)
  sc_carry21(s, 0, 12);
  SC_FOLD(12)
  sc_carry21(s, 0, 12);
  SC_FOLD(12)
  sc_carry21(s, 0, 12);
  // value in (-delta, l): add l once when negative (s12 = -1)
  const i64 t = s[12] >> 1;
  s[0] += t * 666643;  s[1] += t * 470296;  s[2] += t * 654183;
  s[3] -= t * 997805;  s[4] += t * 136657;  s[5] -= t * 683901;
  s[12] -= t;
  sc_carry21(s, 0, 12);
  out[0] = out[1] = out[2] = out[3] = 0;
#pragma unroll
  for (int n = 0; n < 13; n++) {
    const int k = (21 * n) >> 6, sh = (21 * n) & 63;
    const uint64_t v = (uint64_t)s[n];
    out[k] |= v << sh;
    if (sh + 21 > 64 && k < 3) out[k + 1] |= v >> (64 - sh);
  }
}

FD_DEV int nibble(const uint64_t w[4], int j) {
  return (int)((w[j >> 4] >> (4 * (j & 15))) & 15);
}

// ---- points (ed25519.py _dbl / _madd_aff / _add_pre / _add_full) ---------

FD_DEV void ge_identity(ge &p) {
  fe_set(p.X, 0); fe_set(p.Y, 1); fe_set(p.Z, 1); fe_set(p.T, 0);
}

FD_NOINLINE void ge_dbl(ge &p, bool with_t) {
  fe a, b, c, e, f, g, h;
  fe_sq(a, p.X);
  fe_sq(b, p.Y);
  fe_sq(c, p.Z);
  fe_mul2(c, c);
  fe_add(h, a, b);
  fe_add(e, p.X, p.Y);
  fe_sq(e, e);
  fe_sub(e, h, e);
  fe_sub(g, a, b);
  fe_add(f, c, g);
  fe_mul(p.X, e, f);
  fe_mul(p.Y, g, h);
  fe_mul(p.Z, f, g);
  if (with_t) fe_mul(p.T, e, h);
}

// e = b - a, f = d - c, g = d + c, h = b + a; p = (ef, gh, fg, eh)
FD_DEV void ge_add_tail(ge &p, const fe &a, const fe &b, const fe &c,
                        const fe &d) {
  fe e, f, g, h;
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(p.X, e, f);
  fe_mul(p.Y, g, h);
  fe_mul(p.Z, f, g);
  fe_mul(p.T, e, h);
}

FD_NOINLINE void ge_madd_aff(ge &p, const pre_aff &q) {
  fe a, b, c, d;
  fe_sub(a, p.Y, p.X);
  fe_mul(a, a, q.ymx);
  fe_add(b, p.Y, p.X);
  fe_mul(b, b, q.ypx);
  fe_mul(c, p.T, q.t2d);
  fe_mul2(d, p.Z);
  ge_add_tail(p, a, b, c, d);
}

FD_NOINLINE void ge_add_pre(ge &p, const pre_proj &q) {
  fe a, b, c, d;
  fe_sub(a, p.Y, p.X);
  fe_mul(a, a, q.ymx);
  fe_add(b, p.Y, p.X);
  fe_mul(b, b, q.ypx);
  fe_mul(c, p.T, q.t2d);
  fe_mul(d, p.Z, q.z2);
  ge_add_tail(p, a, b, c, d);
}

FD_DEV void ge_add_full(ge &p, const ge &q) {
  fe a, b, c, d, t;
  fe_sub(a, p.Y, p.X);
  fe_sub(t, q.Y, q.X);
  fe_mul(a, a, t);
  fe_add(b, p.Y, p.X);
  fe_add(t, q.Y, q.X);
  fe_mul(b, b, t);
  fe_d2(t);
  fe_mul(c, p.T, t);
  fe_mul(c, c, q.T);
  fe_mul(d, p.Z, q.Z);
  fe_mul2(d, d);
  ge_add_tail(p, a, b, c, d);
}

FD_DEV void ge_to_pre(pre_proj &o, const ge &p) {
  fe d2;
  fe_sub(o.ymx, p.Y, p.X);
  fe_add(o.ypx, p.Y, p.X);
  fe_mul2(o.z2, p.Z);
  fe_d2(d2);
  fe_mul(o.t2d, p.T, d2);
}

// fixed-base table entry [j][w] of the (64, 16, 3, 10) int32 table in
// global memory (ops/params.py), read through the read-only cache
FD_DEV void fb_entry(pre_aff &q, const i32 *fb, int j, int w) {
  const i32 *e = fb + (int64_t)(j * 16 + w) * 30;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    q.ymx.v[i] = FD_LDG(e + i);
    q.ypx.v[i] = FD_LDG(e + 10 + i);
    q.t2d.v[i] = FD_LDG(e + 20 + i);
  }
}

FD_DEV void pre_identity(pre_proj &o) {
  fe_set(o.ymx, 1);
  fe_set(o.ypx, 1);
  fe_set(o.z2, 2);
  fe_set(o.t2d, 0);
}

// p = -(x, y, 1, t) and q its affine precomputed form: the first entry of
// a per-lane table of w(-P), and the step that builds the rest
// (ed25519._neg_table)
FD_DEV void ge_neg_start(ge &p, pre_aff &q, const fe &x, const fe &y,
                         const fe &t) {
  fe_neg(p.X, x);
  p.Y = y;
  fe_set(p.Z, 1);
  fe_neg(p.T, t);
  fe_sub(q.ymx, y, p.X);
  fe_add(q.ypx, y, p.X);
  fe_d2(q.t2d);
  fe_mul(q.t2d, p.T, q.t2d);
}

// ---- decompression -------------------------------------------------------

// RFC 8032 5.1.3 on exact y limbs (ed25519._recover_x): x with the sign
// applied; returns whether x^2 = (y^2 - 1)/(d y^2 + 1) has a root and the
// encoding is not (x = 0, sign = 1). y < p is the glue's byte compare.
FD_DEV bool recover_x(fe &x, const fe &y, int sign) {
  fe one, y2, u, v, v3, v7, t, vx2;
  fe_set(one, 1);
  fe_sq(y2, y);
  fe_sub(u, y2, one);
  fe_d(t);
  fe_mul(v, y2, t);
  fe_add(v, v, one);
  fe_sq(v3, v);
  fe_mul(v3, v3, v);
  fe_sq(v7, v3);
  fe_mul(v7, v7, v);
  fe_mul(t, u, v7);
  fe_pow_p58(t, t);
  fe_mul(x, u, v3);
  fe_mul(x, x, t);
  fe_sq(vx2, x);
  fe_mul(vx2, v, vx2);
  fe_sub(t, vx2, u);
  const bool root_ok = fe_is_zero(t);
  fe_add(t, vx2, u);
  const bool root_neg = fe_is_zero(t);
  fe_sqrtm1(t);
  fe_mul(t, x, t);
  fe_cmov(x, t, root_neg);
  fe xc;
  fe_canon(xc, x);
  i32 nz = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) nz |= xc.v[i];
  const bool ok = (root_ok || root_neg) && !(nz == 0 && sign == 1);
  fe_neg(t, x);
  fe_cmov(x, t, (xc.v[0] & 1) != sign);
  return ok;
}

// 32 encoded bytes -> (x, y, t = xy), Z = 1 implied; returns recover_x's
// verdict (ed25519._decode_xyt: decompression without the y < p compare)
FD_DEV bool ge_decompress(fe &x, fe &y, fe &t, const uint8_t *b) {
  uint64_t w[4];
  load_words(w, b, 4);
  fe_frombytes(y, w);
  const bool ok = recover_x(x, y, (int)(w[3] >> 63));
  fe_mul(t, x, y);
  return ok;
}

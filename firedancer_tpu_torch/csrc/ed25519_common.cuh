// Field, scalar and point device code shared by the ed25519 kernels
// (csrc/ed25519_verify.cu, csrc/ed25519_msm.cu), so that a fix such as
// the limb negation below lands in every kernel at once.
//
// Every function performs the same limb operations, in the same order,
// as its plain PyTorch counterpart in ops/fe25519.py and ops/ed25519.py
// (named beside each), so each kernel is held to its plain version bit
// for bit.
#pragma once
#include "prechecks.cuh"   // the build macros, load_words, the prechecks

typedef int32_t i32;
typedef int64_t i64;

struct fe { i32 v[10]; };
struct ge { fe X, Y, Z, T; };            // extended coordinates
struct pre_aff { fe ymx, ypx, t2d; };    // affine precomputed, Z = 1

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

// 21-bit digit n of an nw-word LE value; `last` keeps every bit from
// 21 n up (ed25519._digits21)
FD_DEV i64 sc_digit(const uint64_t *w, int nw, int n, bool last) {
  const int k = (21 * n) >> 6, sh = (21 * n) & 63;
  uint64_t v = w[k] >> sh;
  if (sh + 21 > 64 && k + 1 < nw) v |= w[k + 1] << (64 - sh);
  return last ? (i64)v : (i64)(v & ((1u << 21) - 1));
}

// non-negative 21-bit digits (the last may be wider) -> nw LE words,
// bits past the last word dropped (ed25519._digits_to_bytes)
FD_DEV void sc_pack(uint64_t *w, int nw, const i64 *s, int nd) {
  for (int k = 0; k < nw; k++) w[k] = 0;
  for (int n = 0; n < nd; n++) {
    const int k = (21 * n) >> 6, sh = (21 * n) & 63;
    const uint64_t v = (uint64_t)s[n];
    if (k < nw) w[k] |= v << sh;
    if (sh && k + 1 < nw) w[k + 1] |= v >> (64 - sh);
  }
}

// a (4 words, below 2^256) times z (2 words) mod l -> 4 words canonical
// (ed25519.sc_mul_mod_l): 13 x 7 digit products, carry, sc_reduce64
FD_NOINLINE void sc_mul_mod_l(uint64_t out[4], const uint64_t a[4],
                              const uint64_t z[2]) {
  i64 ad[13], zd[7], p[20];
  uint64_t w[8];
#pragma unroll
  for (int n = 0; n < 13; n++) ad[n] = sc_digit(a, 4, n, n == 12);
#pragma unroll
  for (int n = 0; n < 7; n++) zd[n] = sc_digit(z, 2, n, n == 6);
#pragma unroll
  for (int n = 0; n < 20; n++) p[n] = 0;
#pragma unroll
  for (int i = 0; i < 13; i++)
#pragma unroll
    for (int j = 0; j < 7; j++) p[i + j] += ad[i] * zd[j];
  sc_carry21(p, 0, 19);
  sc_pack(w, 8, p, 20);
  sc_reduce64(out, w);
}

// ---- points, one thread (ed25519.py _madd_aff / _add_full) --------------

FD_DEV void ge_identity(ge &p) {
  fe_set(p.X, 0); fe_set(p.Y, 1); fe_set(p.Z, 1); fe_set(p.T, 0);
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

// ---- one signature on a group of four threads ----------------------------
//
// Four consecutive threads of a warp carry one signature. Thread c of the
// group owns coordinate c (X, Y, Z, T) of each extended point, and
// component c of each precomputed table entry: c = 0 Y-X, 1 Y+X, 2 2dT,
// 3 2Z (projective entries; affine ones have no component 3). Each step
// of the point formulas is a round in which every thread performs at most
// one field multiply, with operands chosen by c through selects (no
// branch, so the warp does not diverge) and fetched inside the group with
// __shfl_sync. The group performs exactly the field operations of the
// one-thread functions above, operand order included, so every limb
// equals theirs and the plain versions' (ed25519.py _dbl, _madd_aff,
// _add_pre, _add_full, _to_pre, _neg_table).
//
// g4v<T> is a value each thread of the group holds its own copy of, and
// g4_each(f) runs f(c) for the calling thread's c. The host build (no
// nvcc) holds the four copies in an array and runs c = 0..3 one after
// another, so a round must read one g4v and write another: that proves
// the arithmetic here, and only the card proves the shuffles.

#ifdef __CUDACC__
template <class T> struct g4v {
  T v;
  FD_DEV T &operator[](int) { return v; }
  FD_DEV const T &operator[](int) const { return v; }
};

template <class F> FD_DEV void g4_each(F f) { f((int)(threadIdx.x & 3)); }

// o = thread `from`'s copy of s (`from` may differ across the group)
FD_DEV void g4_get(fe &o, const g4v<fe> &s, int from) {
#pragma unroll
  for (int i = 0; i < 10; i++)
    o.v[i] = __shfl_sync(0xffffffffu, s.v.v[i], from, 4);
}

FD_DEV i32 g4_get_i(const g4v<i32> &s, int from) {
  return __shfl_sync(0xffffffffu, s.v, from, 4);
}
#else
template <class T> struct g4v {
  T v[4];
  T &operator[](int c) { return v[c]; }
  const T &operator[](int c) const { return v[c]; }
};

template <class F> static inline void g4_each(F f) {
  for (int c = 0; c < 4; c++) f(c);
}

static inline void g4_get(fe &o, const g4v<fe> &s, int from) {
  o = s.v[from];
}

static inline i32 g4_get_i(const g4v<i32> &s, int from) { return s.v[from]; }
#endif

typedef g4v<fe> g4pt;     // an extended point, coordinate c on thread c

FD_DEV void g4_identity(g4pt &p) {
  g4_each([&](int c) { fe_set(p[c], (c == 1 || c == 2) ? 1 : 0); });
}

// precomputed identity (1, 1, 2, 0) as components (Y-X, Y+X, 2dT, 2Z)
FD_DEV void g4_pre_identity(g4v<fe> &o) {
  g4_each([&](int c) { fe_set(o[c], c == 3 ? 2 : (c == 2 ? 0 : 1)); });
}

// the second round of every formula: from (a, b, c, d) of round one,
// e = b - a, f = d - c, g = d + c, h = b + a (or, for a doubling,
// h = a + b, e = h - e', g = a - b, f = c + g); thread c then forms
// coordinate c: X = ef, Y = gh, Z = fg, T = eh
FD_DEV void g4_pick(fe &l, fe &m, const fe &e, const fe &f, const fe &g,
                    const fe &h, int c) {
  l = e;
  fe_cmov(l, g, c == 1);
  fe_cmov(l, f, c == 2);
  m = h;
  fe_cmov(m, f, c == 0);
  fe_cmov(m, g, c == 2);
}

FD_DEV void g4_tail(g4pt &p, const g4pt &r) {
  g4_each([&](int c) {
    fe a, b, cc, d, e, f, g, h, l, m;
    g4_get(a, r, 0);
    g4_get(b, r, 1);
    g4_get(cc, r, 2);
    g4_get(d, r, 3);
    fe_sub(e, b, a);
    fe_sub(f, d, cc);
    fe_add(g, d, cc);
    fe_add(h, b, a);
    g4_pick(l, m, e, f, g, h, c);
    fe_mul(p[c], l, m);
  });
}

// ed25519._dbl: round one X^2, Y^2, 2 Z^2, (X + Y)^2; round two as the
// tail
FD_DEV void g4_dbl(g4pt &p, bool with_t) {
  g4pt r;
  g4_each([&](int c) {
    fe x, y, s, u;
    g4_get(x, p, c == 3 ? 0 : c);
    g4_get(y, p, 1);
    fe_add(s, x, y);
    fe_cmov(x, s, c == 3);
    fe_sq(u, x);
    fe_mul2(s, u);
    fe_cmov(u, s, c == 2);
    r[c] = u;
  });
  g4_each([&](int c) {
    fe a, b, cc, e, f, g, h, l, m;
    g4_get(a, r, 0);
    g4_get(b, r, 1);
    g4_get(cc, r, 2);
    g4_get(e, r, 3);
    fe_add(h, a, b);
    fe_sub(e, h, e);
    fe_sub(g, a, b);
    fe_add(f, cc, g);
    g4_pick(l, m, e, f, g, h, c);
    fe_mul(a, l, m);
    fe_cmov(p[c], a, c < 3 || with_t);
  });
}

// ge_madd_aff (affine: thread 3 forms d = 2Z) and _add_pre (thread 3
// forms d = Z 2Z'): round one (Y-X) q0, (Y+X) q1, T q2, d; then the tail
FD_DEV void g4_add_q(g4pt &p, const g4v<fe> &q, bool affine) {
  g4pt r;
  g4_each([&](int c) {
    fe x, y, w, l, u;
    g4_get(x, p, 0);
    g4_get(y, p, 1);
    g4_get(w, p, c == 2 ? 3 : 2);        // T on thread 2, Z on thread 3
    fe_sub(l, y, x);
    fe_add(u, y, x);
    fe_cmov(l, u, c == 1);
    fe_cmov(l, w, c >= 2);
    fe_mul(u, l, q[c]);
    fe_mul2(l, w);
    fe_cmov(u, l, affine && c == 3);
    r[c] = u;
  });
  g4_tail(p, r);
}

FD_DEV void g4_madd_aff(g4pt &p, const g4v<fe> &q) { g4_add_q(p, q, true); }
FD_DEV void g4_add_pre(g4pt &p, const g4v<fe> &q) { g4_add_q(p, q, false); }

// ge_add_full: round one (Y1-X1)(Y2-X2), (Y1+X1)(Y2+X2), T1 2d, Z1 Z2;
// round two (T1 2d) T2 on thread 2 and 2 Z1 Z2 on thread 3; then the tail
FD_DEV void g4_add_full(g4pt &p, const g4pt &q) {
  g4pt r;
  g4_each([&](int c) {
    fe x, y, w, x2, y2, w2, l, m, u;
    g4_get(x, p, 0);
    g4_get(y, p, 1);
    g4_get(w, p, c == 2 ? 3 : 2);
    g4_get(x2, q, 0);
    g4_get(y2, q, 1);
    g4_get(w2, q, c == 2 ? 3 : 2);
    fe_sub(l, y, x);
    fe_sub(m, y2, x2);
    fe_add(u, y, x);
    fe_cmov(l, u, c == 1);
    fe_add(u, y2, x2);
    fe_cmov(m, u, c == 1);
    fe_cmov(l, w, c >= 2);
    fe_d2(u);
    fe_cmov(m, u, c == 2);
    fe_cmov(m, w2, c == 3);
    fe_mul(u, l, m);
    fe_mul(l, u, w2);
    fe_cmov(u, l, c == 2);
    fe_mul2(l, u);
    fe_cmov(u, l, c == 3);
    r[c] = u;
  });
  g4_tail(p, r);
}

// component c of the precomputed form of p (ed25519._to_pre)
FD_DEV void g4_to_pre(g4v<fe> &o, const g4pt &p) {
  g4_each([&](int c) {
    fe x, y, w, l, u;
    g4_get(x, p, 0);
    g4_get(y, p, 1);
    g4_get(w, p, c == 2 ? 3 : 2);
    fe_sub(l, y, x);
    fe_add(u, y, x);
    fe_cmov(l, u, c == 1);
    fe_d2(u);
    fe_mul(u, w, u);
    fe_cmov(l, u, c == 2);
    fe_mul2(u, w);
    fe_cmov(l, u, c == 3);
    o[c] = l;
  });
}

// p = -(x, y, 1, t) and q its affine precomputed form, from thread
// `src`'s decompressed (x, y, t): the first entry of a table of w(-P),
// and the step that builds the rest (ed25519._neg_table)
FD_DEV void g4_neg_start(g4pt &p, g4v<fe> &q, const g4v<fe> &xs,
                         const g4v<fe> &ys, const g4v<fe> &ts, int src) {
  g4_each([&](int c) {
    fe x, y, t, nx, nt, l, u;
    g4_get(x, xs, src);
    g4_get(y, ys, src);
    g4_get(t, ts, src);
    fe_neg(nx, x);
    fe_neg(nt, t);
    l = nx;
    fe_cmov(l, y, c == 1);
    fe_set(u, 1);
    fe_cmov(l, u, c == 2);
    fe_cmov(l, nt, c == 3);
    p[c] = l;
    fe_sub(l, y, nx);
    fe_add(u, y, nx);
    fe_cmov(l, u, c == 1);
    fe_d2(u);
    fe_mul(u, nt, u);
    fe_cmov(l, u, c >= 2);
    q[c] = l;
  });
}

// component c (< 3) of fixed-base entry [j][w] (fb_entry)
FD_DEV void fb_comp(fe &o, const i32 *fb, int j, int w, int c) {
  const i32 *e = fb + (int64_t)(j * 16 + w) * 30 + 10 * c;
#pragma unroll
  for (int i = 0; i < 10; i++) o.v[i] = FD_LDG(e + i);
}

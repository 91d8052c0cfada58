// The field of kernels 2, 3, 4 and 6 at every K and of the Edwards
// kernels 7, 6-ed, 8a and 8b at K = 8 and 14: a group of TPI neighbouring
// threads of a warp carries one lane (sm_90a); the shape tables at the
// end of this file set TPI and INLINE at each K, one table a kernel
// family. The kernel and launcher of the one-formula kernels (2, 3, 8a,
// 8b) are at the end too.
//
// Thread j of a group (j = 0 .. TPI-1) holds limbs j*L .. j*L+L-1 of every
// field element, L = ceil(K / TPI); the limbs from K up to L*TPI (K = 7,
// 14 and 17 at TPI = 4) are zero in every operand, in p and in every
// result.
// Values, layout and domain are field.cuh's: canonical residues in the
// Montgomery domain R = 2^(32K), so a group's result is bit for bit the
// one-thread field's and the plain version's.
//
// Why: one thread a lane gives 8192 lanes 64 blocks of 128 threads, 64 of
// the H100's 132 SMs with one warp a scheduler, and a K-limb product is a
// dependent chain of 2K^2 multiply-adds in one thread (255 registers and
// spills at K >= 14). Four threads a lane give 256 blocks of 128, every
// SM two of them, two threads 256 blocks of 64; each thread's share of an
// element is L = 2 to 5 registers and each carry chain L limbs long. Where
// four threads would pad K (6 to 8 limbs, 10 to 12) two threads ran
// faster on an H100 80GB HBM3 at 700 W (GroupShape below).
//
// The product is the operand-scanning Montgomery form (CIOS) spread over
// the group, one row per limb a_i of a, exactly K rows (so R stays
// 2^(32K)): the owner of a_i broadcasts it (__shfl_sync), each thread adds
// a_i * b to its L words; thread 0's low word gives m = t_0 * p', which it
// broadcasts, and each thread adds m * p; then the row shifts one word
// down the group (each thread takes its upper neighbour's low word). What
// runs out of a thread's top word stays in a carry word beside its limbs
// (t) and moves with the shift; after the K rows the carry words are added
// into the next thread's limbs and the carries between threads resolved
// by one carry-lookahead over the group's ballots (generate and propagate
// bits added as integers), then one conditional subtraction of p. The
// point formulas ask for independent products in pairs (mul2), and the
// group computes a pair row by row together, so that one product's
// multiply-adds issue while the other's shuffles wait: on the H100 the
// window loop ran 3-12% faster so than one product at a time. A product
// is a call (gf_mul, gf_mul2), one copy of its code for the whole loop,
// or inlined (INLINE): on the H100 (700 W) calls were up to 9% faster at
// K >= 14, up to 5% slower at K = 12, 2-7% slower at K = 6 to 8 with four
// threads a lane and 1.3-1.45x faster at K = 7, 8 and 10 with two.
// Additions, subtractions, the conditional subtraction and "is zero" take
// their carries, borrows and answers from the same votes, so all TPI
// threads take the same select.
//
// Every thread of a warp must run every call, together: the shuffles and
// ballots take the whole warp's mask. A kernel keeps the threads past its
// last lane alive (they repeat the last lane and do not store), and no
// code branches on a thread's place in its group (gi): a branch that the
// compiler hoists out of a loop splits the warp, and every shuffle after
// it then takes the compiler's slow path for a diverged warp. Selects on
// gi are written as masks.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "field.cuh"

namespace ecc {

constexpr unsigned kFullMask = 0xffffffffu;

// One thread's L limbs of a field element.
template <int L>
struct Slice {
  uint32_t v[L];
};

// INLINE: each product inlined where it is used (mul_rows) rather than a
// call of gf_mul or gf_mul2.
template <int K, int TPI, bool INLINE = false>
struct GroupField;

// The product and two independent products as calls of their operands,
// p's slice and p' (by value, so that a call passes them in registers):
// one copy of each serves every product of the window loop.
template <int K, int TPI, int L = (K + TPI - 1) / TPI>
__device__ __noinline__ Slice<L> gf_mul(Slice<L> a, Slice<L> b, Slice<L> p,
                                        uint32_t pinv);
template <int K, int TPI, int L = (K + TPI - 1) / TPI>
__device__ __noinline__ Two<Slice<L>> gf_mul2(Slice<L> a, Slice<L> b,
                                              Slice<L> c, Slice<L> d,
                                              Slice<L> p, uint32_t pinv);

template <int K, int TPI, bool INLINE>
struct GroupField {
  static_assert(TPI >= 2 && TPI <= 16 && (TPI & (TPI - 1)) == 0,
                "a group is 2, 4, 8 or 16 threads of one warp");
  static constexpr int kLimbs = K;
  static constexpr bool kInlineProducts = INLINE;  // else gf_mul, gf_mul2
  static constexpr int L = (K + TPI - 1) / TPI;
  static constexpr int KP = L * TPI;         // limbs with the zero padding
  using E = Slice<L>;

  // The curve's constants in shared memory, each KP words (zero padded):
  // p and one, then a, a^2 and 3b from a CurveCtx (short Weierstrass) or d
  // and 2d from an EdCurveCtx (twisted Edwards; the slots of the other
  // context stay unwritten).
  enum { kP = 0, kOne, kA, kA2, kB3, kD, kD2, kNumConsts };
  static constexpr int kSharedWords = kNumConsts * KP;

  const uint32_t* cs;      // the block's constants (shared memory)
  E p;                     // this thread's limbs of p
  uint32_t pinv;           // -p^-1 mod 2^32
  int gi;                  // this thread's index in its group
  int gshift;              // the warp lane of the group's thread 0

  // Thread 0 of the block writes the constants; every thread must call it
  // (it ends with __syncthreads).
  static __device__ __forceinline__ void stage(uint32_t* sh,
                                               const CurveCtx<K>& C) {
    if (threadIdx.x == 0) {
      put(sh, kP, C.f.p);
      put(sh, kOne, C.one);
      put(sh, kA, C.a);
      put(sh, kA2, C.a2);
      put(sh, kB3, C.b3);
    }
    __syncthreads();
  }

  static __device__ __forceinline__ void stage(uint32_t* sh,
                                               const EdCurveCtx<K>& C) {
    if (threadIdx.x == 0) {
      put(sh, kP, C.f.p);
      put(sh, kOne, C.one);
      put(sh, kD, C.d);
      put(sh, kD2, C.d2);
    }
    __syncthreads();
  }

  // One constant into its slot, zero padded to KP words.
  static __device__ __forceinline__ void put(uint32_t* sh, int slot,
                                             const uint32_t (&v)[K]) {
#pragma unroll
    for (int i = 0; i < KP; ++i) sh[slot * KP + i] = i < K ? v[i] : 0u;
  }

  __device__ __forceinline__ GroupField(const uint32_t* sh, uint32_t pinv_)
      : cs(sh), pinv(pinv_) {
    const int wl = threadIdx.x & 31;
    gi = wl & (TPI - 1);
    gshift = wl & ~(TPI - 1);
    p = constant(kP);
  }

  // gf_mul's, which has no constants but p.
  __device__ __forceinline__ GroupField(const E& p_, uint32_t pinv_)
      : cs(nullptr), p(p_), pinv(pinv_) {
    const int wl = threadIdx.x & 31;
    gi = wl & (TPI - 1);
    gshift = wl & ~(TPI - 1);
  }

  __device__ __forceinline__ E constant(int which) const {
    E r;
#pragma unroll
    for (int k = 0; k < L; ++k) r.v[k] = cs[which * KP + gi * L + k];
    return r;
  }

  // The carries between the group's threads: g, this thread's segment
  // produces a carry (or borrow) of its own; pr, it passes one through
  // (all ones for a carry, all zeros for a borrow). Returns the carry into
  // this thread's segment; out is the carry out of the group's top.
  __device__ __forceinline__ uint32_t resolve(bool g, bool pr,
                                              bool& out) const {
    constexpr unsigned gm = (1u << TPI) - 1u;
    const unsigned G = (__ballot_sync(kFullMask, g) >> gshift) & gm;
    const unsigned P = (__ballot_sync(kFullMask, pr) >> gshift) & gm;
    const unsigned X = G | P;
    const unsigned S = X + G;            // bit j's carry-in is thread j's
    out = ((S >> TPI) & 1u) != 0u;
    return ((S ^ X ^ G) >> gi) & 1u;
  }

  // x + c (one word) in place within the segment; returns the carry out.
  static __device__ __forceinline__ uint32_t add_word(uint32_t (&x)[L],
                                                      uint32_t c) {
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const uint64_t s = (uint64_t)x[k] + c;
      x[k] = (uint32_t)s;
      c = (uint32_t)(s >> 32);
    }
    return c;
  }

  static __device__ __forceinline__ void sub_word(uint32_t (&x)[L],
                                                  uint32_t b) {
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const uint64_t v = (uint64_t)x[k] - b;
      x[k] = (uint32_t)v;
      b = (uint32_t)(v >> 63);
    }
  }

  static __device__ __forceinline__ bool all_ones(const uint32_t (&x)[L]) {
    uint32_t a = 0xffffffffu;
#pragma unroll
    for (int k = 0; k < L; ++k) a &= x[k];
    return a == 0xffffffffu;
  }

  static __device__ __forceinline__ bool all_zero(const uint32_t (&x)[L]) {
    uint32_t a = 0u;
#pragma unroll
    for (int k = 0; k < L; ++k) a |= x[k];
    return a == 0u;
  }

  // x + top * 2^(32 KP), known < 2p  ->  value mod p (field.cuh's
  // cond_sub_p over the group: one vote for the borrow of x - p).
  __device__ __forceinline__ E cond_sub_p(const uint32_t (&x)[L],
                                          bool top) const {
    uint32_t d[L];
    uint32_t b = 0;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const uint64_t v = (uint64_t)x[k] - p.v[k] - b;
      d[k] = (uint32_t)v;
      b = (uint32_t)(v >> 63);
    }
    bool bout;
    const uint32_t bin = resolve(b != 0u, b == 0u && all_zero(d), bout);
    sub_word(d, bin);
    const bool ge = top || !bout;
    E r;
#pragma unroll
    for (int k = 0; k < L; ++k) r.v[k] = ge ? d[k] : x[k];
    return r;
  }

  __device__ __forceinline__ E add(const E& a, const E& b) const {
    uint32_t s[L];
    uint32_t c = 0;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const uint64_t v = (uint64_t)a.v[k] + b.v[k] + c;
      s[k] = (uint32_t)v;
      c = (uint32_t)(v >> 32);
    }
    bool top;
    const uint32_t cin = resolve(c != 0u, c == 0u && all_ones(s), top);
    add_word(s, cin);
    return cond_sub_p(s, top);
  }

  __device__ __forceinline__ E sub(const E& a, const E& b) const {
    uint32_t d[L];
    uint32_t bw = 0;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const uint64_t v = (uint64_t)a.v[k] - b.v[k] - bw;
      d[k] = (uint32_t)v;
      bw = (uint32_t)(v >> 63);
    }
    bool neg;
    const uint32_t bin = resolve(bw != 0u, bw == 0u && all_zero(d), neg);
    sub_word(d, bin);
    // add p back where the difference went negative (mask, no branch)
    const uint32_t mask = neg ? 0xffffffffu : 0u;
    E r;
    uint32_t c = 0;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const uint64_t v = (uint64_t)d[k] + (p.v[k] & mask) + c;
      r.v[k] = (uint32_t)v;
      c = (uint32_t)(v >> 32);
    }
    bool wrap;
    const uint32_t cin = resolve(c != 0u, c == 0u && all_ones(r.v), wrap);
    add_word(r.v, cin);
    return r;
  }

  // a[i] * b[i] * R^-1 mod p, R = 2^(32K), for canonical operands: the
  // group CIOS above, NP independent products row by row together, so that
  // one's shuffles wait while another's multiply-adds issue. Row
  // i = j*L + k: a_i is limb k of thread j.
  template <int NP>
  __device__ __forceinline__ void mul_rows(const E (&a)[NP],
                                           const E (&b)[NP],
                                           E (&out)[NP]) const {
    uint32_t r[NP][L];
    uint32_t t0[NP], t1[NP];   // the carry words t = t0 + t1 * 2^32
#pragma unroll
    for (int x = 0; x < NP; ++x) {
      t0[x] = t1[x] = 0u;
#pragma unroll
      for (int k = 0; k < L; ++k) r[x][k] = 0u;
    }
#pragma unroll 1
    for (int j = 0; j < TPI; ++j) {
#pragma unroll
      for (int k = 0; k < L; ++k) {
        if (KP != K && j * L + k >= K) break;   // the same in every thread
#pragma unroll
        for (int x = 0; x < NP; ++x) {
          const uint32_t ai = __shfl_sync(kFullMask, a[x].v[k], j, TPI);
          uint64_t c = 0;
#pragma unroll
          for (int q = 0; q < L; ++q) {
            const uint64_t s = (uint64_t)ai * b[x].v[q] + r[x][q] + c;
            r[x][q] = (uint32_t)s;
            c = s >> 32;
          }
          uint64_t s = (uint64_t)t0[x] + c;
          t0[x] = (uint32_t)s;
          t1[x] += (uint32_t)(s >> 32);
          const uint32_t m = __shfl_sync(kFullMask, r[x][0] * pinv, 0, TPI);
          c = 0;
#pragma unroll
          for (int q = 0; q < L; ++q) {
            const uint64_t u = (uint64_t)m * p.v[q] + r[x][q] + c;
            r[x][q] = (uint32_t)u;
            c = u >> 32;
          }
          s = (uint64_t)t0[x] + c;
          t0[x] = (uint32_t)s;
          t1[x] += (uint32_t)(s >> 32);
          // shift one word down the group: thread j takes thread j+1's low
          // word, and the top thread (the source wraps to thread 0) thread
          // 0's, which this row made zero; no branch on gi, which would
          // split the warp and send every shuffle down the diverged path
          const uint32_t in = __shfl_sync(kFullMask, r[x][0], gi + 1, TPI);
#pragma unroll
          for (int q = 0; q + 1 < L; ++q) r[x][q] = r[x][q + 1];
          s = (uint64_t)t0[x] + in;
          r[x][L - 1] = (uint32_t)s;
          t0[x] = t1[x] + (uint32_t)(s >> 32);
          t1[x] = 0u;
        }
      }
    }
    // the carry words into the next thread's limbs (thread 0 takes none);
    // the top thread's is the value's top word (nonzero only where
    // KP == K), which counts as a carry out of the group
    const uint32_t not_first = ~(uint32_t)((gi - 1) >> 31);      // gi > 0
    const uint32_t is_top = 0u - (uint32_t)((gi + 1) / TPI);   // gi = TPI-1
#pragma unroll
    for (int x = 0; x < NP; ++x) {
      const uint32_t w = __shfl_sync(kFullMask, t0[x], gi + TPI - 1, TPI);
      uint32_t g = add_word(r[x], w & not_first);
      g |= t0[x] & is_top;
      bool top;
      const uint32_t c2 = resolve(g != 0u, g == 0u && all_ones(r[x]), top);
      add_word(r[x], c2);
      out[x] = cond_sub_p(r[x], top);
    }
  }

  __device__ __forceinline__ E mul(const E& a, const E& b) const {
    if constexpr (INLINE) {
      const E x[1] = {a}, y[1] = {b};
      E o[1];
      mul_rows<1>(x, y, o);
      return o[0];
    } else {
      return gf_mul<K, TPI>(a, b, p, pinv);
    }
  }
  // two independent products, computed together
  __device__ __forceinline__ Two<E> mul2(const E& a, const E& b, const E& c,
                                         const E& d) const {
    if constexpr (INLINE) {
      const E x[2] = {a, c}, y[2] = {b, d};
      E o[2];
      mul_rows<2>(x, y, o);
      return {o[0], o[1]};
    } else {
      return gf_mul2<K, TPI>(a, b, c, d, p, pinv);
    }
  }
  __device__ __forceinline__ Two<E> sqr2(const E& a, const E& c) const {
    return mul2(a, a, c, c);
  }
  __device__ __forceinline__ Two<E> sqr_mul(const E& a, const E& c,
                                            const E& d) const {
    return mul2(a, a, c, d);
  }
  __device__ __forceinline__ E sqr(const E& a) const { return mul(a, a); }
  __device__ __forceinline__ E a() const { return constant(kA); }
  __device__ __forceinline__ E a2() const { return constant(kA2); }
  __device__ __forceinline__ E b3() const { return constant(kB3); }
  __device__ __forceinline__ E one() const { return constant(kOne); }
  __device__ __forceinline__ E d() const { return constant(kD); }
  __device__ __forceinline__ E d2() const { return constant(kD2); }
  __device__ __forceinline__ E zero() const {
    E r;
#pragma unroll
    for (int k = 0; k < L; ++k) r.v[k] = 0u;
    return r;
  }

  __device__ __forceinline__ bool is_zero(const E& a) const {
    constexpr unsigned gm = (1u << TPI) - 1u;
    return ((__ballot_sync(kFullMask, all_zero(a.v)) >> gshift) & gm) == gm;
  }

  // c must be the same in every thread of the group (a vote's answer).
  __device__ __forceinline__ E select(bool c, const E& a, const E& b) const {
    E r;
#pragma unroll
    for (int k = 0; k < L; ++k) r.v[k] = c ? a.v[k] : b.v[k];
    return r;
  }

  // This thread's limbs of lane `lane` of a uint32[K][n] batch; a limb
  // past K reads row K - 1 and is masked to zero (no branch on gi).
  __device__ __forceinline__ E load(const uint32_t* __restrict__ base,
                                    long long n, long long lane) const {
    E r;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int i = gi * L + k;
      const uint32_t v = base[(i < K ? i : K - 1) * n + lane];
      r.v[k] = (KP == K || i < K) ? v : 0u;
    }
    return r;
  }

  __device__ __forceinline__ void store(uint32_t* __restrict__ base,
                                        long long n, long long lane,
                                        const E& x) const {
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int i = gi * L + k;
      if (KP == K || i < K) base[i * n + lane] = x.v[k];
    }
  }
};

template <int K, int TPI, int L>
__device__ __noinline__ Slice<L> gf_mul(Slice<L> a, Slice<L> b, Slice<L> p,
                                        uint32_t pinv) {
  const Slice<L> x[1] = {a}, y[1] = {b};
  Slice<L> o[1];
  GroupField<K, TPI>(p, pinv).template mul_rows<1>(x, y, o);
  return o[0];
}

template <int K, int TPI, int L>
__device__ __noinline__ Two<Slice<L>> gf_mul2(Slice<L> a, Slice<L> b,
                                              Slice<L> c, Slice<L> d,
                                              Slice<L> p, uint32_t pinv) {
  const Slice<L> x[2] = {a, c}, y[2] = {b, d};
  Slice<L> o[2];
  GroupField<K, TPI>(p, pinv).template mul_rows<2>(x, y, o);
  return {o[0], o[1]};
}

// The shape of a kernel on the group field: threads a lane (TPI), threads
// a block and whether the products are inlined (INLINE) or calls of
// gf_mul and gf_mul2. __launch_bounds__ asks for 512 / THREADS resident
// blocks an SM, so that a thread gets at most 128 registers (on the H100
// a 255-register cap ran within 1% of it; PERF.md, section 6).
template <int TPI, int THREADS, bool INLINE>
struct Shape {
  static_assert(THREADS % 32 == 0 && 512 % THREADS == 0,
                "a block is whole warps and divides 512 threads");
  static constexpr int kTPI = TPI;
  static constexpr int kThreads = THREADS;
  static constexpr int kMinBlocks = 512 / THREADS;
  static constexpr bool kInline = INLINE;
};

// The shape tables, the one place that sets each kernel's shape at each
// K, as scripts/time_group_loop.py measured them at 8192 lanes on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 6).
//
// GroupShape: the window loops (windowed.cuh) of kernels 4 and 6 and of
// the Edwards kernels 7 and 6-ed. K >= 12: four threads a lane in blocks
// of 128, products called. K = 6 and 10: two threads a lane, products
// called; four pad K to 8 and 12 limbs, and ran 1.14-1.31x slower. K = 8:
// four threads a lane, products inlined, 2-7% faster than calls and 2-5%
// faster than two threads a lane (Ed25519's kernel 6-ed: within 0.3% of
// two threads with calls, 1.4% ahead of four with calls; Ed25519's kernel
// 7: two or four threads with calls 0.3-0.4% faster, within noise, two
// inlined 12% slower). K = 7: the same shape; two threads a lane came
// within 2.5% either way.
template <int K>
struct GroupShape : Shape<4, 128, false> {};
template <> struct GroupShape<6> : Shape<2, 64, false> {};
template <> struct GroupShape<7> : Shape<4, 128, true> {};
template <> struct GroupShape<8> : Shape<4, 128, true> {};
template <> struct GroupShape<10> : Shape<2, 64, false> {};

// AddShape: kernels 2, 3, 8a and 8b, one point formula a lane (the
// complete add or double, formula_group_kernel below). Measured on the
// adds:
// K = 7, 8 and K >= 12: four threads a lane in blocks of 128, products
// inlined (0-4% faster than calls; two threads a lane ran 1.13-1.50x
// slower at K >= 12, eight 1.19-1.61x slower at every K).
// K = 6 and 10: two threads a lane, products called, 1.08-1.21x faster
// than four inlined. One thread a lane was slower at every K: 1.24-1.34x
// at K = 6 and 7, 1.5-3.5x above. The Edwards add (8a) at K = 8 and 14
// ran fastest in the same shape: four called +1.0-1.5%, two called equal
// at K = 8 and 1.27x slower at K = 14, eight inlined 1.18-1.25x slower;
// one thread a lane 1.54x (K = 8) and 2.46x (K = 14) slower. The doubles
// (3, 8b) share the table: two threads called came 2.0-4.5% ahead on
// three instances (secp224k1 at K = 7, secp256k1 at K = 8, Ed448's 8b at
// K = 14) but behind on the others at the same K (up to 1.22x on WEI448's
// kernel 3), and no other shape led at any K, so a table of their own,
// keyed by K as this one is, would be the same table.
template <int K>
struct AddShape : Shape<4, 128, true> {};
template <> struct AddShape<6> : Shape<2, 64, false> {};
template <> struct AddShape<10> : Shape<2, 64, false> {};

// Run launch(std::integral_constant<int, AK>{}) for the formula set AK
// among AKs (the ones a library is built with) that is the curve's a_kind,
// nothing for n <= 0, and return the CUDA error code. Another a_kind
// launches nothing and returns cudaErrorInvalidValue.
template <int AK, int... Rest, typename F>
int launch_for_a(int a_kind, long long n, F&& launch) {
  if (a_kind == AK) {
    if (n > 0) launch(std::integral_constant<int, AK>{});
    return (int)cudaGetLastError();
  }
  if constexpr (sizeof...(Rest) > 0) {
    return launch_for_a<Rest...>(a_kind, n, launch);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

// A kernel's N coordinate rows (device pointers, each uint32[K][n]), passed
// by value.
template <int N>
struct InRows {
  const uint32_t* p[N];
};
template <int N>
struct OutRows {
  uint32_t* p[N];
};

// One point formula a lane on the group field, in the shape AddShape<K>:
// kernels 2 and 3 (point.cuh's PointAdd, PointDbl) and 8a and 8b
// (edpoint.cu's EdAdd, EdDbl). Op names the curve context (Op::Ctx<K>),
// the Op::kIn coordinates it reads and the Op::kOut it writes, and
// Op::apply<AK>(f, in, out) runs the formula: the same template text as
// the one-thread kernel's, so the output is that kernel's bit for bit.
// Why: one thread a lane gives 8192 lanes 32 blocks of 256, on 32 of the
// 132 SMs, each product one thread's chain of 2K^2 multiply-adds, and
// spills at K >= 14; a group of four gives 256 blocks of 128 and at most
// 128 registers a thread. A block of THREADS threads carries THREADS / TPI
// lanes; the threads past lane n - 1 (in the last block) repeat lane
// n - 1 and do not store, so that every warp's shuffles and votes see all
// 32 threads (no early return, no branch on the thread's place in its
// group or on the data).
template <class Op, int K, int AK>
__global__ void __launch_bounds__(AddShape<K>::kThreads,
                                  AddShape<K>::kMinBlocks)
formula_group_kernel(const typename Op::template Ctx<K> C,
                     const InRows<Op::kIn> in, const OutRows<Op::kOut> out,
                     long long n) {
  using S = AddShape<K>;
  using GF = GroupField<K, S::kTPI, S::kInline>;
  __shared__ uint32_t consts[GF::kSharedWords];
  GF::stage(consts, C);
  const GF f(consts, C.f.pinv);
  const long long g =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / S::kTPI;
  const long long lane = g < n ? g : n - 1;
  typename GF::E a[Op::kIn], r[Op::kOut];
#pragma unroll
  for (int i = 0; i < Op::kIn; ++i) a[i] = f.load(in.p[i], n, lane);
  Op::template apply<AK>(f, a, r);
  if (g < n) {
#pragma unroll
    for (int i = 0; i < Op::kOut; ++i) f.store(out.p[i], n, lane, r[i]);
  }
}

// The formula Op at K for the formula sets AKs, in the shape AddShape<K>.
// in, out: Op::kIn and Op::kOut device pointers. The C entry points of
// kernels 2, 3, 8a and 8b call this one; naming the one-thread launcher
// in its place in their text gives the one-thread build
// (scripts/time_group_loop.py).
template <class Op, int K, int... AKs>
int launch_group(const typename Op::template Ctx<K>* C,
                 const uint32_t* const* in, uint32_t* const* out,
                 long long n, void* stream) {
  using S = AddShape<K>;
  const long long lanes = S::kThreads / S::kTPI;   // a block's lanes
  return launch_for_a<AKs...>(C->a_kind, n, [&](auto ak) {
    InRows<Op::kIn> i;
    OutRows<Op::kOut> o;
    for (int k = 0; k < Op::kIn; ++k) i.p[k] = in[k];
    for (int k = 0; k < Op::kOut; ++k) o.p[k] = out[k];
    formula_group_kernel<Op, K, decltype(ak)::value>
        <<<(unsigned)((n + lanes - 1) / lanes), S::kThreads, 0,
           (cudaStream_t)stream>>>(*C, i, o, n);
  });
}

}  // namespace ecc

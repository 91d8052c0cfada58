// Prime-field arithmetic for the port's CUDA kernels (sm_90a).
//
// Layout: a batch of field elements is uint32[K][N], limb-major, 32-bit
// limbs least significant first (the int32 tensors of libecc_tpu_torch,
// read bit for bit). Every function takes and returns CANONICAL residues
// (< p) in the Montgomery domain R = 2^(32K), so results compare bitwise
// with the plain PyTorch versions and "is zero" is a limb compare.
//
// These __device__ functions are kernel 1's body and, through ThreadField,
// the field layer of the kernels where one thread carries a lane: kernels
// 2, 3 and 5 (point.cuh), and the Edwards kernels 8a, 8b, 8c and 7 and
// 6-ed at K = 8 (edpoint.cuh, windowed.cuh); kernels 4 and 6 take it only
// in scripts/time_group_loop.py's one-thread build. groupfield.cuh holds
// the field where a group of threads carries a lane (kernels 4 and 6 at
// every K, 7 and 6-ed at K = 14). They replace the
// TPU's relaxed 15-bit-limb arithmetic
// (libecc_tpu/ops/pallas/mont.py:_mont_body_refs), whose float32
// exact-carry trick exists for the TPU's vector unit; Hopper has 32x32->64
// integer multiplies and carries, so a product here is a schoolbook (or
// squaring) product followed by a word-serial Montgomery reduction and one
// conditional subtraction.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ecc {

// Modulus by value: p and p' = -p^-1 mod 2^32. One binary serves p and q.
template <int K>
struct FieldCtx {
  uint32_t p[K];
  uint32_t pinv;
};

// Curve constants for the point kernels, all Montgomery-form canonical.
// a_kind: 0 generic a, 1 a = -3, 2 a = 0 (selects the formula set).
template <int K>
struct CurveCtx {
  FieldCtx<K> f;
  uint32_t one[K];
  uint32_t a[K];
  uint32_t a2[K];
  uint32_t b3[K];
  int32_t a_kind;
};

enum AKind { A_GENERIC = 0, A_M3 = 1, A_ZERO = 2 };

// Twisted-Edwards curve constants (edpoint.cuh), all Montgomery-form
// canonical. a_kind is ED_A_M1 for a = -1 and ED_A_1 for a = 1; the entry
// points refuse any other value.
template <int K>
struct EdCurveCtx {
  FieldCtx<K> f;
  uint32_t one[K];
  uint32_t d2[K];
  uint32_t d[K];
  int32_t a_kind;
};

constexpr int32_t ED_A_M1 = 1;
constexpr int32_t ED_A_1 = 2;

template <int K>
struct Fe {
  uint32_t v[K];
};

template <int K>
__device__ __forceinline__ Fe<K> load_fe(const uint32_t* __restrict__ base,
                                         long long n, long long lane) {
  Fe<K> r;
#pragma unroll
  for (int i = 0; i < K; ++i) r.v[i] = base[i * n + lane];
  return r;
}

template <int K>
__device__ __forceinline__ void store_fe(uint32_t* __restrict__ base,
                                         long long n, long long lane,
                                         const Fe<K>& x) {
#pragma unroll
  for (int i = 0; i < K; ++i) base[i * n + lane] = x.v[i];
}

template <int K>
__device__ __forceinline__ Fe<K> fe_const(const uint32_t (&c)[K]) {
  Fe<K> r;
#pragma unroll
  for (int i = 0; i < K; ++i) r.v[i] = c[i];
  return r;
}

template <int K>
__device__ __forceinline__ Fe<K> fe_zero() {
  Fe<K> r;
#pragma unroll
  for (int i = 0; i < K; ++i) r.v[i] = 0u;
  return r;
}

template <int K>
__device__ __forceinline__ bool is_zero(const Fe<K>& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) acc |= a.v[i];
  return acc == 0u;
}

template <int K>
__device__ __forceinline__ Fe<K> fe_select(bool c, const Fe<K>& a,
                                           const Fe<K>& b) {
  Fe<K> r;
#pragma unroll
  for (int i = 0; i < K; ++i) r.v[i] = c ? a.v[i] : b.v[i];
  return r;
}

// x + top * 2^(32K), known < 2p  ->  value mod p. Where p's top limb is
// 0xFFFFFFFF (P-256, and Ed448's p = 2^448 - 2^224 - 1 at K = 14) a sum
// or a Montgomery result can pass 2^(32K); then top = 1, the value is
// certainly >= p, and x - p (mod 2^(32K)) is the residue.
template <int K>
__device__ __forceinline__ Fe<K> cond_sub_p(const uint32_t* x, uint32_t top,
                                            const FieldCtx<K>& f) {
  uint32_t d[K];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    uint64_t v = (uint64_t)x[i] - f.p[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  const bool ge = (top != 0u) || (borrow == 0u);
  Fe<K> r;
#pragma unroll
  for (int i = 0; i < K; ++i) r.v[i] = ge ? d[i] : x[i];
  return r;
}

template <int K>
__device__ __forceinline__ Fe<K> fadd(const Fe<K>& a, const Fe<K>& b,
                                      const FieldCtx<K>& f) {
  uint32_t s[K];
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    uint64_t v = (uint64_t)a.v[i] + b.v[i] + c;
    s[i] = (uint32_t)v;
    c = (uint32_t)(v >> 32);
  }
  return cond_sub_p<K>(s, c, f);
}

template <int K>
__device__ __forceinline__ Fe<K> fsub(const Fe<K>& a, const Fe<K>& b,
                                      const FieldCtx<K>& f) {
  uint32_t d[K];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    uint64_t v = (uint64_t)a.v[i] - b.v[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  // add p back where the difference went negative (mask, no branch)
  const uint32_t mask = 0u - borrow;
  Fe<K> r;
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    uint64_t v = (uint64_t)d[i] + (f.p[i] & mask) + c;
    r.v[i] = (uint32_t)v;
    c = (uint32_t)(v >> 32);
  }
  return r;
}

// Word-serial Montgomery reduction of a 2K-word product t (t < R*p):
// K rows of m = t_i * p' and t += m * p * 2^(32i); the carry out of each
// row's top word is deferred into the next row. Result (t / R) < 2p,
// then one conditional subtraction.
template <int K>
__device__ __forceinline__ Fe<K> mont_reduce(uint32_t (&t)[2 * K],
                                             const FieldCtx<K>& f) {
  uint32_t extra = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const uint32_t m = t[i] * f.pinv;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      uint64_t s = (uint64_t)t[i + j] + (uint64_t)m * f.p[j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[i + K] + c + extra;
    t[i + K] = (uint32_t)s;
    extra = (uint32_t)(s >> 32);
  }
  return cond_sub_p<K>(t + K, extra, f);
}

// a * b * R^-1 mod p, valid for a * b < R * p (canonical inputs).
// K^2 + K^2 wide multiplies and K low multiplies (2K^2 + K).
template <int K>
__device__ __forceinline__ Fe<K> fmul(const Fe<K>& a, const Fe<K>& b,
                                      const FieldCtx<K>& f) {
  uint32_t t[2 * K];
#pragma unroll
  for (int i = 0; i < 2 * K; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      uint64_t s = (uint64_t)a.v[i] * b.v[j] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    t[i + K] = (uint32_t)c;
  }
  return mont_reduce<K>(t, f);
}

// a^2 * R^-1 mod p: the K(K-1)/2 off-diagonal products once, doubled by a
// one-bit shift, plus the K diagonal squares; then the same reduction.
template <int K>
__device__ __forceinline__ Fe<K> fsqr(const Fe<K>& a, const FieldCtx<K>& f) {
  uint32_t t[2 * K];
#pragma unroll
  for (int i = 0; i < 2 * K; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < K; ++j) {
      uint64_t s = (uint64_t)a.v[i] * a.v[j] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    t[i + K] = (uint32_t)c;
  }
#pragma unroll
  for (int i = 2 * K - 1; i > 0; --i) t[i] = (t[i] << 1) | (t[i - 1] >> 31);
  t[0] <<= 1;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    uint64_t s = (uint64_t)a.v[i] * a.v[i] + t[2 * i] + c;
    t[2 * i] = (uint32_t)s;
    s = (uint64_t)t[2 * i + 1] + (s >> 32);
    t[2 * i + 1] = (uint32_t)s;
    c = s >> 32;
  }
  return mont_reduce<K>(t, f);
}

// Two field elements (the results of a field type's mul2).
template <class E>
struct Two {
  E a, b;
};

// The one-thread field: a lane's element is an Fe<K> in one thread, and
// every operation is the free function above. The point formulas of
// point.cuh and edpoint.cuh are templates over a field type with this
// interface (E; mul, sqr and the pairs mul2, sqr2, sqr_mul; add, sub; the
// curve's constants: a, a^2, 3b and one from a CurveCtx, one, d and 2d
// from an EdCurveCtx; zero, is_zero, select; load; kLimbs = K);
// groupfield.cuh's GroupField is the other one. Ctx is the curve context
// the constants come from; an accessor that it lacks does not compile.
// kInlineProducts says whether a product is inlined (here) or a call
// (GroupField), which decides how much code a formula adds.
template <int K, class Ctx = CurveCtx<K>>
struct ThreadField {
  using E = Fe<K>;
  static constexpr int kLimbs = K;
  static constexpr bool kInlineProducts = true;  // each product inlined
  const Ctx& C;

  __device__ __forceinline__ explicit ThreadField(const Ctx& c) : C(c) {}
  __device__ __forceinline__ E mul(const E& a, const E& b) const {
    return fmul<K>(a, b, C.f);
  }
  __device__ __forceinline__ E sqr(const E& a) const {
    return fsqr<K>(a, C.f);
  }
  // two independent products, squares or a square and a product
  __device__ __forceinline__ Two<E> mul2(const E& a, const E& b, const E& c,
                                         const E& d) const {
    return {fmul<K>(a, b, C.f), fmul<K>(c, d, C.f)};
  }
  __device__ __forceinline__ Two<E> sqr2(const E& a, const E& c) const {
    return {fsqr<K>(a, C.f), fsqr<K>(c, C.f)};
  }
  __device__ __forceinline__ Two<E> sqr_mul(const E& a, const E& c,
                                            const E& d) const {
    return {fsqr<K>(a, C.f), fmul<K>(c, d, C.f)};
  }
  __device__ __forceinline__ E add(const E& a, const E& b) const {
    return fadd<K>(a, b, C.f);
  }
  __device__ __forceinline__ E sub(const E& a, const E& b) const {
    return fsub<K>(a, b, C.f);
  }
  __device__ __forceinline__ E a() const { return fe_const<K>(C.a); }
  __device__ __forceinline__ E a2() const { return fe_const<K>(C.a2); }
  __device__ __forceinline__ E b3() const { return fe_const<K>(C.b3); }
  __device__ __forceinline__ E one() const { return fe_const<K>(C.one); }
  __device__ __forceinline__ E d() const { return fe_const<K>(C.d); }
  __device__ __forceinline__ E d2() const { return fe_const<K>(C.d2); }
  __device__ __forceinline__ E zero() const { return fe_zero<K>(); }
  __device__ __forceinline__ bool is_zero(const E& a) const {
    return ecc::is_zero<K>(a);
  }
  __device__ __forceinline__ E select(bool c, const E& a,
                                      const E& b) const {
    return fe_select<K>(c, a, b);
  }
  __device__ __forceinline__ E load(const uint32_t* __restrict__ base,
                                    long long n, long long lane) const {
    return load_fe<K>(base, n, lane);
  }
};

}  // namespace ecc

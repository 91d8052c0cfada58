// Twisted-Edwards point formulas for the port's CUDA kernels.
//
// Extended coordinates (X : Y : Z : T), x = X/Z, y = Y/Z, T = XY/Z, the
// identity (0 : 1 : 1 : 0), every coordinate a canonical Montgomery-form
// field element (field.cuh). The bodies follow the TPU kernel's
// libecc_tpu/ops/pallas/edpoint.py:_add_body (:49) and _dbl_body (:75)
// operation for operation, so the projective outputs are the same values
// mod p as the reference's. Two formula sets, chosen at compile time by
// AK: a = -1 (Ed25519, K = 8: add-2008-hwcd-3, dbl-2008-hwcd with
// D = -A) and a = 1 (Ed448, K = 14: add-2008-hwcd, dbl-2008-hwcd with
// D = A). The entry points refuse any other (K, a). For a = -1 and for
// a = 1 with d not a square (Ed448) both formulas are complete, so no
// lane needs an identity select.
//
// The formulas are templates over a field type F, as point.cuh's are:
// field.cuh's ThreadField (one thread a lane: kernels 8b and 8c, and the
// one-thread baselines of 8a, 7 and 6-ed) or groupfield.cuh's GroupField
// (a group of threads a lane: kernels 8a, 7 and 6-ed at K = 8 and 14),
// one text for both. The curve's
// constants come from the field type (f.one(), f.d(), f.d2()), and
// independent products are asked for in pairs (mul2, sqr2), which the
// group field computes together.
#pragma once

#include "field.cuh"

namespace ecc {

// An extended point over a field type's element E (Fe<K> for
// ThreadField, a thread's slice for GroupField).
template <class E>
struct ExtOf {
  E x, y, z, t;
};

template <int K>
using ExtPt = ExtOf<Fe<K>>;

// The common output of the add and the doubling: (E*F : G*H : F*G : E*H)
// in two pairs. With kT false the product E*H is not taken and T is left
// zero: only a doubling, which reads X, Y and Z, may follow.
template <bool kT, class F, class E = typename F::E>
__device__ __forceinline__ ExtOf<E> ed_out(const F& f, const E& e,
                                           const E& ff, const E& g,
                                           const E& h) {
  ExtOf<E> R;
  const Two<E> xy = f.mul2(e, ff, g, h);
  R.x = xy.a;
  R.y = xy.b;
  if constexpr (kT) {
    const Two<E> zt = f.mul2(ff, g, e, h);
    R.z = zt.a;
    R.t = zt.b;
  } else {
    R.z = f.mul(ff, g);
    R.t = f.zero();
  }
  return R;
}

// P + Q. a = -1: add-2008-hwcd-3, 8 products and one by 2d (four pairs
// and the one by 2d). a = 1: add-2008-hwcd, 8 products and one by d,
// H = B - A (five pairs: X1X2 with Y1Y2, T1T2 with Z1Z2, (X1+Y1)(X2+Y2)
// with T1T2*d, then the output's). Both strongly unified (valid for
// P = Q and for the identity).
template <int AK, class F, class E = typename F::E>
__device__ __forceinline__ ExtOf<E> ed_add(const F& f, const ExtOf<E>& P,
                                           const ExtOf<E>& Q) {
  E e, ff, g, h;
  if constexpr (AK == ED_A_M1) {
    const Two<E> ab = f.mul2(f.sub(P.y, P.x), f.sub(Q.y, Q.x),
                             f.add(P.y, P.x), f.add(Q.y, Q.x));
    const Two<E> tz = f.mul2(P.t, Q.t, P.z, Q.z);
    const E Cm = f.mul(tz.a, f.d2());
    const E Dm = f.add(tz.b, tz.b);
    e = f.sub(ab.b, ab.a);
    ff = f.sub(Dm, Cm);
    g = f.add(Dm, Cm);
    h = f.add(ab.b, ab.a);
  } else {
    static_assert(AK == ED_A_1, "a = -1 or a = 1");
    const Two<E> ab = f.mul2(P.x, Q.x, P.y, Q.y);
    const Two<E> tz = f.mul2(P.t, Q.t, P.z, Q.z);
    const Two<E> e0c = f.mul2(f.add(P.x, P.y), f.add(Q.x, Q.y), tz.a,
                              f.d());
    e = f.sub(f.sub(e0c.a, ab.a), ab.b);
    ff = f.sub(tz.b, e0c.b);
    g = f.add(tz.b, e0c.b);
    h = f.sub(ab.b, ab.a);
  }
  return ed_out<true>(f, e, ff, g, h);
}

// 2P by dbl-2008-hwcd with D = a*A (-A for a = -1, A for a = 1): 4
// squares in two pairs and 4 products (3 with kT false, see ed_out).
// Reads X, Y, Z only.
template <int AK, bool kT = true, class F, class E = typename F::E>
__device__ __forceinline__ ExtOf<E> ed_dbl(const F& f, const E& X,
                                           const E& Y, const E& Z) {
  static_assert(AK == ED_A_M1 || AK == ED_A_1, "a = -1 or a = 1");
  const Two<E> ab = f.sqr2(X, Y);
  const Two<E> ce = f.sqr2(Z, f.add(X, Y));
  const E A = ab.a, B = ab.b, Cs = ce.a;
  const E D = AK == ED_A_M1 ? f.sub(f.zero(), A) : A;
  const E e = f.sub(f.sub(ce.b, A), B);
  const E g = f.add(D, B);
  const E ff = f.sub(g, f.add(Cs, Cs));
  const E h = f.sub(D, B);
  return ed_out<kT>(f, e, ff, g, h);
}

template <int K>
__device__ __forceinline__ ExtPt<K> load_ext(const uint32_t* x,
                                             const uint32_t* y,
                                             const uint32_t* z,
                                             const uint32_t* t, long long n,
                                             long long lane) {
  ExtPt<K> P;
  P.x = load_fe<K>(x, n, lane);
  P.y = load_fe<K>(y, n, lane);
  P.z = load_fe<K>(z, n, lane);
  P.t = load_fe<K>(t, n, lane);
  return P;
}

template <int K>
__device__ __forceinline__ void store_ext(uint32_t* x, uint32_t* y,
                                          uint32_t* z, uint32_t* t,
                                          long long n, long long lane,
                                          const ExtPt<K>& P) {
  store_fe<K>(x, n, lane, P.x);
  store_fe<K>(y, n, lane, P.y);
  store_fe<K>(z, n, lane, P.z);
  store_fe<K>(t, n, lane, P.t);
}

}  // namespace ecc

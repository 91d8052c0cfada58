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
#pragma once

#include "field.cuh"

namespace ecc {

// Curve constants, all Montgomery-form canonical. a_kind is ED_A_M1 for
// a = -1 and ED_A_1 for a = 1; the entry points refuse any other value.
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
struct ExtPt {
  Fe<K> x, y, z, t;
};

// P + Q. a = -1: add-2008-hwcd-3, 8 products and one by 2d. a = 1:
// add-2008-hwcd, 8 products and one by d, H = B - A. Both strongly
// unified (valid for P = Q and for the identity).
template <int K, int AK>
__device__ __forceinline__ ExtPt<K> ed_add(const ExtPt<K>& P,
                                           const ExtPt<K>& Q,
                                           const EdCurveCtx<K>& C) {
  const FieldCtx<K>& f = C.f;
  Fe<K> E, F, G, H;
  if constexpr (AK == ED_A_M1) {
    const Fe<K> A = fmul<K>(fsub<K>(P.y, P.x, f), fsub<K>(Q.y, Q.x, f), f);
    const Fe<K> B = fmul<K>(fadd<K>(P.y, P.x, f), fadd<K>(Q.y, Q.x, f), f);
    const Fe<K> Cm = fmul_const<K>(fmul<K>(P.t, Q.t, f), C.d2, f);
    Fe<K> Dm = fmul<K>(P.z, Q.z, f);
    Dm = fadd<K>(Dm, Dm, f);
    E = fsub<K>(B, A, f);
    F = fsub<K>(Dm, Cm, f);
    G = fadd<K>(Dm, Cm, f);
    H = fadd<K>(B, A, f);
  } else {
    static_assert(AK == ED_A_1, "a = -1 or a = 1");
    const Fe<K> A = fmul<K>(P.x, Q.x, f);
    const Fe<K> B = fmul<K>(P.y, Q.y, f);
    const Fe<K> Cm = fmul_const<K>(fmul<K>(P.t, Q.t, f), C.d, f);
    const Fe<K> Dm = fmul<K>(P.z, Q.z, f);
    const Fe<K> E0 = fmul<K>(fadd<K>(P.x, P.y, f), fadd<K>(Q.x, Q.y, f), f);
    E = fsub<K>(fsub<K>(E0, A, f), B, f);
    F = fsub<K>(Dm, Cm, f);
    G = fadd<K>(Dm, Cm, f);
    H = fsub<K>(B, A, f);
  }
  ExtPt<K> R;
  R.x = fmul<K>(E, F, f);
  R.y = fmul<K>(G, H, f);
  R.z = fmul<K>(F, G, f);
  R.t = fmul<K>(E, H, f);
  return R;
}

// 2P by dbl-2008-hwcd with D = a*A (-A for a = -1, A for a = 1): 4
// squares and 4 products. Reads X, Y, Z only.
template <int K, int AK>
__device__ __forceinline__ ExtPt<K> ed_dbl(const Fe<K>& X, const Fe<K>& Y,
                                           const Fe<K>& Z,
                                           const EdCurveCtx<K>& C) {
  static_assert(AK == ED_A_M1 || AK == ED_A_1, "a = -1 or a = 1");
  const FieldCtx<K>& f = C.f;
  const Fe<K> A = fsqr<K>(X, f);
  const Fe<K> B = fsqr<K>(Y, f);
  const Fe<K> Cs = fsqr<K>(Z, f);
  const Fe<K> E0 = fsqr<K>(fadd<K>(X, Y, f), f);
  const Fe<K> D = AK == ED_A_M1 ? fsub<K>(fe_zero<K>(), A, f) : A;
  const Fe<K> E = fsub<K>(fsub<K>(E0, A, f), B, f);
  const Fe<K> G = fadd<K>(D, B, f);
  const Fe<K> F = fsub<K>(G, fadd<K>(Cs, Cs, f), f);
  const Fe<K> H = fsub<K>(D, B, f);
  ExtPt<K> R;
  R.x = fmul<K>(E, F, f);
  R.y = fmul<K>(G, H, f);
  R.z = fmul<K>(F, G, f);
  R.t = fmul<K>(E, H, f);
  return R;
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

// Short-Weierstrass point formulas for the port's CUDA kernels.
//
// Homogeneous projective (X : Y : Z), identity (0 : 1 : 0), every
// coordinate a canonical Montgomery-form field element (field.cuh).
// The Renes-Costello-Batina complete add and double follow the TPU bodies
// libecc_tpu/ops/pallas/point.py:_add_body (:311-366) and _dbl_body
// (:369-421) operation for operation, including the a = 0 / a = -3 /
// generic-a specialisation (chosen by the AK template flag), so the
// projective outputs are the same values mod p as the reference's.
// The Jacobian window block (to_jac, dbl-2001-b doubling, from_jac)
// follows point.py:_to_jac_body (:264), _jdbl_body (:226) and
// _from_jac_body (:291); only public-scalar paths use it.
#pragma once

#include <type_traits>

#include "field.cuh"
#include "groupfield.cuh"

namespace ecc {

// A point over a field type's element E (Fe<K> for ThreadField, a
// thread's slice for GroupField).
template <class E>
struct PtOf {
  E x, y, z;
};

template <int K>
using Pt = PtOf<Fe<K>>;

// The formulas below are templates over a field type F (field.cuh's
// ThreadField or groupfield.cuh's GroupField): one text for both, so the
// group loop of kernels 4 and 6 runs the same sequence of operations as
// kernels 2, 3 and 5.
template <class F>
__device__ __forceinline__ typename F::E ftriple(const F& f,
                                                 const typename F::E& a) {
  return f.add(f.add(a, a), a);
}

// Complete addition, RCB 2015 Alg. 1 in the reference's three layers
// (6 + 2 + 6 products for a = -3 and a = 0). Independent products are
// asked for in pairs (mul2), which the group field computes together.
template <int AK, class F, class E = typename F::E>
__device__ __forceinline__ PtOf<E> rcb_add(const F& f, const PtOf<E>& P,
                                           const PtOf<E>& Q) {
  const Two<E> t01 = f.mul2(P.x, Q.x, P.y, Q.y);
  const Two<E> t2m3 = f.mul2(P.z, Q.z, f.add(P.x, P.y), f.add(Q.x, Q.y));
  const Two<E> m45 = f.mul2(f.add(P.x, P.z), f.add(Q.x, Q.z),
                            f.add(P.y, P.z), f.add(Q.y, Q.z));
  const E t0 = t01.a, t1 = t01.b, t2 = t2m3.a;
  const E t3 = f.sub(t2m3.b, f.add(t0, t1));
  const E t4 = f.sub(m45.a, f.add(t0, t2));
  const E t5 = f.sub(m45.b, f.add(t1, t2));
  const Two<E> b3t = f.mul2(t2, f.b3(), t4, f.b3());
  const E b3t2 = b3t.a, b3t4 = b3t.b;
  E X3, Z3, t1n, t4n;
  if (AK == A_ZERO) {
    Z3 = b3t2;
    X3 = f.sub(t1, Z3);
    Z3 = f.add(t1, Z3);
    t1n = ftriple(f, t0);
    t4n = b3t4;
  } else if (AK == A_M3) {
    const E m4_3 = ftriple(f, m45.a);
    const E s02_3 = ftriple(f, f.add(t0, t2));
    const E t0_3 = ftriple(f, t0);
    const E t2_3 = ftriple(f, t2);
    const E t2_2 = f.add(t2, t2);
    const E t2_4 = f.add(t2_2, t2_2);
    const E t2_9 = f.add(f.add(t2_4, t2_4), t2);
    Z3 = f.add(f.sub(b3t2, m4_3), s02_3);
    X3 = f.sub(f.add(f.sub(t1, b3t2), m4_3), s02_3);
    Z3 = f.add(t1, Z3);
    t1n = f.sub(t0_3, t2_3);
    t4n = f.sub(b3t4, f.add(t0_3, t2_9));
  } else {
    const Two<E> at42 = f.mul2(t4, f.a(), t2, f.a());
    const Two<E> at0a2t2 = f.mul2(t0, f.a(), t2, f.a2());
    Z3 = f.add(at42.a, b3t2);
    X3 = f.sub(t1, Z3);
    Z3 = f.add(t1, Z3);
    t1n = f.add(ftriple(f, t0), at42.b);
    t4n = f.add(b3t4, f.sub(at0a2t2.a, at0a2t2.b));
  }
  const Two<E> y3 = f.mul2(X3, Z3, t1n, t4n);
  const Two<E> x3 = f.mul2(t3, X3, t5, t4n);
  const Two<E> z3 = f.mul2(t5, Z3, t3, t1n);
  PtOf<E> R;
  R.x = f.sub(x3.a, x3.b);
  R.y = f.add(y3.a, y3.b);
  R.z = f.add(z3.a, z3.b);
  return R;
}

// Complete doubling, RCB 2015 Alg. 3 (3 squares, 3 + 2 + 5 products).
template <int AK, class F, class E = typename F::E>
__device__ __forceinline__ PtOf<E> rcb_dbl(const F& f, const PtOf<E>& P) {
  const Two<E> t01 = f.sqr2(P.x, P.y);
  const Two<E> t2xy = f.sqr_mul(P.z, P.x, P.y);
  const Two<E> xzyz = f.mul2(P.x, P.z, P.y, P.z);
  const E t0 = t01.a, t1 = t01.b, t2 = t2xy.a;
  const E t3 = f.add(t2xy.b, t2xy.b);
  const E Z3w = f.add(xzyz.a, xzyz.a);
  const Two<E> b3t = f.mul2(t2, f.b3(), Z3w, f.b3());
  const E b3t2 = b3t.a, b3z3 = b3t.b;
  E X3w, Y3w, t3n, t0n;
  if (AK == A_ZERO) {
    Y3w = b3t2;
    X3w = f.sub(t1, Y3w);
    Y3w = f.add(t1, Y3w);
    t3n = b3z3;
    t0n = ftriple(f, t0);
  } else if (AK == A_M3) {
    const E z3x3 = ftriple(f, Z3w);
    const E t0_3 = ftriple(f, t0);
    const E t2_3 = ftriple(f, t2);
    const E t2_2 = f.add(t2, t2);
    const E t2_4 = f.add(t2_2, t2_2);
    const E t2_9 = f.add(f.add(t2_4, t2_4), t2);
    Y3w = f.sub(b3t2, z3x3);
    X3w = f.add(f.sub(t1, b3t2), z3x3);
    Y3w = f.add(t1, Y3w);
    t3n = f.sub(b3z3, f.add(t0_3, t2_9));
    t0n = f.sub(t0_3, t2_3);
  } else {
    const Two<E> az3at2 = f.mul2(Z3w, f.a(), t2, f.a());
    const Two<E> at0a2t2 = f.mul2(t0, f.a(), t2, f.a2());
    Y3w = f.add(az3at2.a, b3t2);
    X3w = f.sub(t1, Y3w);
    Y3w = f.add(t1, Y3w);
    t3n = f.add(f.sub(at0a2t2.a, at0a2t2.b), b3z3);
    t0n = f.add(ftriple(f, t0), az3at2.b);
  }
  const E t2d = f.add(xzyz.b, xzyz.b);
  const Two<E> y3 = f.mul2(X3w, Y3w, t0n, t3n);
  const Two<E> x3 = f.mul2(t2d, t3n, t3, X3w);
  const E z3m = f.mul(t2d, t1);
  PtOf<E> R;
  R.x = f.sub(x3.b, x3.a);
  R.y = f.add(y3.a, y3.b);
  const E z2 = f.add(z3m, z3m);
  R.z = f.add(z2, z2);
  return R;
}

// homogeneous -> Jacobian (X*Z, Y*Z^2, Z); lanes with Z = 0 take the
// representative (1, 1, 0), whose doubling orbit is itself.
template <class F, class E = typename F::E>
__device__ __forceinline__ PtOf<E> to_jac(const F& f, const PtOf<E>& P) {
  const bool inf = f.is_zero(P.z);
  const Two<E> zz_xz = f.sqr_mul(P.z, P.x, P.z);
  const E one = f.one();
  PtOf<E> J;
  J.x = f.select(inf, one, zz_xz.b);
  J.y = f.select(inf, one, f.mul(P.y, zz_xz.a));
  J.z = P.z;
  return J;
}

// One Jacobian doubling, dbl-2001-b (3M + 5S for a = -3): its products in
// pairs where the dependencies allow (the squares delta, gamma and
// (Y + Z)^2 first, then what needs them).
template <int AK, class F, class E = typename F::E>
__device__ __forceinline__ PtOf<E> jac_dbl(const F& f, const PtOf<E>& J) {
  const Two<E> dg = f.sqr2(J.z, J.y);
  const E delta = dg.a, gamma = dg.b;
  E alpha, beta, zz, g2;
  if (AK == A_M3) {
    const Two<E> ba = f.mul2(J.x, gamma, f.sub(J.x, delta),
                             f.add(J.x, delta));
    const Two<E> zg = f.sqr2(f.add(J.y, J.z), gamma);
    beta = ba.a;
    alpha = ftriple(f, ba.b);
    zz = zg.a;
    g2 = zg.b;
  } else if (AK == A_ZERO) {
    const Two<E> zb = f.sqr_mul(f.add(J.y, J.z), J.x, gamma);
    const Two<E> xg = f.sqr2(J.x, gamma);
    zz = zb.a;
    beta = zb.b;
    alpha = ftriple(f, xg.a);
    g2 = xg.b;
  } else {
    const Two<E> zb = f.sqr_mul(f.add(J.y, J.z), J.x, gamma);
    const Two<E> xd = f.sqr2(J.x, delta);
    const Two<E> ga = f.sqr_mul(gamma, xd.b, f.a());
    zz = zb.a;
    beta = zb.b;
    g2 = ga.a;
    alpha = f.add(ftriple(f, xd.a), ga.b);
  }
  const E alpha_sq = f.sqr(alpha);
  const E b2 = f.add(beta, beta);
  const E b4 = f.add(b2, b2);
  const E b8 = f.add(b4, b4);
  PtOf<E> R;
  R.x = f.sub(alpha_sq, b8);
  R.z = f.sub(zz, f.add(gamma, delta));
  const E t = f.sub(f.add(b8, b4), alpha_sq);
  const E g4 = f.add(f.add(g2, g2), f.add(g2, g2));
  const E g8 = f.add(g4, g4);
  R.y = f.sub(f.mul(alpha, t), g8);
  return R;
}

// Jacobian -> homogeneous (Xj*Zj : Yj : Zj^3); (1, 1, 0) lands on (0 : 1 : 0).
template <class F, class E = typename F::E>
__device__ __forceinline__ PtOf<E> from_jac(const F& f, const PtOf<E>& J) {
  const Two<E> zz_xz = f.sqr_mul(J.z, J.x, J.z);
  PtOf<E> P;
  P.x = zz_xz.b;
  P.y = J.y;
  P.z = f.mul(zz_xz.a, J.z);
  return P;
}

template <int K>
__device__ __forceinline__ Pt<K> load_pt(const uint32_t* x,
                                         const uint32_t* y,
                                         const uint32_t* z, long long n,
                                         long long lane) {
  Pt<K> P;
  P.x = load_fe<K>(x, n, lane);
  P.y = load_fe<K>(y, n, lane);
  P.z = load_fe<K>(z, n, lane);
  return P;
}

template <int K>
__device__ __forceinline__ void store_pt(uint32_t* x, uint32_t* y,
                                         uint32_t* z, long long n,
                                         long long lane, const Pt<K>& P) {
  store_fe<K>(x, n, lane, P.x);
  store_fe<K>(y, n, lane, P.y);
  store_fe<K>(z, n, lane, P.z);
}

// Kernels 2, 3 and 5 as templates over K and the formula set AK. Kernel
// 5 runs one thread a lane, the whole formula in registers; kernels 2 and
// 3 run on a group of threads a lane (groupfield.cuh's
// formula_group_kernel with PointAdd and PointDbl below) in the shape
// that groupfield.cuh's AddShape sets at each K. Their one-thread forms
// (point_add_kernel, launch_add; point_dbl_kernel, launch_dbl) stay as
// scripts/time_group_loop.py's measure of the group kernels. point.cu
// builds them at K = 8 for every a, point_wide.cu at K = 12 (a = -3) and
// K = 16 (generic a), point_p521.cu at K = 17 (a = -3), point_wide_alt.cu
// kernels 2 and 3 at K = 12 (generic a) and all three at K = 16 (a = -3),
// point_wei448.cu all three at K = 14 (generic a: WEI448), point_small.cu
// kernels 2 and 3 at K = 6 and 7 (every a) and K = 10 (a = -3, generic
// a).
template <int K, int AK>
__global__ void __launch_bounds__(256)
point_add_kernel(const CurveCtx<K> C, const uint32_t* __restrict__ x1,
                 const uint32_t* __restrict__ y1,
                 const uint32_t* __restrict__ z1,
                 const uint32_t* __restrict__ x2,
                 const uint32_t* __restrict__ y2,
                 const uint32_t* __restrict__ z2, uint32_t* __restrict__ x3,
                 uint32_t* __restrict__ y3, uint32_t* __restrict__ z3,
                 long long n) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const ThreadField<K> f(C);
  const Pt<K> P = load_pt<K>(x1, y1, z1, n, lane);
  const Pt<K> Q = load_pt<K>(x2, y2, z2, n, lane);
  store_pt<K>(x3, y3, z3, n, lane, rcb_add<AK>(f, P, Q));
}

// Kernel 5 (public points only, as the reference's block): to_jac with
// the identity select, n dbl-2001-b doublings, from_jac, then one complete
// add, all in registers; n is a run-time argument (one binary serves every
// n).
template <int K, int AK>
__global__ void __launch_bounds__(256)
point_dbln_add_kernel(const CurveCtx<K> C, const uint32_t* __restrict__ x1,
                      const uint32_t* __restrict__ y1,
                      const uint32_t* __restrict__ z1,
                      const uint32_t* __restrict__ x2,
                      const uint32_t* __restrict__ y2,
                      const uint32_t* __restrict__ z2,
                      uint32_t* __restrict__ x3, uint32_t* __restrict__ y3,
                      uint32_t* __restrict__ z3, long long n, int ndbl) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const ThreadField<K> f(C);
  Pt<K> J = to_jac(f, load_pt<K>(x1, y1, z1, n, lane));
#pragma unroll 1
  for (int i = 0; i < ndbl; ++i) J = jac_dbl<AK>(f, J);
  const Pt<K> T = load_pt<K>(x2, y2, z2, n, lane);
  store_pt<K>(x3, y3, z3, n, lane, rcb_add<AK>(f, from_jac(f, J), T));
}

template <int K, int AK>
__global__ void __launch_bounds__(256)
point_dbl_kernel(const CurveCtx<K> C, const uint32_t* __restrict__ x1,
                 const uint32_t* __restrict__ y1,
                 const uint32_t* __restrict__ z1, uint32_t* __restrict__ x3,
                 uint32_t* __restrict__ y3, uint32_t* __restrict__ z3,
                 long long n) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const ThreadField<K> f(C);
  store_pt<K>(x3, y3, z3, n, lane,
              rcb_dbl<AK>(f, load_pt<K>(x1, y1, z1, n, lane)));
}

// The formulas of kernels 2 and 3 on the group field, for groupfield.cuh's
// formula_group_kernel (in the shape AddShape<K>): rcb_add and rcb_dbl,
// the same templates as point_add_kernel's and point_dbl_kernel's, so
// the output is theirs bit for bit, (0 : 0 : 0) included.
// Kernel 2: in x1, y1, z1, x2, y2, z2; out x3, y3, z3.
struct PointAdd {
  template <int K>
  using Ctx = CurveCtx<K>;
  static constexpr int kIn = 6, kOut = 3;
  template <int AK, class F, class E>
  static __device__ __forceinline__ void apply(const F& f, const E* a,
                                               E* r) {
    const PtOf<E> R = rcb_add<AK>(f, PtOf<E>{a[0], a[1], a[2]},
                                  PtOf<E>{a[3], a[4], a[5]});
    r[0] = R.x;
    r[1] = R.y;
    r[2] = R.z;
  }
};

// Kernel 3: in x1, y1, z1; out x3, y3, z3.
struct PointDbl {
  template <int K>
  using Ctx = CurveCtx<K>;
  static constexpr int kIn = 3, kOut = 3;
  template <int AK, class F, class E>
  static __device__ __forceinline__ void apply(const F& f, const E* a,
                                               E* r) {
    const PtOf<E> R = rcb_dbl<AK>(f, PtOf<E>{a[0], a[1], a[2]});
    r[0] = R.x;
    r[1] = R.y;
    r[2] = R.z;
  }
};

constexpr int kPointThreads = 256;

inline unsigned point_blocks(long long n) {
  return (unsigned)((n + kPointThreads - 1) / kPointThreads);
}

// Kernel 2 at K for the formula sets AKs, one thread a lane: no entry
// point calls it; naming it in place of launch_group's PointAdd instance
// in an entry point's text gives the one-thread build
// (scripts/time_group_loop.py). in: x1, y1, z1, x2, y2, z2; out: x3, y3,
// z3 (device pointers).
template <int K, int... AKs>
int launch_add(const CurveCtx<K>* C, const uint32_t* const* in,
               uint32_t* const* out, long long n, void* stream) {
  return launch_for_a<AKs...>(C->a_kind, n, [&](auto ak) {
    point_add_kernel<K, decltype(ak)::value>
        <<<point_blocks(n), kPointThreads, 0, (cudaStream_t)stream>>>(
            *C, in[0], in[1], in[2], in[3], in[4], in[5], out[0], out[1],
            out[2], n);
  });
}

// Kernel 3 likewise, one thread a lane, in place of launch_group's
// PointDbl instance. in: x1, y1, z1; out: x3, y3, z3.
template <int K, int... AKs>
int launch_dbl(const CurveCtx<K>* C, const uint32_t* const* in,
               uint32_t* const* out, long long n, void* stream) {
  return launch_for_a<AKs...>(C->a_kind, n, [&](auto ak) {
    point_dbl_kernel<K, decltype(ak)::value>
        <<<point_blocks(n), kPointThreads, 0, (cudaStream_t)stream>>>(
            *C, in[0], in[1], in[2], out[0], out[1], out[2], n);
  });
}

// Kernel 5 at K for the formula sets AKs. in: x1, y1, z1 (P), x2, y2, z2
// (T); out: 2^ndbl * P + T. A negative ndbl returns cudaErrorInvalidValue.
template <int K, int... AKs>
int launch_dbln_add(const CurveCtx<K>* C, const uint32_t* const* in,
                    uint32_t* const* out, long long n, int ndbl,
                    void* stream) {
  if (ndbl < 0) return (int)cudaErrorInvalidValue;
  return launch_for_a<AKs...>(C->a_kind, n, [&](auto ak) {
    point_dbln_add_kernel<K, decltype(ak)::value>
        <<<point_blocks(n), kPointThreads, 0, (cudaStream_t)stream>>>(
            *C, in[0], in[1], in[2], in[3], in[4], in[5], out[0], out[1],
            out[2], n, ndbl);
  });
}

}  // namespace ecc

// The C entry points of kernels 2 and 3 (both in AddShape<K>) for one
// (K, formula set AK), named point_add_k<K>_<TAG> and
// point_dbl_k<K>_<TAG> (TAG: m3, ga or a0 for a = -3, generic a, a = 0).
// in: x1, y1, z1[, x2, y2, z2]; out: x3, y3, z3 (each uint32[K][n]). A
// context of another a_kind returns cudaErrorInvalidValue and launches
// nothing.
#define ECC_POINT_ENTRY_POINTS(K, AK, TAG)                                 \
  int point_add_k##K##_##TAG(const ecc::CurveCtx<K>* C,                    \
                             const uint32_t* const* in,                    \
                             uint32_t* const* out, long long n,            \
                             void* stream) {                               \
    return ecc::launch_group<ecc::PointAdd, K, AK>(C, in, out, n,      \
                                               stream);                   \
  }                                                                        \
  int point_dbl_k##K##_##TAG(const ecc::CurveCtx<K>* C,                    \
                             const uint32_t* const* in,                    \
                             uint32_t* const* out, long long n,            \
                             void* stream) {                               \
    return ecc::launch_group<ecc::PointDbl, K, AK>(C, in, out, n,      \
                                               stream);                   \
  }

// The C entry point NAME of kernel 5 for one (K, formula set AK). in: x1,
// y1, z1 (P), x2, y2, z2 (T); out: 2^ndbl * P + T (each uint32[K][n]). A
// context of another a_kind returns cudaErrorInvalidValue and launches
// nothing.
#define ECC_DBLN_ADD_ENTRY_POINT(NAME, K, AK)                              \
  int NAME(const ecc::CurveCtx<K>* C, const uint32_t* const* in,          \
           uint32_t* const* out, long long n, int ndbl, void* stream) {    \
    return ecc::launch_dbln_add<K, AK>(C, in, out, n, ndbl, stream);       \
  }

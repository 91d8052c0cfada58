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

// Kernels 2, 3 and 5 as templates over K and the formula set AK. Kernels
// 3 and 5 run one thread a lane, the whole formula in registers; kernel 2
// runs on a group of threads a lane (point_add_group_kernel below) in the
// shape that groupfield.cuh's AddShape sets at each K. Its one-thread form
// (point_add_kernel, launch_add) stays as scripts/time_group_loop.py's
// measure of the group kernel. point.cu builds them at K = 8
// for every a, point_wide.cu at K = 12 (a = -3) and K = 16 (generic a),
// point_p521.cu at K = 17 (a = -3), point_wide_alt.cu kernels 2 and 3 at
// K = 12 (generic a) and all three at K = 16 (a = -3), point_wei448.cu
// all three at K = 14 (generic a: WEI448), point_small.cu kernels 2 and 3
// at K = 6 and 7 (every a) and K = 10 (a = -3, generic a).
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

// Kernel 2 where a group of TPI threads carries a lane (groupfield.cuh),
// in the shape AddShape<K>. rcb_add is the same template over GroupField,
// so the sequence of operations, and the result, is point_add_kernel's,
// (0 : 0 : 0) included. Why: one thread a lane gives 8192 lanes 32 blocks
// of 256, on 32 of the 132 SMs, each product one thread's chain of 2K^2
// multiply-adds, and spills at K >= 14; a group of four gives 256 blocks
// of 128 and at most 128 registers a thread. A block of THREADS threads
// carries THREADS / TPI lanes; the threads past lane n - 1 (in the last
// block) repeat lane n - 1 and do not store, so that every warp's
// shuffles and votes see all 32 threads (no early return, no branch on
// the thread's place in its group).
template <int K, int AK>
__global__ void __launch_bounds__(AddShape<K>::kThreads,
                                  AddShape<K>::kMinBlocks)
point_add_group_kernel(const CurveCtx<K> C, const uint32_t* __restrict__ x1,
                       const uint32_t* __restrict__ y1,
                       const uint32_t* __restrict__ z1,
                       const uint32_t* __restrict__ x2,
                       const uint32_t* __restrict__ y2,
                       const uint32_t* __restrict__ z2,
                       uint32_t* __restrict__ x3, uint32_t* __restrict__ y3,
                       uint32_t* __restrict__ z3, long long n) {
  using S = AddShape<K>;
  using GF = GroupField<K, S::kTPI, S::kInline>;
  __shared__ uint32_t consts[GF::kSharedWords];
  GF::stage(consts, C);
  const GF f(consts, C.f.pinv);
  const long long g =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / S::kTPI;
  const long long lane = g < n ? g : n - 1;
  PtOf<typename GF::E> P, Q;
  P.x = f.load(x1, n, lane);
  P.y = f.load(y1, n, lane);
  P.z = f.load(z1, n, lane);
  Q.x = f.load(x2, n, lane);
  Q.y = f.load(y2, n, lane);
  Q.z = f.load(z2, n, lane);
  const PtOf<typename GF::E> R = rcb_add<AK>(f, P, Q);
  if (g < n) {
    f.store(x3, n, lane, R.x);
    f.store(y3, n, lane, R.y);
    f.store(z3, n, lane, R.z);
  }
}

constexpr int kPointThreads = 256;

inline unsigned point_blocks(long long n) {
  return (unsigned)((n + kPointThreads - 1) / kPointThreads);
}

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

// Kernel 2 at K for the formula sets AKs, one thread a lane. in: x1, y1,
// z1, x2, y2, z2; out: x3, y3, z3 (device pointers).
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

// Kernel 2 on the group field, in the shape AddShape<K>. The C entry
// points call this one; naming launch_add in its place in their text
// gives the one-thread build (scripts/time_group_loop.py).
template <int K, int... AKs>
int launch_add_g(const CurveCtx<K>* C, const uint32_t* const* in,
                 uint32_t* const* out, long long n, void* stream) {
  using S = AddShape<K>;
  const long long lanes = S::kThreads / S::kTPI;   // a block's lanes
  return launch_for_a<AKs...>(C->a_kind, n, [&](auto ak) {
    point_add_group_kernel<K, decltype(ak)::value>
        <<<(unsigned)((n + lanes - 1) / lanes), S::kThreads, 0,
           (cudaStream_t)stream>>>(*C, in[0], in[1], in[2], in[3], in[4],
                                   in[5], out[0], out[1], out[2], n);
  });
}

// Kernel 3 likewise, one thread a lane. in: x1, y1, z1; out: x3, y3, z3.
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

// The C entry points of kernels 2 (in AddShape<K>) and 3 (one thread a
// lane) for one (K, formula set AK), named point_add_k<K>_<TAG> and
// point_dbl_k<K>_<TAG> (TAG: m3, ga or a0 for a = -3, generic a, a = 0).
// in: x1, y1, z1[, x2, y2, z2]; out: x3, y3, z3 (each uint32[K][n]). A
// context of another a_kind returns cudaErrorInvalidValue and launches
// nothing.
#define ECC_POINT_ENTRY_POINTS(K, AK, TAG)                                 \
  int point_add_k##K##_##TAG(const ecc::CurveCtx<K>* C,                    \
                             const uint32_t* const* in,                    \
                             uint32_t* const* out, long long n,            \
                             void* stream) {                               \
    return ecc::launch_add_g<K, AK>(C, in, out, n, stream);                \
  }                                                                        \
  int point_dbl_k##K##_##TAG(const ecc::CurveCtx<K>* C,                    \
                             const uint32_t* const* in,                    \
                             uint32_t* const* out, long long n,            \
                             void* stream) {                               \
    return ecc::launch_dbl<K, AK>(C, in, out, n, stream);                  \
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

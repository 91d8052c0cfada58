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

namespace ecc {

template <int K>
struct Pt {
  Fe<K> x, y, z;
};

template <int K>
__device__ __forceinline__ Fe<K> ftriple(const Fe<K>& a,
                                         const FieldCtx<K>& f) {
  return fadd<K>(fadd<K>(a, a, f), a, f);
}

// Complete addition, RCB 2015 Alg. 1 in the reference's three layers
// (6 + 2 + 6 products for a = -3 and a = 0).
template <int K, int AK>
__device__ __forceinline__ Pt<K> rcb_add(const Pt<K>& P, const Pt<K>& Q,
                                         const CurveCtx<K>& C) {
  const FieldCtx<K>& f = C.f;
  const Fe<K> t0 = fmul<K>(P.x, Q.x, f);
  const Fe<K> t1 = fmul<K>(P.y, Q.y, f);
  const Fe<K> t2 = fmul<K>(P.z, Q.z, f);
  const Fe<K> m3 = fmul<K>(fadd<K>(P.x, P.y, f), fadd<K>(Q.x, Q.y, f), f);
  const Fe<K> m4 = fmul<K>(fadd<K>(P.x, P.z, f), fadd<K>(Q.x, Q.z, f), f);
  const Fe<K> m5 = fmul<K>(fadd<K>(P.y, P.z, f), fadd<K>(Q.y, Q.z, f), f);
  const Fe<K> t3 = fsub<K>(m3, fadd<K>(t0, t1, f), f);
  const Fe<K> t4 = fsub<K>(m4, fadd<K>(t0, t2, f), f);
  const Fe<K> t5 = fsub<K>(m5, fadd<K>(t1, t2, f), f);
  const Fe<K> b3t2 = fmul_const<K>(t2, C.b3, f);
  const Fe<K> b3t4 = fmul_const<K>(t4, C.b3, f);
  Fe<K> X3, Z3, t1n, t4n;
  if (AK == A_ZERO) {
    Z3 = b3t2;
    X3 = fsub<K>(t1, Z3, f);
    Z3 = fadd<K>(t1, Z3, f);
    t1n = ftriple<K>(t0, f);
    t4n = b3t4;
  } else if (AK == A_M3) {
    const Fe<K> m4_3 = ftriple<K>(m4, f);
    const Fe<K> s02_3 = ftriple<K>(fadd<K>(t0, t2, f), f);
    const Fe<K> t0_3 = ftriple<K>(t0, f);
    const Fe<K> t2_3 = ftriple<K>(t2, f);
    const Fe<K> t2_2 = fadd<K>(t2, t2, f);
    const Fe<K> t2_4 = fadd<K>(t2_2, t2_2, f);
    const Fe<K> t2_9 = fadd<K>(fadd<K>(t2_4, t2_4, f), t2, f);
    Z3 = fadd<K>(fsub<K>(b3t2, m4_3, f), s02_3, f);
    X3 = fsub<K>(fadd<K>(fsub<K>(t1, b3t2, f), m4_3, f), s02_3, f);
    Z3 = fadd<K>(t1, Z3, f);
    t1n = fsub<K>(t0_3, t2_3, f);
    t4n = fsub<K>(b3t4, fadd<K>(t0_3, t2_9, f), f);
  } else {
    const Fe<K> at4 = fmul_const<K>(t4, C.a, f);
    const Fe<K> at2 = fmul_const<K>(t2, C.a, f);
    const Fe<K> at0 = fmul_const<K>(t0, C.a, f);
    const Fe<K> a2t2 = fmul_const<K>(t2, C.a2, f);
    Z3 = fadd<K>(at4, b3t2, f);
    X3 = fsub<K>(t1, Z3, f);
    Z3 = fadd<K>(t1, Z3, f);
    t1n = fadd<K>(ftriple<K>(t0, f), at2, f);
    t4n = fadd<K>(b3t4, fsub<K>(at0, a2t2, f), f);
  }
  const Fe<K> y3a = fmul<K>(X3, Z3, f);
  const Fe<K> y3b = fmul<K>(t1n, t4n, f);
  const Fe<K> x3b = fmul<K>(t5, t4n, f);
  const Fe<K> x3a = fmul<K>(t3, X3, f);
  const Fe<K> z3b = fmul<K>(t3, t1n, f);
  const Fe<K> z3a = fmul<K>(t5, Z3, f);
  Pt<K> R;
  R.x = fsub<K>(x3a, x3b, f);
  R.y = fadd<K>(y3a, y3b, f);
  R.z = fadd<K>(z3a, z3b, f);
  return R;
}

// Complete doubling, RCB 2015 Alg. 3 (3 squares, 3 + 2 + 5 products).
template <int K, int AK>
__device__ __forceinline__ Pt<K> rcb_dbl(const Pt<K>& P,
                                         const CurveCtx<K>& C) {
  const FieldCtx<K>& f = C.f;
  const Fe<K> t0 = fsqr<K>(P.x, f);
  const Fe<K> t1 = fsqr<K>(P.y, f);
  const Fe<K> t2 = fsqr<K>(P.z, f);
  const Fe<K> xy = fmul<K>(P.x, P.y, f);
  const Fe<K> xz = fmul<K>(P.x, P.z, f);
  const Fe<K> yz = fmul<K>(P.y, P.z, f);
  const Fe<K> t3 = fadd<K>(xy, xy, f);
  const Fe<K> Z3w = fadd<K>(xz, xz, f);
  const Fe<K> b3t2 = fmul_const<K>(t2, C.b3, f);
  const Fe<K> b3z3 = fmul_const<K>(Z3w, C.b3, f);
  Fe<K> X3w, Y3w, t3n, t0n;
  if (AK == A_ZERO) {
    Y3w = b3t2;
    X3w = fsub<K>(t1, Y3w, f);
    Y3w = fadd<K>(t1, Y3w, f);
    t3n = b3z3;
    t0n = ftriple<K>(t0, f);
  } else if (AK == A_M3) {
    const Fe<K> z3x3 = ftriple<K>(Z3w, f);
    const Fe<K> t0_3 = ftriple<K>(t0, f);
    const Fe<K> t2_3 = ftriple<K>(t2, f);
    const Fe<K> t2_2 = fadd<K>(t2, t2, f);
    const Fe<K> t2_4 = fadd<K>(t2_2, t2_2, f);
    const Fe<K> t2_9 = fadd<K>(fadd<K>(t2_4, t2_4, f), t2, f);
    Y3w = fsub<K>(b3t2, z3x3, f);
    X3w = fadd<K>(fsub<K>(t1, b3t2, f), z3x3, f);
    Y3w = fadd<K>(t1, Y3w, f);
    t3n = fsub<K>(b3z3, fadd<K>(t0_3, t2_9, f), f);
    t0n = fsub<K>(t0_3, t2_3, f);
  } else {
    const Fe<K> az3 = fmul_const<K>(Z3w, C.a, f);
    const Fe<K> at2 = fmul_const<K>(t2, C.a, f);
    const Fe<K> at0 = fmul_const<K>(t0, C.a, f);
    const Fe<K> a2t2 = fmul_const<K>(t2, C.a2, f);
    Y3w = fadd<K>(az3, b3t2, f);
    X3w = fsub<K>(t1, Y3w, f);
    Y3w = fadd<K>(t1, Y3w, f);
    t3n = fadd<K>(fsub<K>(at0, a2t2, f), b3z3, f);
    t0n = fadd<K>(ftriple<K>(t0, f), at2, f);
  }
  const Fe<K> t2d = fadd<K>(yz, yz, f);
  const Fe<K> y3m = fmul<K>(X3w, Y3w, f);
  const Fe<K> y3t = fmul<K>(t0n, t3n, f);
  const Fe<K> x3t = fmul<K>(t2d, t3n, f);
  const Fe<K> x3m = fmul<K>(t3, X3w, f);
  const Fe<K> z3m = fmul<K>(t2d, t1, f);
  Pt<K> R;
  R.x = fsub<K>(x3m, x3t, f);
  R.y = fadd<K>(y3m, y3t, f);
  const Fe<K> z2 = fadd<K>(z3m, z3m, f);
  R.z = fadd<K>(z2, z2, f);
  return R;
}

// homogeneous -> Jacobian (X*Z, Y*Z^2, Z); lanes with Z = 0 take the
// representative (1, 1, 0), whose doubling orbit is itself.
template <int K>
__device__ __forceinline__ Pt<K> to_jac(const Pt<K>& P,
                                        const CurveCtx<K>& C) {
  const FieldCtx<K>& f = C.f;
  const bool inf = is_zero<K>(P.z);
  const Fe<K> zz = fsqr<K>(P.z, f);
  const Fe<K> one = fe_const<K>(C.one);
  Pt<K> J;
  J.x = fe_select<K>(inf, one, fmul<K>(P.x, P.z, f));
  J.y = fe_select<K>(inf, one, fmul<K>(P.y, zz, f));
  J.z = P.z;
  return J;
}

// One Jacobian doubling, dbl-2001-b (3M + 5S for a = -3).
template <int K, int AK>
__device__ __forceinline__ Pt<K> jac_dbl(const Pt<K>& J,
                                         const CurveCtx<K>& C) {
  const FieldCtx<K>& f = C.f;
  const Fe<K> delta = fsqr<K>(J.z, f);
  const Fe<K> gamma = fsqr<K>(J.y, f);
  const Fe<K> beta = fmul<K>(J.x, gamma, f);
  Fe<K> alpha;
  if (AK == A_M3) {
    alpha = ftriple<K>(fmul<K>(fsub<K>(J.x, delta, f),
                               fadd<K>(J.x, delta, f), f), f);
  } else if (AK == A_ZERO) {
    alpha = ftriple<K>(fsqr<K>(J.x, f), f);
  } else {
    const Fe<K> ad2 = fmul_const<K>(fsqr<K>(delta, f), C.a, f);
    alpha = fadd<K>(ftriple<K>(fsqr<K>(J.x, f), f), ad2, f);
  }
  const Fe<K> alpha_sq = fsqr<K>(alpha, f);
  const Fe<K> b2 = fadd<K>(beta, beta, f);
  const Fe<K> b4 = fadd<K>(b2, b2, f);
  const Fe<K> b8 = fadd<K>(b4, b4, f);
  Pt<K> R;
  R.x = fsub<K>(alpha_sq, b8, f);
  R.z = fsub<K>(fsqr<K>(fadd<K>(J.y, J.z, f), f), fadd<K>(gamma, delta, f),
                f);
  const Fe<K> t = fsub<K>(fadd<K>(b8, b4, f), alpha_sq, f);
  const Fe<K> g2 = fsqr<K>(gamma, f);
  const Fe<K> g4 = fadd<K>(fadd<K>(g2, g2, f), fadd<K>(g2, g2, f), f);
  const Fe<K> g8 = fadd<K>(g4, g4, f);
  R.y = fsub<K>(fmul<K>(alpha, t, f), g8, f);
  return R;
}

// Jacobian -> homogeneous (Xj*Zj : Yj : Zj^3); (1, 1, 0) lands on (0 : 1 : 0).
template <int K>
__device__ __forceinline__ Pt<K> from_jac(const Pt<K>& J,
                                          const CurveCtx<K>& C) {
  const FieldCtx<K>& f = C.f;
  const Fe<K> zz = fsqr<K>(J.z, f);
  Pt<K> P;
  P.x = fmul<K>(J.x, J.z, f);
  P.y = J.y;
  P.z = fmul<K>(zz, J.z, f);
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

// Kernels 2, 3 and 5 as templates over K and the formula set AK: one
// thread per lane, the whole formula in registers. point.cu builds them at
// K = 8 for every a, point_wide.cu at K = 12 (a = -3) and K = 16 (generic
// a), point_p521.cu at K = 17 (a = -3), point_wide_alt.cu kernels 2 and 3
// at K = 12 (generic a) and all three at K = 16 (a = -3), point_wei448.cu
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
  const Pt<K> P = load_pt<K>(x1, y1, z1, n, lane);
  const Pt<K> Q = load_pt<K>(x2, y2, z2, n, lane);
  store_pt<K>(x3, y3, z3, n, lane, rcb_add<K, AK>(P, Q, C));
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
  Pt<K> J = to_jac<K>(load_pt<K>(x1, y1, z1, n, lane), C);
#pragma unroll 1
  for (int i = 0; i < ndbl; ++i) J = jac_dbl<K, AK>(J, C);
  const Pt<K> T = load_pt<K>(x2, y2, z2, n, lane);
  store_pt<K>(x3, y3, z3, n, lane, rcb_add<K, AK>(from_jac<K>(J, C), T, C));
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
  store_pt<K>(x3, y3, z3, n, lane,
              rcb_dbl<K, AK>(load_pt<K>(x1, y1, z1, n, lane), C));
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

// Kernel 2 at K for the formula sets AKs. in: x1, y1, z1, x2, y2, z2;
// out: x3, y3, z3 (device pointers).
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

// Kernel 3 likewise. in: x1, y1, z1; out: x3, y3, z3.
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

// The C entry points of kernels 2 and 3 for one (K, formula set AK),
// named point_add_k<K>_<TAG> and point_dbl_k<K>_<TAG> (TAG: m3, ga or a0
// for a = -3, generic a, a = 0). in: x1, y1, z1[, x2, y2, z2]; out: x3,
// y3, z3 (each uint32[K][n]). A context of another a_kind returns
// cudaErrorInvalidValue and launches nothing.
#define ECC_POINT_ENTRY_POINTS(K, AK, TAG)                                 \
  int point_add_k##K##_##TAG(const ecc::CurveCtx<K>* C,                    \
                             const uint32_t* const* in,                    \
                             uint32_t* const* out, long long n,            \
                             void* stream) {                               \
    return ecc::launch_add<K, AK>(C, in, out, n, stream);                  \
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

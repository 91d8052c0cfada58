// Kernels 8a, 8b and 8c: batched twisted-Edwards extended add, double, and
// the fused n doublings plus one add.
//
// Replace the TPU kernels libecc_tpu/ops/pallas/edpoint.py:_build_add
// (:110 -> _pallas_call :92, pallas_call :99; public point_add :165, body
// _add_body :49), _build_dbl (:126; public point_dbl :171, body
// _dbl_body :75) and _build_dbln_add (:140; public point_dbln_add :177).
// 8a and 8b are built for a = -1 at K = 8 (Ed25519) and for a = 1 at
// K = 14 (Ed448; with kernel 1 at K = 14 and kernel 7's K = 14 instance
// they are the port's counterpart of the rows.py:RowOps backend, :129,
// which the TPU kernels take for Ed448's K = 32); 8c likewise, at both
// (K, a), its formula set the AK template flag as 8a's and 8b's.
//
// Bound on the H100: integer-multiply issue. An add is 9 field products
// for 12 x 4K bytes of traffic per lane (8 coordinates in, 4 out): at
// K = 8 about 2,400 multiply-add slots for 384 bytes (at K = 14 about
// 7,200 for 672 bytes), well above the card's slot-to-byte ratio; a
// double is 4 squares and 4 products for 7 x 4K bytes. Design: the whole
// formula in registers, the templates of edpoint.cuh. Kernels 8a and 8b
// run on a group of threads a lane (groupfield.cuh's formula_group_kernel
// with EdAdd and EdDbl below, in the shape its AddShape sets at each K),
// as kernels 2 and 3 do: one thread a lane gives 8192 lanes 32 blocks of
// 256 on 32 of the 132 SMs, each product one thread's chain of 2K^2
// multiply-adds, and holds an extended point in 4K registers (56 at
// K = 14). Kernel 8c runs one thread a lane, over field.cuh's
// ThreadField, and keeps the point in registers across its n doublings
// (4n squares and 4n + 9 products for 384 bytes; n is a run-time
// argument); with n = 0 it is the add, T of P included.
#include "edpoint.cuh"
#include "groupfield.cuh"

namespace ecc {

template <int K, int AK>
__global__ void __launch_bounds__(256)
ed_add_kernel(const EdCurveCtx<K> C, const uint32_t* __restrict__ x1,
              const uint32_t* __restrict__ y1,
              const uint32_t* __restrict__ z1,
              const uint32_t* __restrict__ t1,
              const uint32_t* __restrict__ x2,
              const uint32_t* __restrict__ y2,
              const uint32_t* __restrict__ z2,
              const uint32_t* __restrict__ t2, uint32_t* __restrict__ x3,
              uint32_t* __restrict__ y3, uint32_t* __restrict__ z3,
              uint32_t* __restrict__ t3, long long n) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const ThreadField<K, EdCurveCtx<K>> f(C);
  const ExtPt<K> P = load_ext<K>(x1, y1, z1, t1, n, lane);
  const ExtPt<K> Q = load_ext<K>(x2, y2, z2, t2, n, lane);
  store_ext<K>(x3, y3, z3, t3, n, lane, ed_add<AK>(f, P, Q));
}

template <int K, int AK>
__global__ void __launch_bounds__(256)
ed_dbl_kernel(const EdCurveCtx<K> C, const uint32_t* __restrict__ x1,
              const uint32_t* __restrict__ y1,
              const uint32_t* __restrict__ z1, uint32_t* __restrict__ x3,
              uint32_t* __restrict__ y3, uint32_t* __restrict__ z3,
              uint32_t* __restrict__ t3, long long n) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const ThreadField<K, EdCurveCtx<K>> f(C);
  const Fe<K> X = load_fe<K>(x1, n, lane);
  const Fe<K> Y = load_fe<K>(y1, n, lane);
  const Fe<K> Z = load_fe<K>(z1, n, lane);
  store_ext<K>(x3, y3, z3, t3, n, lane, ed_dbl<AK>(f, X, Y, Z));
}

// The formulas of kernels 8a and 8b on the group field, for
// groupfield.cuh's formula_group_kernel (in the shape AddShape<K>): ed_add
// and ed_dbl (T taken), the same templates as ed_add_kernel's and
// ed_dbl_kernel's, so the output is theirs bit for bit.
// Kernel 8a: in x1, y1, z1, t1, x2, y2, z2, t2; out x3, y3, z3, t3.
struct EdAdd {
  template <int K>
  using Ctx = EdCurveCtx<K>;
  static constexpr int kIn = 8, kOut = 4;
  template <int AK, class F, class E>
  static __device__ __forceinline__ void apply(const F& f, const E* a,
                                               E* r) {
    const ExtOf<E> R = ed_add<AK>(f, ExtOf<E>{a[0], a[1], a[2], a[3]},
                                  ExtOf<E>{a[4], a[5], a[6], a[7]});
    r[0] = R.x;
    r[1] = R.y;
    r[2] = R.z;
    r[3] = R.t;
  }
};

// Kernel 8b: in x1, y1, z1; out x3, y3, z3, t3.
struct EdDbl {
  template <int K>
  using Ctx = EdCurveCtx<K>;
  static constexpr int kIn = 3, kOut = 4;
  template <int AK, class F, class E>
  static __device__ __forceinline__ void apply(const F& f, const E* a,
                                               E* r) {
    const ExtOf<E> R = ed_dbl<AK, true>(f, a[0], a[1], a[2]);
    r[0] = R.x;
    r[1] = R.y;
    r[2] = R.z;
    r[3] = R.t;
  }
};

template <int K, int AK>
__global__ void __launch_bounds__(256)
ed_dbln_add_kernel(const EdCurveCtx<K> C, const uint32_t* __restrict__ x1,
                   const uint32_t* __restrict__ y1,
                   const uint32_t* __restrict__ z1,
                   const uint32_t* __restrict__ t1,
                   const uint32_t* __restrict__ x2,
                   const uint32_t* __restrict__ y2,
                   const uint32_t* __restrict__ z2,
                   const uint32_t* __restrict__ t2,
                   uint32_t* __restrict__ x3, uint32_t* __restrict__ y3,
                   uint32_t* __restrict__ z3, uint32_t* __restrict__ t3,
                   long long n, int ndbl) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const ThreadField<K, EdCurveCtx<K>> f(C);
  ExtPt<K> acc = load_ext<K>(x1, y1, z1, t1, n, lane);
#pragma unroll 1
  for (int i = 0; i < ndbl; ++i) acc = ed_dbl<AK>(f, acc.x, acc.y, acc.z);
  const ExtPt<K> T = load_ext<K>(x2, y2, z2, t2, n, lane);
  store_ext<K>(x3, y3, z3, t3, n, lane, ed_add<AK>(f, acc, T));
}

constexpr int kThreads = 256;

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// Kernel 8a one thread a lane: no entry point calls it; naming it in
// place of launch_group's EdAdd instance in an entry point's text gives
// scripts/time_group_loop.py's one-thread build.
template <int K, int AK>
int launch_add(const EdCurveCtx<K>* C, const uint32_t* const* in,
               uint32_t* const* out, long long n, void* stream) {
  if (C->a_kind != AK) return (int)cudaErrorInvalidValue;
  if (n > 0)
    ed_add_kernel<K, AK><<<blocks_for(n), kThreads, 0,
                           (cudaStream_t)stream>>>(
        *C, in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], out[0],
        out[1], out[2], out[3], n);
  return (int)cudaGetLastError();
}

// Kernel 8b one thread a lane, in place of launch_group's EdDbl instance.
template <int K, int AK>
int launch_dbl(const EdCurveCtx<K>* C, const uint32_t* const* in,
               uint32_t* const* out, long long n, void* stream) {
  if (C->a_kind != AK) return (int)cudaErrorInvalidValue;
  if (n > 0)
    ed_dbl_kernel<K, AK><<<blocks_for(n), kThreads, 0,
                           (cudaStream_t)stream>>>(
        *C, in[0], in[1], in[2], out[0], out[1], out[2], out[3], n);
  return (int)cudaGetLastError();
}

template <int K, int AK>
int launch_dbln_add(const EdCurveCtx<K>* C, const uint32_t* const* in,
                    uint32_t* const* out, long long n, int ndbl,
                    void* stream) {
  if (C->a_kind != AK || ndbl < 0) return (int)cudaErrorInvalidValue;
  if (n > 0)
    ed_dbln_add_kernel<K, AK><<<blocks_for(n), kThreads, 0,
                                (cudaStream_t)stream>>>(
        *C, in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], out[0],
        out[1], out[2], out[3], n, ndbl);
  return (int)cudaGetLastError();
}

}  // namespace ecc

// Each entry point returns cudaErrorInvalidValue for a curve whose a is
// not the one it is built for: a = -1 at K = 8 (Ed25519), a = 1 at K = 14
// (Ed448).
extern "C" {

// in: x1, y1, z1, t1, x2, y2, z2, t2; out: x3, y3, z3, t3 (device
// pointers).
int ed_add_k8(const ecc::EdCurveCtx<8>* C, const uint32_t* const* in,
              uint32_t* const* out, long long n, void* stream) {
  return ecc::launch_group<ecc::EdAdd, 8, ecc::ED_A_M1>(C, in, out, n,
                                                        stream);
}

// in: x1, y1, z1; out: x3, y3, z3, t3.
int ed_dbl_k8(const ecc::EdCurveCtx<8>* C, const uint32_t* const* in,
              uint32_t* const* out, long long n, void* stream) {
  return ecc::launch_group<ecc::EdDbl, 8, ecc::ED_A_M1>(C, in, out, n,
                                                        stream);
}

int ed_add_k14(const ecc::EdCurveCtx<14>* C, const uint32_t* const* in,
               uint32_t* const* out, long long n, void* stream) {
  return ecc::launch_group<ecc::EdAdd, 14, ecc::ED_A_1>(C, in, out, n,
                                                        stream);
}

int ed_dbl_k14(const ecc::EdCurveCtx<14>* C, const uint32_t* const* in,
               uint32_t* const* out, long long n, void* stream) {
  return ecc::launch_group<ecc::EdDbl, 14, ecc::ED_A_1>(C, in, out, n,
                                                        stream);
}

// in: x1, y1, z1, t1 (P), x2, y2, z2, t2 (T); out: 2^ndbl * P + T.
int ed_dbln_add_k8(const ecc::EdCurveCtx<8>* C, const uint32_t* const* in,
                   uint32_t* const* out, long long n, int ndbl,
                   void* stream) {
  return ecc::launch_dbln_add<8, ecc::ED_A_M1>(C, in, out, n, ndbl, stream);
}

int ed_dbln_add_k14(const ecc::EdCurveCtx<14>* C, const uint32_t* const* in,
                    uint32_t* const* out, long long n, int ndbl,
                    void* stream) {
  return ecc::launch_dbln_add<14, ecc::ED_A_1>(C, in, out, n, ndbl, stream);
}

}  // extern "C"

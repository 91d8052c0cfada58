// Kernels 2, 3 and 5 at K = 8 (256-bit moduli, every a): batched complete
// point addition, doubling, and the fused 2^n * P + T step. Kernels 2 and
// 3 are templates over K in point.cuh; point_wide.cu builds their K = 12
// and K = 16 instances.
//
// Replace the TPU kernels libecc_tpu/ops/pallas/point.py:_build_add
// (:470 -> _pallas_call3 :449, public point_add :539, body _add_body
// :311-366), _build_dbl (:489, public point_dbl :545, body _dbl_body
// :369-421) and _build_dbln_add (:507, public point_dbln_add :551: the
// Jacobian block _dbln_jac_block :300, then _add_body).
//
// Bound on the H100: integer-multiply issue. An add is 14 field products
// (12 + 2 by b3 for a = -3) for 9 x 4K bytes of traffic per lane; at K = 8
// that is ~3,700 multiply-add slots for 288 bytes, well above the card's
// slot-to-byte ratio. Design: one thread per lane, the whole formula in
// registers (the TPU kernel's point of keeping intermediates in VMEM),
// the a-specialisation a compile-time template flag so each instantiation
// carries only its own formula set.
//
// Kernel 5 (public points only, as the reference's block): to_jac with the
// identity select, n dbl-2001-b doublings, from_jac, then one complete add,
// all in registers; n is a run-time argument (one binary serves every n).
// Per lane 2 + 5n squares and 18 + 3n products (a = -3) for the same
// 288 bytes as an add: bound by integer-multiply issue.
#include "point.cuh"

namespace ecc {

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

// Kernel 5 at K for the formula sets AKs. in: x1, y1, z1 (P), x2, y2, z2
// (T); out: 2^ndbl * P + T.
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

extern "C" {

// Every a at K = 8: one formula set per a, chosen by the context's a_kind.
// in: x1, y1, z1, x2, y2, z2; out: x3, y3, z3 (device pointers).
int point_add_k8(const ecc::CurveCtx<8>* C, const uint32_t* const* in,
                 uint32_t* const* out, long long n, void* stream) {
  return ecc::launch_add<8, ecc::A_M3, ecc::A_ZERO, ecc::A_GENERIC>(
      C, in, out, n, stream);
}

// in: x1, y1, z1; out: x3, y3, z3.
int point_dbl_k8(const ecc::CurveCtx<8>* C, const uint32_t* const* in,
                 uint32_t* const* out, long long n, void* stream) {
  return ecc::launch_dbl<8, ecc::A_M3, ecc::A_ZERO, ecc::A_GENERIC>(
      C, in, out, n, stream);
}

// in: x1, y1, z1 (P), x2, y2, z2 (T); out: 2^ndbl * P + T.
int point_dbln_add_k8(const ecc::CurveCtx<8>* C, const uint32_t* const* in,
                      uint32_t* const* out, long long n, int ndbl,
                      void* stream) {
  return ecc::launch_dbln_add<8, ecc::A_M3, ecc::A_ZERO, ecc::A_GENERIC>(
      C, in, out, n, ndbl, stream);
}

}  // extern "C"

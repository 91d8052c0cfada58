// Kernels 2, 3 and 5 at K = 8 (256-bit moduli, every a): batched complete
// point addition, doubling, and the fused 2^n * P + T step. All three are
// templates over K in point.cuh; point_wide.cu and the other point_*.cu
// files build their wider instances.
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
// slot-to-byte ratio. Design: the whole formula in registers (the TPU
// kernel's point of keeping intermediates in VMEM), the a-specialisation a
// compile-time template flag so each instantiation carries only its own
// formula set. Kernels 2 and 3 run on a group of threads a lane
// (groupfield.cuh's formula_group_kernel with point.cuh's PointAdd and
// PointDbl over groupfield.cuh's field, in the shape its AddShape sets at
// each K), so that 8192 lanes fill every SM; kernel 5 runs one thread a
// lane.
//
// Kernel 5 (public points only, as the reference's block; its template
// is point.cuh's point_dbln_add_kernel): to_jac with the identity select,
// n dbl-2001-b doublings, from_jac, then one complete add, all in
// registers; n is a run-time argument (one binary serves every n). Per
// lane 2 + 5n squares and 18 + 3n products (a = -3) for the same
// 288 bytes as an add: bound by integer-multiply issue.
#include "point.cuh"

extern "C" {

// Every a at K = 8: one formula set per a, chosen by the context's a_kind.
// in: x1, y1, z1, x2, y2, z2; out: x3, y3, z3 (device pointers).
int point_add_k8(const ecc::CurveCtx<8>* C, const uint32_t* const* in,
                 uint32_t* const* out, long long n, void* stream) {
  return ecc::launch_group<ecc::PointAdd, 8, ecc::A_M3, ecc::A_ZERO,
                           ecc::A_GENERIC>(C, in, out, n, stream);
}

// in: x1, y1, z1; out: x3, y3, z3.
int point_dbl_k8(const ecc::CurveCtx<8>* C, const uint32_t* const* in,
                 uint32_t* const* out, long long n, void* stream) {
  return ecc::launch_group<ecc::PointDbl, 8, ecc::A_M3, ecc::A_ZERO,
                           ecc::A_GENERIC>(C, in, out, n, stream);
}

// in: x1, y1, z1 (P), x2, y2, z2 (T); out: 2^ndbl * P + T.
int point_dbln_add_k8(const ecc::CurveCtx<8>* C, const uint32_t* const* in,
                      uint32_t* const* out, long long n, int ndbl,
                      void* stream) {
  return ecc::launch_dbln_add<8, ecc::A_M3, ecc::A_ZERO, ecc::A_GENERIC>(
      C, in, out, n, ndbl, stream);
}

}  // extern "C"

// Kernels 2, 3 and 5 at K = 17 (521-bit moduli, a = -3: P-521), the
// templates of point.cuh built once each in a file of their own, so their
// large unrolled bodies compile beside the other libraries instead of
// after them.
//
// Replace the same TPU kernels as point.cu: libecc_tpu/ops/pallas/point.py
// :_build_add (:470 -> _pallas_call3 :449, pallas_call :459), _build_dbl
// (:489) and _build_dbln_add (:507, the joint-table Straus step). They
// also stand for libecc_tpu/ops/pallas/rows.py:RowOps (:129), the O(K)
// body those TPU kernels take when the JAX limb count is over 30
// (point.py:163-170; P-521 is K = 37 limbs of 15 bits there): on Hopper a
// 521-bit product is the same template at K = 17, the one odd limb count
// of the port (nothing in the templates pairs limbs).
//
// Bound on the H100: integer-multiply issue, as at K = 8. An a = -3 add is
// 14 products for 9 x 68 bytes a lane, about 16,000 multiply-add slots; a
// double 3 squares and 10 products. Design: kernels 2 and 3 on a group of
// threads a lane (groupfield.cuh's formula_group_kernel with point.cuh's
// PointAdd and PointDbl, in the shape groupfield.cuh's AddShape sets; the
// limbs past 17 are zero), no more than 128 registers and no spill. Kernel
// 5 runs one thread a lane, the formula in registers; a point is 51
// registers at K = 17, so the two operands and the temporaries pass the 255
// a thread may hold and the compiler spills (ptxas -v, chip_smoke.py prints
// it): later work.
#include "point.cuh"

extern "C" {

// in: x1, y1, z1, x2, y2, z2; out: x3, y3, z3 (each uint32[17][n]).
// a = -3 only: another a_kind returns cudaErrorInvalidValue.
int point_add_k17(const ecc::CurveCtx<17>* C, const uint32_t* const* in,
                  uint32_t* const* out, long long n, void* stream) {
  return ecc::launch_group<ecc::PointAdd, 17, ecc::A_M3>(C, in, out, n,
                                                         stream);
}

int point_dbl_k17(const ecc::CurveCtx<17>* C, const uint32_t* const* in,
                  uint32_t* const* out, long long n, void* stream) {
  return ecc::launch_group<ecc::PointDbl, 17, ecc::A_M3>(C, in, out, n,
                                                         stream);
}

// Kernel 5: in: P's x, y, z, then T's; out: 2^ndbl * P + T.
ECC_DBLN_ADD_ENTRY_POINT(point_dbln_add_k17, 17, ecc::A_M3)

}  // extern "C"

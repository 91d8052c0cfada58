// Kernels 2, 3 and 5 at K = 14 for generic a (448-bit moduli: WEI448, the
// short-Weierstrass form of curve448, h = 4, over Ed448's p = 2^448 -
// 2^224 - 1): the templates of point.cuh, one C entry point per kernel,
// built together in a file of their own so that their large unrolled
// bodies compile beside the other libraries.
//
// Replace the same TPU kernels as point.cu: libecc_tpu/ops/pallas/point.py
// :_build_add (:470 -> _pallas_call3 :449, pallas_call :459), _build_dbl
// (:489) and _build_dbln_add (:507, the joint-table Straus step). With
// kernel 1 at K = 14 (mont.cu) they also stand for
// libecc_tpu/ops/pallas/rows.py:RowOps (:129), the O(K) body those TPU
// kernels take when the JAX limb count is over 30 (point.py:163-170;
// WEI448 is K = 32 limbs of 15 bits there): on Hopper a 448-bit product is
// the same template at K = 14. WEI448's keys import through the q*P
// subgroup check (sig/keys.py:order_check_mask, kernel 4 at K = 14 over
// these tables).
//
// Bound on the H100: integer-multiply issue. A generic-a add is 18 products
// for 9 x 56 bytes a lane, about 29,000 multiply-add slots; a double 3
// squares and 14 products; kernel 5 2 + 7n squares and 22 + 3n products.
// Design: kernels 2 and 3 on a group of threads a lane (groupfield.cuh's
// formula_group_kernel with point.cuh's PointAdd and PointDbl, in the shape
// groupfield.cuh's AddShape sets), no more than 128 registers and no spill;
// kernel 5 one thread a lane, the formula in registers: a point is 42
// registers at K = 14, so the two operands and the temporaries pass the 255
// a thread may hold and the compiler spills (ptxas -v, chip_smoke.py prints
// it).
#include "point.cuh"

extern "C" {

ECC_POINT_ENTRY_POINTS(14, ecc::A_GENERIC, ga)
ECC_DBLN_ADD_ENTRY_POINT(point_dbln_add_k14_ga, 14, ecc::A_GENERIC)

}  // extern "C"

// Kernels 2 and 3 at K = 12 for generic a (384-bit: BrainpoolP384r1) and
// kernels 2, 3 and 5 at K = 16 for a = -3 (512-bit: BrainpoolP512t1,
// BIGN512V1, GOST R 34.10-2012 512 paramSetA and paramSetB): the other
// formula set at the two limb counts point_wide.cu builds, one C entry
// point per (K, a), in a file of their own so that their large unrolled
// bodies compile beside point_wide.cu instead of after it.
//
// Replace the same TPU kernels as point.cu: libecc_tpu/ops/pallas/point.py
// :_build_add (:470 -> _pallas_call3 :449, pallas_call :459) and
// _build_dbl (:489), and kernel 5 _build_dbln_add (:507, the joint-table
// Straus step). The K = 16 instances also stand for
// libecc_tpu/ops/pallas/rows.py:RowOps (:129), the O(K) body those TPU
// kernels take when the JAX limb count is over 30 (point.py:163-170; the
// 512-bit curves are K = 37 there); BrainpoolP384r1 is K = 28 in the JAX
// package and runs its tile backend.
//
// Bound on the H100: integer-multiply issue. A generic-a add at K = 12 is
// 18 products for 9 x 48 bytes a lane; an a = -3 add at K = 16 is 14
// products for 9 x 64 bytes. Design: kernels 2 and 3 on a group of threads
// a lane (groupfield.cuh's formula_group_kernel with point.cuh's PointAdd
// and PointDbl, in the shape groupfield.cuh's AddShape sets), no more than
// 128 registers and no spill; kernel 5 one thread a lane, the formula in
// registers: at K = 16 a point is 48 registers, so the two operands and the
// temporaries pass the 255 a thread may hold and the compiler spills (ptxas
// -v, chip_smoke.py prints it).
#include "point.cuh"

extern "C" {

ECC_POINT_ENTRY_POINTS(12, ecc::A_GENERIC, ga)
ECC_POINT_ENTRY_POINTS(16, ecc::A_M3, m3)
ECC_DBLN_ADD_ENTRY_POINT(point_dbln_add_k16_m3, 16, ecc::A_M3)

}  // extern "C"

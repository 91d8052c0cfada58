// Kernels 2, 3 and 5 at K = 12 (384-bit moduli, a = -3: P-384) and K = 16
// (512-bit moduli, generic a: BrainpoolP512r1, GOST512, GOST R 34.10-2012
// 512 paramSetC and the other generic-a 512-bit curves of the registry),
// the templates of point.cuh built once each in a file of their own, so
// their large unrolled bodies compile beside the K = 8 file instead of
// after it.
//
// Replace the same TPU kernels as point.cu: libecc_tpu/ops/pallas/point.py
// :_build_add (:470 -> _pallas_call3 :449, pallas_call :459), _build_dbl
// (:489) and _build_dbln_add (:507; public point_dbln_add :551, which only
// the joint-table Straus, scalar_mul.straus_double_mul_public, runs). The
// K = 16 instances also stand for libecc_tpu/ops/pallas/rows.py:RowOps
// (:129), the O(K) body those TPU kernels take when the JAX limb count is
// over 30 (point.py:163-170; the 512-bit curves are K = 37 there): on
// Hopper a 512-bit product is the same template at K = 16, not a code
// path of its own. P-384 is K = 28 in the JAX package and runs its tile
// backend; here it is the same template at K = 12.
//
// Bound on the H100: integer-multiply issue, as at K = 8. A generic-a add
// is 18 products (12 + 2 by b3 + 4 by a and a^2) for 9 x 64 bytes a lane at
// K = 16, about 37,000 multiply-add slots; an a = -3 add at K = 12 is 14
// products for 9 x 48 bytes. Design: kernels 2 and 3 on a group of threads
// a lane (groupfield.cuh's formula_group_kernel with point.cuh's PointAdd
// and PointDbl, in the shape groupfield.cuh's AddShape sets), each thread a
// share of every element, no more than 128 registers and no spill. Kernel 5
// runs one thread a lane, the formula in registers; at K = 16 a point is 48
// registers, so the two operands and the formula's temporaries pass the 255
// a thread may hold and the compiler spills (ptxas -v, chip_smoke.py prints
// it): later work. Kernel 5 keeps the Jacobian point in registers across
// its n doublings (per lane 2 + 5n squares and 18 + 3n products at a = -3,
// 2 + 7n and 22 + 3n for generic a) for an add's bytes.
#include "point.cuh"

extern "C" {

// in: x1, y1, z1, x2, y2, z2; out: x3, y3, z3 (each uint32[12][n]).
// a = -3 only: another a_kind returns cudaErrorInvalidValue.
int point_add_k12(const ecc::CurveCtx<12>* C, const uint32_t* const* in,
                  uint32_t* const* out, long long n, void* stream) {
  return ecc::launch_group<ecc::PointAdd, 12, ecc::A_M3>(C, in, out, n,
                                                         stream);
}

int point_dbl_k12(const ecc::CurveCtx<12>* C, const uint32_t* const* in,
                  uint32_t* const* out, long long n, void* stream) {
  return ecc::launch_group<ecc::PointDbl, 12, ecc::A_M3>(C, in, out, n,
                                                         stream);
}

// As above with uint32[16][n] coordinates; generic a only.
int point_add_k16(const ecc::CurveCtx<16>* C, const uint32_t* const* in,
                  uint32_t* const* out, long long n, void* stream) {
  return ecc::launch_group<ecc::PointAdd, 16, ecc::A_GENERIC>(C, in, out,
                                                              n, stream);
}

int point_dbl_k16(const ecc::CurveCtx<16>* C, const uint32_t* const* in,
                  uint32_t* const* out, long long n, void* stream) {
  return ecc::launch_group<ecc::PointDbl, 16, ecc::A_GENERIC>(C, in, out,
                                                              n, stream);
}

// Kernel 5: in: P's x, y, z, then T's; out: 2^ndbl * P + T. The same a
// as kernels 2 and 3 of each K.
ECC_DBLN_ADD_ENTRY_POINT(point_dbln_add_k12, 12, ecc::A_M3)
ECC_DBLN_ADD_ENTRY_POINT(point_dbln_add_k16, 16, ecc::A_GENERIC)

}  // extern "C"

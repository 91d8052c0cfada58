// Kernels 2 and 3 at K = 6 (192-bit moduli: P-192, BrainpoolP192t1 with
// a = -3; BrainpoolP192r1 and SM2P192TEST with generic a; secp192k1 with
// a = 0), K = 7 (224-bit: P-224 and BrainpoolP224t1, a = -3;
// BrainpoolP224r1, generic a; secp224k1, a = 0) and K = 10 (320-bit:
// BrainpoolP320t1, a = -3; BrainpoolP320r1, generic a): the templates of
// point.cuh, one C entry point per (K, a), built together in a file of
// their own.
//
// Replace the same TPU kernels as point.cu: libecc_tpu/ops/pallas/point.py
// :_build_add (:470 -> _pallas_call3 :449, pallas_call :459) and
// _build_dbl (:489). These curves are K = 15, 17 and 24 limbs of 15 bits
// in the JAX package and run its tile backend; here each is the template
// at its own limb count. K = 7 is odd, like K = 17: nothing in the
// templates pairs limbs.
//
// Bound on the H100: integer-multiply issue, as at K = 8. An add is 14
// field products for a = -3 and a = 0 (12 + 2 by b3) and 18 for generic a
// (4 more, by a and a^2), a double 3 squares and 10 or 14 products, for 9
// or 6 x 4K bytes a lane: about 2,100 multiply-add slots an a = -3 add at K
// = 6 for 216 bytes. Design: kernels 2 and 3 on a group of threads a lane
// (groupfield.cuh's formula_group_kernel with point.cuh's PointAdd and
// PointDbl, in the shape groupfield.cuh's AddShape sets at each K: two
// threads at K = 6 and 10, four at K = 7), the a-specialisation a template
// flag.
#include "point.cuh"

extern "C" {

ECC_POINT_ENTRY_POINTS(6, ecc::A_M3, m3)
ECC_POINT_ENTRY_POINTS(6, ecc::A_GENERIC, ga)
ECC_POINT_ENTRY_POINTS(6, ecc::A_ZERO, a0)
ECC_POINT_ENTRY_POINTS(7, ecc::A_M3, m3)
ECC_POINT_ENTRY_POINTS(7, ecc::A_GENERIC, ga)
ECC_POINT_ENTRY_POINTS(7, ecc::A_ZERO, a0)
ECC_POINT_ENTRY_POINTS(10, ecc::A_M3, m3)
ECC_POINT_ENTRY_POINTS(10, ecc::A_GENERIC, ga)

}  // extern "C"

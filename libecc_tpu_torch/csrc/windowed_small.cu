// Kernel 4 at K = 6 (192-bit moduli, 48 windows: P-192 and
// BrainpoolP192t1 with a = -3, BrainpoolP192r1 and SM2P192TEST with
// generic a, secp192k1 with a = 0), K = 7 (224-bit moduli: P-224 and
// BrainpoolP224t1, a = -3, BrainpoolP224r1, generic a, 56 windows;
// secp224k1, a = 0, 57 windows of its 225-bit q over K = 7 coordinates)
// and K = 10 (320-bit, 80 windows: BrainpoolP320t1, a = -3,
// BrainpoolP320r1, generic a): the whole windowed v*Q for public scalars,
// w = 4, one (table, digits) pair. The template is windowed.cuh's, one C
// entry point per (K, a), built in a file of their own.
//
// Replaces libecc_tpu/ops/pallas/megamul.py:_build (:161, pallas_call :184)
// via windowed_mul (:217), npairs 1, model 'w'. These curves are K = 15,
// 17 and 24 limbs of 15 bits in the JAX package (its tile backend); here
// each is the template at its own limb count. The number of windows
// follows q's bits, not K: the digits come from the q-side scalars.
//
// Bound on the H100: integer-multiply issue. Per window 22 squares and 30
// products for a = -3, 30 and 34 for generic a, 26 and 26 for a = 0 (each
// doubling one square more and one product less than a = -3: 3 x^2 in
// place of 3 (x - delta)(x + delta)); at 8192 lanes about 0.17-0.20 ms of
// the card's multiply-add issue at K = 6, 0.26-0.33 ms at K = 7 and
// 0.76-0.92 ms at K = 10; chip_smoke.py computes the bound of each run.
// Design: as K = 8, the group loop (ECC_WG_ENTRY_POINT) in the shape
// groupfield.cuh's GroupShape sets at each K (two threads a lane at K = 6
// and 10, four at K = 7), the accumulator and the formula in registers,
// the entry read from device memory by index (PUBLIC scalars only).
#include "windowed.cuh"

extern "C" {

ECC_WG_ENTRY_POINT(windowed_mul_k6_m3_w4, 6, 1, ecc::A_M3)
ECC_WG_ENTRY_POINT(windowed_mul_k6_ga_w4, 6, 1, ecc::A_GENERIC)
ECC_WG_ENTRY_POINT(windowed_mul_k6_a0_w4, 6, 1, ecc::A_ZERO)
ECC_WG_ENTRY_POINT(windowed_mul_k7_m3_w4, 7, 1, ecc::A_M3)
ECC_WG_ENTRY_POINT(windowed_mul_k7_ga_w4, 7, 1, ecc::A_GENERIC)
ECC_WG_ENTRY_POINT(windowed_mul_k7_a0_w4, 7, 1, ecc::A_ZERO)
ECC_WG_ENTRY_POINT(windowed_mul_k10_m3_w4, 10, 1, ecc::A_M3)
ECC_WG_ENTRY_POINT(windowed_mul_k10_ga_w4, 10, 1, ecc::A_GENERIC)

}  // extern "C"

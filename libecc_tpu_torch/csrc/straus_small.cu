// Kernel 6 at K = 6 (192-bit moduli, 48 windows: P-192 and
// BrainpoolP192t1 with a = -3, BrainpoolP192r1 and SM2P192TEST with
// generic a, secp192k1 with a = 0), K = 7 (224-bit: P-224 and
// BrainpoolP224t1, a = -3, BrainpoolP224r1, generic a, 56 windows;
// secp224k1, a = 0, 57 windows of its 225-bit q) and K = 10 (320-bit, 80
// windows: BrainpoolP320t1, a = -3, BrainpoolP320r1, generic a): the whole
// Straus u*P + v*Q for public scalars with one [0..15] table per base,
// w = 4. The template is windowed.cuh's at NPAIRS = 2, one C entry point
// per (K, a), built in a file of their own.
//
// Replaces libecc_tpu/ops/pallas/megamul.py:_build (:161, pallas_call :184)
// via straus_mul (:224), npairs 2, model 'w' (the JAX package runs these
// curves at K = 15, 17 and 24 on its tile backend). ECFSDSA batch
// verification (sig/batch_verify.py) launches them.
//
// Bound on the H100: integer-multiply issue. Per window kernel 4's
// squares and products plus one complete add: 22 and 44 for a = -3, 30
// and 52 for generic a, 26 and 40 for a = 0; at 8192 lanes about
// 0.21-0.27 ms of the card's multiply-add issue at K = 6, 0.34-0.43 ms at
// K = 7 and 0.98-1.21 ms at K = 10; chip_smoke.py computes the bound of
// each run. Design: kernel 4's (windowed_small.cu: the group loop in
// GroupShape's shape at each K), the pair loop rolled.
#include "windowed.cuh"

extern "C" {

ECC_WG_ENTRY_POINT(straus_mul_k6_m3_w4, 6, 2, ecc::A_M3)
ECC_WG_ENTRY_POINT(straus_mul_k6_ga_w4, 6, 2, ecc::A_GENERIC)
ECC_WG_ENTRY_POINT(straus_mul_k6_a0_w4, 6, 2, ecc::A_ZERO)
ECC_WG_ENTRY_POINT(straus_mul_k7_m3_w4, 7, 2, ecc::A_M3)
ECC_WG_ENTRY_POINT(straus_mul_k7_ga_w4, 7, 2, ecc::A_GENERIC)
ECC_WG_ENTRY_POINT(straus_mul_k7_a0_w4, 7, 2, ecc::A_ZERO)
ECC_WG_ENTRY_POINT(straus_mul_k10_m3_w4, 10, 2, ecc::A_M3)
ECC_WG_ENTRY_POINT(straus_mul_k10_ga_w4, 10, 2, ecc::A_GENERIC)

}  // extern "C"

// Kernel 6 at K = 12 for generic a (384-bit: BrainpoolP384r1, 96 windows)
// and at K = 16 for a = -3 (512-bit: BrainpoolP512t1, BIGN512V1, GOST R
// 34.10-2012 512 paramSetA and paramSetB, 128 windows): the whole Straus
// u*P + v*Q for public scalars with one [0..15] table per base, w = 4;
// the other formula set at the two limb counts of straus_wide.cu, one C
// entry point per (K, a), in a file of their own.
//
// Replaces libecc_tpu/ops/pallas/megamul.py:_build (:161, pallas_call :184)
// via straus_mul (:224), npairs 2, model 'w'. The K = 16 instance is the
// port's counterpart of libecc_tpu/ops/pallas/rows.py:RowOps (:129) for
// this kernel on the a = -3 512-bit curves (K = 37 in the JAX package).
// ECFSDSA batch verification (sig/batch_verify.py) launches them.
//
// Bound on the H100: integer-multiply issue. Per window 30 squares and 52
// products for generic a, 22 and 44 for a = -3: about 2.1 ms of the
// card's multiply-add issue at 8192 lanes at K = 12 and 4.0 ms at K = 16;
// chip_smoke.py computes the bound of each run. Design: kernel 4's, the
// group loop with TPI = 4 threads a lane (3 limbs a thread at K = 12, 4
// at K = 16), the pair loop rolled.
#include "windowed.cuh"

extern "C" {

ECC_WG_ENTRY_POINT(straus_mul_k12_ga_w4, 12, 2, ecc::A_GENERIC)
ECC_WG_ENTRY_POINT(straus_mul_k16_m3_w4, 16, 2, ecc::A_M3)

}  // extern "C"

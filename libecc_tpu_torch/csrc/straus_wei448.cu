// Kernel 6 at K = 14 for generic a (448-bit moduli: WEI448, h = 4, 112
// windows of its 446-bit q): the whole Straus u*P + v*Q for public scalars
// with one [0..15] table per base, w = 4, in a file of its own.
//
// Replaces libecc_tpu/ops/pallas/megamul.py:_build (:161, pallas_call :184)
// via straus_mul (:224), npairs 2, model 'w'. With kernels 1-4 at K = 14 it
// is the port's counterpart of libecc_tpu/ops/pallas/rows.py:RowOps (:129)
// for this kernel on WEI448 (K = 32 in the JAX package). ECFSDSA batch
// verification (sig/batch_verify.py) launches it.
//
// Bound on the H100: integer-multiply issue. Per window 30 squares and 52
// products, about 3.2 ms of the card's multiply-add issue at 8192 lanes;
// chip_smoke.py computes the bound of each run. Design: kernel 4's
// (windowed_wei448.cu), the group loop with TPI = 4 threads a lane, 4
// limbs a thread (the last thread's top two zero), the pair loop rolled.
#include "windowed.cuh"

extern "C" {

ECC_WG_ENTRY_POINT(straus_mul_k14_ga_w4, 14, 2, ecc::A_GENERIC)

}  // extern "C"

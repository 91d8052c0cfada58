// Kernel 6 at K = 17 (521-bit moduli, a = -3: P-521, 131 windows of q's
// 521 bits): the whole Straus u*P + v*Q for public scalars with one
// [0..15] table per base, w = 4. The template is windowed.cuh's at
// NPAIRS = 2, built here in a file of its own so that its large unrolled
// body compiles beside the other libraries instead of after them.
//
// Replaces libecc_tpu/ops/pallas/megamul.py:_build (:161, pallas_call :184)
// via straus_mul (:224), npairs 2, model 'w'. With kernels 1-4 at K = 17
// it is the port's counterpart of libecc_tpu/ops/pallas/rows.py:RowOps
// (:129) for P-521 (K = 37 limbs of 15 bits in the JAX package). ECFSDSA
// batch verification on P-521 (sig/batch_verify.py) launches it.
//
// Bound on the H100: integer-multiply issue. Per window 22 squares and 44
// products (kernel 4's 22 and 30, one complete add more), about 4.6 ms of
// the card's multiply-add issue at 8192 lanes; chip_smoke.py computes the
// bound of each run. Design: kernel 4's (windowed_p521.cu), the group
// loop with TPI = 4 threads a lane, 5 limbs a thread (the last thread's
// top three zero), the pair loop rolled: the second table adds a pointer
// and a digit read, not code.
#include "windowed.cuh"

extern "C" {

ECC_WG_ENTRY_POINT(straus_mul_k17_w4, 17, 2, ecc::A_M3)

}  // extern "C"

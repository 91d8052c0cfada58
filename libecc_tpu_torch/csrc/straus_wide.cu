// Kernel 6 at K = 12 (384-bit moduli, a = -3: P-384, 96 windows) and K = 16
// (512-bit moduli, generic a: BrainpoolP512r1/t1, GOST512 and the other
// 512-bit curves of the registry, 128 windows): the whole Straus u*P + v*Q
// for public scalars with one [0..15] table per base, w = 4. The template
// is windowed.cuh's at NPAIRS = 2 (per window 4 Jacobian doublings, then
// P's entry under u's digit and Q's entry under v's digit, each one
// complete add), built here in a file of its own so that its large
// unrolled bodies compile beside the other libraries.
//
// Replaces libecc_tpu/ops/pallas/megamul.py:_build (:161, pallas_call :184)
// via straus_mul (:224), npairs 2, model 'w'. The K = 16 instance is the
// port's counterpart of libecc_tpu/ops/pallas/rows.py:RowOps (:129) for
// this kernel (the 512-bit curves are K = 37 in the JAX package); P-384 is
// K = 28 there and runs the tile backend, here the same template at
// K = 12. Batch verification (sig/batch_verify.py, ECFSDSA) launches them.
//
// Bound on the H100: integer-multiply issue. Per window 22 squares and 44
// products at a = -3 (kernel 4's 22 and 30, one complete add more), 30 and
// 52 for generic a (two squares more a doubling, the products by a and
// a^2 in each add): about 1.7 ms at K = 12 and 4.9 ms at K = 16 of the
// card's multiply-add issue at 8192 lanes; chip_smoke.py computes the
// bound of each run. Design: kernel 4's (windowed_wide.cu), the group
// loop with TPI = 4 threads a lane (3 limbs a thread at K = 12, 4 at
// K = 16), the pair loop rolled so that the second table adds a pointer
// and no code.
#include "windowed.cuh"

extern "C" {

ECC_WG_ENTRY_POINT(straus_mul_k12_w4, 12, 2, ecc::A_M3)
ECC_WG_ENTRY_POINT(straus_mul_k16_w4, 16, 2, ecc::A_GENERIC)

}  // extern "C"

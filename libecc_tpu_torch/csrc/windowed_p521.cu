// Kernel 4 at K = 17 (521-bit moduli, a = -3: P-521, 131 windows of q's 521
// bits): the whole windowed v*Q for public scalars, w = 4, one (table,
// digits) pair. The template is windowed.cuh's, built here in a file of
// its own so that its large unrolled body compiles beside the other
// libraries instead of after them.
//
// Replaces libecc_tpu/ops/pallas/megamul.py:_build (:161, pallas_call :184)
// via windowed_mul (:217), npairs 1, model 'w'. With kernels 1-3 at K = 17
// it is the port's counterpart of libecc_tpu/ops/pallas/rows.py:RowOps
// (:129) for P-521, which the JAX package runs at K = 37 limbs of 15 bits
// on that O(K) body.
//
// Bound on the H100: integer-multiply issue. Per window 4 Jacobian
// doublings, the to_jac / from_jac pair and one complete add: 22 squares
// and 30 products (a = -3), about 3.5 ms of the card's multiply-add issue
// at 8192 lanes; chip_smoke.py computes the bound of each run. The table
// read is one 51-word entry a window and lane, small beside the
// arithmetic. Design: windowed.cuh's group loop with TPI = 4 threads a
// lane, each holding 5 limbs of every element (limbs 17 to 19 of the
// last thread zero): every SM busy, carry chains 5 limbs long, no spill
// (one thread a lane would fill 64 SMs and spill 228 bytes). The entry is
// read from device memory by index (PUBLIC scalars only).
#include "windowed.cuh"

extern "C" {

ECC_WG_ENTRY_POINT(windowed_mul_k17_w4, 17, 1, ecc::A_M3)

}  // extern "C"

// Kernel 4 at K = 12 (384-bit moduli, a = -3: P-384, 96 windows of q's 384
// bits) and K = 16 (512-bit moduli, generic a: BrainpoolP512r1/t1, GOST512
// and the other 512-bit curves of the registry, 128 windows): the whole
// windowed v*Q for public scalars, w = 4, one (table, digits) pair. The
// template is windowed.cuh's, built here in a file of its own so that its
// large unrolled bodies compile beside the K = 8 file instead of after it.
//
// Replaces libecc_tpu/ops/pallas/megamul.py:_build (:161, pallas_call :184)
// via windowed_mul (:217), npairs 1, model 'w'. The K = 16 instance, with
// kernels 1-3 at K = 16, is the port's counterpart of
// libecc_tpu/ops/pallas/rows.py:RowOps (:129) for the short-Weierstrass
// model: the JAX package takes that O(K) body for its K = 37 limbs of 15
// bits (and, over the VMEM budget at w = 4, a 3-bit window,
// megamul.py:198-206); here the register file holds the accumulator and
// the table stays in device memory, so w = 4 serves every K.
//
// Bound on the H100: integer-multiply issue. Per window 4 Jacobian
// doublings, the to_jac / from_jac pair and one complete add: 22 squares
// and 30 products for a = -3; for generic a each doubling takes two
// squares more (x^2 and delta^2 for 3 x^2 + a delta^2) and the add four
// products more (by a and a^2): 30 squares and 34 products. At 8192 lanes
// that is about 1.3 ms of the card's multiply-add issue at K = 12 (96
// windows) and 3.7 ms at K = 16 (128 windows); chip_smoke.py computes the
// bound of each run. The table read is one 3K-word entry a window and
// lane, small beside the arithmetic.
// Design: windowed.cuh's group loop (groupfield.cuh) with TPI = 4 threads
// a lane, each holding 3 limbs of every element at K = 12 and 4 at
// K = 16: 8192 lanes are 256 blocks of 128 threads, two on every SM, and
// a product's carry chains are 3 or 4 limbs long (one thread a lane
// would fill 64 SMs, run each product as a chain of 2K^2 multiply-adds
// and spill at K = 16). The entry is read from device memory by index
// (PUBLIC scalars only).
#include "windowed.cuh"

extern "C" {

ECC_WG_ENTRY_POINT(windowed_mul_k12_w4, 12, 1, ecc::A_M3)
ECC_WG_ENTRY_POINT(windowed_mul_k16_w4, 16, 1, ecc::A_GENERIC)

}  // extern "C"

// Kernel 4 at K = 14 for generic a (448-bit moduli: WEI448, h = 4; its
// 446-bit q gives 112 windows): the whole windowed m*P for public scalars,
// w = 4, one (table, digits) pair, built in a file of its own so that its
// large unrolled body compiles beside the other libraries.
//
// Replaces libecc_tpu/ops/pallas/megamul.py:_build (:161, pallas_call :184)
// via windowed_mul (:217), npairs 1, model 'w'. With kernels 1-3 at K = 14
// it is the port's counterpart of libecc_tpu/ops/pallas/rows.py:RowOps
// (:129) for WEI448, which the JAX package runs at K = 32 limbs of 15 bits
// on that O(K) body. Two paths launch it: the q*P subgroup check of
// public-key import (sig/keys.py:order_check_mask, m = q on every lane)
// and the v*Q of ECDSA verification.
//
// Bound on the H100: integer-multiply issue. Per window 30 squares and 34
// products (generic a), about 2.4 ms of the card's multiply-add issue at
// 8192 lanes; chip_smoke.py computes the bound of each run. Design:
// windowed.cuh's group loop with TPI = 4 threads a lane, each holding 4
// limbs of every element (limbs 14 and 15 of the last thread zero): every
// SM busy, carry chains 4 limbs long, no spill (one thread a lane would
// fill 64 SMs and spill).
#include "windowed.cuh"

extern "C" {

ECC_WG_ENTRY_POINT(windowed_mul_k14_ga_w4, 14, 1, ecc::A_GENERIC)

}  // extern "C"

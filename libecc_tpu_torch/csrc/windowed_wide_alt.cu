// Kernel 4 at K = 12 for generic a (384-bit: BrainpoolP384r1, 96 windows)
// and at K = 16 for a = -3 (512-bit: BrainpoolP512t1, BIGN512V1, GOST R
// 34.10-2012 512 paramSetA and paramSetB, 128 windows): the whole windowed
// v*Q for public scalars, w = 4, one (table, digits) pair; the other
// formula set at the two limb counts of windowed_wide.cu, one C entry
// point per (K, a), in a file of their own so that their large unrolled
// bodies compile beside the other libraries.
//
// Replaces libecc_tpu/ops/pallas/megamul.py:_build (:161, pallas_call :184)
// via windowed_mul (:217), npairs 1, model 'w'. The K = 16 instance, with
// kernels 1-3 at K = 16 and a = -3, is the port's counterpart of
// libecc_tpu/ops/pallas/rows.py:RowOps (:129) for these curves, which the
// JAX package runs at K = 37 limbs of 15 bits on that O(K) body.
//
// Bound on the H100: integer-multiply issue. Per window 30 squares and 34
// products for generic a, 22 and 30 for a = -3: about 1.6 ms of the card's
// multiply-add issue at 8192 lanes at K = 12 and 3.1 ms at K = 16;
// chip_smoke.py computes the bound of each run. Design: windowed.cuh's
// group loop with TPI = 4 threads a lane (3 limbs a thread at K = 12, 4
// at K = 16), as windowed_wide.cu: every SM busy, short carry chains, no
// spill (one thread a lane would fill 64 SMs and spill at K = 16).
#include "windowed.cuh"

extern "C" {

ECC_WG_ENTRY_POINT(windowed_mul_k12_ga_w4, 12, 1, ecc::A_GENERIC)
ECC_WG_ENTRY_POINT(windowed_mul_k16_m3_w4, 16, 1, ecc::A_M3)

}  // extern "C"

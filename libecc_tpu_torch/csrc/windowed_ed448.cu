// Kernel 7 at K = 14 for Edwards a = 1 (Ed448: 448-bit p, 112 windows of
// q's 446 bits): the whole windowed m*P for public scalars in extended
// coordinates, w = 4, one (table, digits) pair, built in a file of its own
// so that it compiles beside the other libraries.
//
// Replaces libecc_tpu/ops/pallas/megamul.py:_build (:161, pallas_call :184;
// Edwards branch of _build_kern :95-100, window body :128-147) via
// windowed_mul (:217), npairs 1, model 'ed'; with kernels 1, 8a and 8b at
// K = 14 it is the port's counterpart of libecc_tpu/ops/pallas/rows.py:
// RowOps (:129), the O(K) body the JAX package takes for Ed448's K = 32
// limbs of 15 bits. Ed448 verification (sig/eddsa.py, through
// curves/scalar_mul.py:windowed_mul_public) launches it.
//
// Bound on the H100: integer-multiply issue. Per window 16 squares and 23
// products (4 dbl-2008-hwcd, the first three without T, and one
// add-2008-hwcd of 10 products), about 1.55 ms of the card's multiply-add
// issue at 8192 lanes; chip_smoke.py computes the bound of each run.
// Design: windowed.cuh's Edwards group loop with TPI = 4 threads a lane,
// each holding 4 limbs of every element (limbs 14 and 15 of the last
// thread zero): every SM busy, carry chains 4 limbs long, an extended
// point 16 registers a thread, no more than 128 registers a thread (one
// thread a lane fills 64 SMs, holds a point in 56 registers and spills).
#include "windowed.cuh"

extern "C" {

// digits: int32[nwin][n] (MSW first); table: uint32[16][4][14][n]; out: x,
// y, z, t (each uint32[14][n]). Returns cudaErrorInvalidValue for a curve
// with a != 1.
ECC_EDG_ENTRY_POINT(windowed_mul_ed_k14_w4, 14, 1, ecc::ED_A_1)

}  // extern "C"

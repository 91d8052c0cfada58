// Kernel 6-ed at K = 14 (448-bit moduli, Edwards a = 1: Ed448, 112 windows
// of q's 446 bits): the whole Straus u*P + v*Q for public scalars in
// extended coordinates, one [0..15] table per base, w = 4. The template is
// windowed.cuh's Edwards group loop at NPAIRS = 2 (per window 4
// dbl-2008-hwcd doublings, then P's entry under u's digit and Q's entry
// under v's digit, each one add-2008-hwcd), built here in a file of its
// own so that it compiles beside windowed_ed448.cu.
//
// Replaces libecc_tpu/ops/pallas/megamul.py:_build (:161, pallas_call :184)
// via straus_mul (:224), npairs 2, model 'ed'; with kernels 1, 8a and 8b
// at K = 14 it is the port's counterpart of
// libecc_tpu/ops/pallas/rows.py:RowOps (:129), the O(K) body the JAX
// package takes for Ed448's K = 32 limbs of 15 bits. Ed448 batch
// verification (sig/batch_verify.py:eddsa_verify_batch) launches it.
//
// Bound on the H100: integer-multiply issue. Per window 16 squares and 33
// products (kernel 7's 16 and 23 at a = 1, one add of 10 products more),
// about 2.0 ms of the card's multiply-add issue at 8192 lanes;
// chip_smoke.py computes the bound of each run. Design: kernel 7's
// (windowed_ed448.cu), the group loop with TPI = 4 threads a lane, 4 limbs
// a thread, the pair loop rolled.
#include "windowed.cuh"

extern "C" {

// digits = (u's, v's): int32[nwin][n] each (MSW first); tables = (P's,
// Q's): uint32[16][4][14][n] each; out: x, y, z, t (each uint32[14][n]).
// Returns cudaErrorInvalidValue for a curve with a != 1.
ECC_EDG_ENTRY_POINT(straus_mul_ed_k14_w4, 14, 2, ecc::ED_A_1)

}  // extern "C"

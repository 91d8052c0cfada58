// Kernel 6-ed at K = 14 (448-bit moduli, Edwards a = 1: Ed448, 112 windows
// of q's 446 bits): the whole Straus u*P + v*Q for public scalars in
// extended coordinates, one [0..15] table per base, w = 4. The template is
// windowed.cuh's Edwards loop at NPAIRS = 2 (per window 4 dbl-2008-hwcd
// doublings, then P's entry under u's digit and Q's entry under v's digit,
// each one add-2008-hwcd), built here in a file of its own so that its
// large unrolled body compiles beside windowed.cu instead of after it.
//
// Replaces libecc_tpu/ops/pallas/megamul.py:_build (:161, pallas_call :184)
// via straus_mul (:224), npairs 2, model 'ed'; with kernels 1, 8a and 8b
// at K = 14 it is the port's counterpart of
// libecc_tpu/ops/pallas/rows.py:RowOps (:129), the O(K) body the JAX
// package takes for Ed448's K = 32 limbs of 15 bits. Ed448 batch
// verification (sig/batch_verify.py:eddsa_verify_batch) launches it.
//
// Bound on the H100: integer-multiply issue. Per window 16 squares and 36
// products (kernel 7's 16 and 26 at a = 1, one add of 10 products more),
// about 2.1 ms of the card's multiply-add issue at 8192 lanes;
// chip_smoke.py computes the bound of each run. Design: kernel 7's, the
// pair loop rolled. An extended point is 56 registers at K = 14, so the
// accumulator, the entry and the temporaries pass the 255 a thread may
// hold and the compiler spills (ptxas -v, chip_smoke.py prints it); right
// first.
#include "windowed.cuh"

extern "C" {

// digits = (u's, v's): int32[nwin][n] each (MSW first); tables = (P's,
// Q's): uint32[16][4][14][n] each; out: x, y, z, t (each uint32[14][n]).
// Returns cudaErrorInvalidValue for a curve with a != 1.
int straus_mul_ed_k14_w4(const ecc::EdCurveCtx<14>* C,
                         const int32_t* const* digits, int nwin,
                         const uint32_t* const* tables, uint32_t* const* out,
                         long long n, void* stream) {
  return ecc::launch_ed<14, ecc::ED_A_1, 2>(C, digits, nwin, tables, out, n,
                                            stream);
}

}  // extern "C"

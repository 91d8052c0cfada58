// Kernels 4, 6, 7 and 6-ed: the whole fixed-window scalar multiply m*P and
// the whole Straus dual multiply u*P + v*Q, w = 4.
//
// Replace the TPU kernel libecc_tpu/ops/pallas/megamul.py:_build (:161,
// pallas_call :184; body _build_kern :84-151, window body :128-147):
// via windowed_mul (:217) with npairs = 1, model 'w' (kernel 4; window
// block point.py:_dbln_jac_block :300) and model 'ed' (kernel 7; Edwards
// branch _build_kern :95-100); via straus_mul (:224) with npairs = 2, model
// 'w' (kernel 6) and model 'ed' (kernel 6-ed). One template serves all
// four: NPAIRS is the number of (table, digits) pairs added per window.
//
// Short Weierstrass (kernels 4 and 6, projective): per window, most
// significant first: to_jac (Z = 0 lanes take (1, 1, 0)), w dbl-2001-b
// doublings, from_jac, then for each pair in order one complete RCB add of
// entry d of the lane's 16-entry table [0..15]P (for Straus: P's table
// with u's digit, then Q's table with v's digit). The accumulator stays in
// registers across all windows; only the tables and the digits are read
// from device memory and the result written once. The loop is a template
// over K in windowed.cuh, built here at K = 8 for every a; windowed.cuh
// lists the other instances. A group of threads carries a lane
// (windowed.cuh's group loop over groupfield.cuh's field, in the shape
// its GroupShape sets at each K).
//
// Twisted Edwards (kernels 7 and 6-ed, extended): the accumulator starts
// at (0 : 1 : 1 : 0); per window, most significant first, w
// dbl-2008-hwcd doublings, then for each pair one extended add of the
// lane's entry (edpoint.cuh: add-2008-hwcd-3 for a = -1, add-2008-hwcd for
// a = 1). Both formula sets are complete on the curves they are built for,
// so there is no identity select. Built here for a = -1 at K = 8
// (Ed25519: kernels 7 and 6-ed on the group loop in groupfield.cuh's
// GroupShape<8>); at K = 14 for a = 1
// (Ed448: q has 446 bits, so 112 windows) kernel 7 is built in
// windowed_ed448.cu and 6-ed in straus_ed448.cu, on the group loop. With
// kernels 1, 8a and 8b at K = 14 those are the port's counterpart of the
// TPU's rows.py:RowOps backend, :129, which megamul.py takes for Ed448's
// K = 32.
//
// The order of the adds is the reference's: the projective values (not
// only the points) are held bitwise against the plain versions and, on the
// CPU, against the JAX package.
//
// PUBLIC SCALARS ONLY (all four kernels). The entry is read by index, so
// the memory access pattern depends on the digit: only windowed_mul_public
// and the Straus public path (batch verification) may call these kernels.
// A secret-scalar caller must not use them; the TPU kernel's masked sum
// over all 16 entries (megamul.py:_select_entry :52) gives the same value
// at a constant schedule and is the form such a caller would need.
//
// Bound on the H100: integer-multiply issue (per window 22 squares and 30
// products in kernel 4, 16 and 25 in kernel 7; one add more per pair: 22
// and 44 in kernel 6, 16 and 34 in kernel 6-ed; at K = 14, a = 1, 16 and
// 23 in kernel 7 and 16 and 33 in 6-ed: the add takes one product more,
// and on the group loop the doublings before the last of a window take
// no T), plus the table bytes: each
// window reads one 3K- or 4K-word entry per pair and lane, 64 x 96 or
// 64 x 128 bytes per pair at K = 8, so table traffic is small beside the
// arithmetic. Design: the accumulator and all formula temporaries in
// registers, table entries read straight from device memory (coalesced
// across lanes of a warp for one limb), the pair loop rolled so that the
// second pair adds no code and few registers. One thread a lane runs each
// product as one long chain, and at 8192 lanes fills 64 of the 132 SMs
// with one warp a scheduler: kernels 4 and 6 so ran at 10.9-15x their
// bounds at every K on an H100 80GB HBM3 at 700 W, and spilled at K >= 14
// (an extended point is 56 registers at K = 14). So all four kernels run
// the group loop instead, at every K: two or four threads a lane, each
// with a share of every element, so that 8192 lanes give every SM two to
// four times the warps and no thread needs more than 128 registers (the
// notes in groupfield.cuh; the shape at each K in its GroupShape). The
// one-thread Edwards form (ECC_ED_ENTRY_POINT) stays as
// scripts/time_group_loop.py's baseline. Staging the tables in shared
// memory (1.5 or 2 KB a lane and pair) is later work.
#include "windowed.cuh"

extern "C" {

// Kernel 4 (m*P, one pair) and kernel 6 (u*P + v*Q; digits = (u's, v's),
// tables = (P's, Q's)) for every a, with uint32[16][3][8][n] tables and out
// x, y, z (ECC_WG_ENTRY_POINT: the group loop).
ECC_WG_ENTRY_POINT(windowed_mul_k8_w4, 8, 1, ecc::A_M3, ecc::A_ZERO,
                   ecc::A_GENERIC)
ECC_WG_ENTRY_POINT(straus_mul_k8_w4, 8, 2, ecc::A_M3, ecc::A_ZERO,
                   ecc::A_GENERIC)

// Kernel 7 (m*P) and kernel 6-ed (u*P + v*Q) at a = -1 (Ed25519), with
// uint32[16][4][8][n] tables and out x, y, z, t (ECC_EDG_ENTRY_POINT: the
// group loop).
ECC_EDG_ENTRY_POINT(windowed_mul_ed_k8_w4, 8, 1, ecc::ED_A_M1)
ECC_EDG_ENTRY_POINT(straus_mul_ed_k8_w4, 8, 2, ecc::ED_A_M1)

}  // extern "C"

// Kernels 4 and 7: the whole fixed-window scalar multiply m*P, w = 4.
//
// Replace the TPU kernel libecc_tpu/ops/pallas/megamul.py:_build (:161,
// pallas_call :184) via windowed_mul (:217) with npairs = 1: model 'w'
// (kernel 4; body _build_kern :84-151, window block
// point.py:_dbln_jac_block :300) and model 'ed' (kernel 7; Edwards branch
// _build_kern :95-100, window body :137-139).
//
// Kernel 4 (short Weierstrass, projective):
// Per window, most significant first: to_jac (Z = 0 lanes take (1, 1, 0)),
// w dbl-2001-b doublings, from_jac, fetch table entry d of the lane's
// 16-entry table [0..15]P, one complete RCB add. The accumulator stays in
// registers across all windows; only the table and the digits are read
// from device memory and the result written once.
//
// Kernel 7 (twisted Edwards, extended, a = -1): the accumulator starts at
// (0 : 1 : 1 : 0); per window, most significant first, w dbl-2008-hwcd
// doublings, then one add-2008-hwcd-3 of the lane's table entry. Both
// formulas are complete for a = -1, so there is no identity select.
//
// PUBLIC SCALARS ONLY (both kernels). The entry is read by index, so the
// memory access pattern depends on the digit: only windowed_mul_public
// (and later the Straus public path) may call these kernels. A
// secret-scalar caller must not use them; the TPU kernel's masked sum
// over all 16 entries (megamul.py:_select_entry :52) gives the same value
// at a constant schedule and is the form such a caller would need.
//
// Bound on the H100: integer-multiply issue (~3,300 field products per
// lane for a 256-bit scalar in kernel 4, 64 x (16 squares + 25 products)
// in kernel 7), plus the table bytes: each window reads one 3K- or 4K-word
// entry per lane, 64 x 96 or 64 x 128 bytes at K = 8, so table traffic
// is small beside the arithmetic. Design: one thread per lane, accumulator
// and all formula temporaries in registers, table entries read straight
// from device memory (coalesced across lanes of a warp for one limb).
// Staging the table in shared memory (1.5 or 2 KB a lane) is later work.
#include "edpoint.cuh"
#include "point.cuh"

namespace ecc {

constexpr int kWindow = 4;
constexpr int kEntries = 1 << kWindow;

template <int K, int AK>
__global__ void __launch_bounds__(128)
windowed_mul_kernel(const CurveCtx<K> C, const int32_t* __restrict__ digits,
                    int nwin, const uint32_t* __restrict__ table,
                    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                    uint32_t* __restrict__ oz, long long n) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  Pt<K> acc;
  acc.x = fe_zero<K>();
  acc.y = fe_const<K>(C.one);
  acc.z = fe_zero<K>();
  const long long coord_stride = (long long)K * n;      // one coordinate
  const long long entry_stride = 3 * coord_stride;      // one table entry
#pragma unroll 1
  for (int wi = 0; wi < nwin; ++wi) {
    Pt<K> J = to_jac<K>(acc, C);
#pragma unroll 1
    for (int d = 0; d < kWindow; ++d) J = jac_dbl<K, AK>(J, C);
    acc = from_jac<K>(J, C);
    const int dig = digits[(long long)wi * n + lane] & (kEntries - 1);
    const uint32_t* e = table + dig * entry_stride;
    const Pt<K> T = load_pt<K>(e, e + coord_stride, e + 2 * coord_stride, n,
                               lane);
    acc = rcb_add<K, AK>(acc, T, C);
  }
  store_pt<K>(ox, oy, oz, n, lane, acc);
}

template <int K>
__global__ void __launch_bounds__(128)
windowed_mul_ed_kernel(const EdCurveCtx<K> C,
                       const int32_t* __restrict__ digits, int nwin,
                       const uint32_t* __restrict__ table,
                       uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                       uint32_t* __restrict__ oz, uint32_t* __restrict__ ot,
                       long long n) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  ExtPt<K> acc;
  acc.x = fe_zero<K>();
  acc.y = fe_const<K>(C.one);
  acc.z = fe_const<K>(C.one);
  acc.t = fe_zero<K>();
  const long long coord_stride = (long long)K * n;
  const long long entry_stride = 4 * coord_stride;
#pragma unroll 1
  for (int wi = 0; wi < nwin; ++wi) {
#pragma unroll 1
    for (int d = 0; d < kWindow; ++d)
      acc = ed_dbl_m1<K>(acc.x, acc.y, acc.z, C);
    const int dig = digits[(long long)wi * n + lane] & (kEntries - 1);
    const uint32_t* e = table + dig * entry_stride;
    const ExtPt<K> T = load_ext<K>(e, e + coord_stride, e + 2 * coord_stride,
                                   e + 3 * coord_stride, n, lane);
    acc = ed_add_m1<K>(acc, T, C);
  }
  store_ext<K>(ox, oy, oz, ot, n, lane, acc);
}

constexpr int kThreads = 128;

template <int AK>
void launch(const CurveCtx<8>& C, const int32_t* digits, int nwin,
            const uint32_t* table, uint32_t* const* out, long long n,
            cudaStream_t s) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  windowed_mul_kernel<8, AK><<<blocks, kThreads, 0, s>>>(
      C, digits, nwin, table, out[0], out[1], out[2], n);
}

}  // namespace ecc

extern "C" {

// digits: int32[nwin][n] MSW first; table: uint32[16][3][8][n];
// out: x, y, z (each uint32[8][n]).
int windowed_mul_k8_w4(const ecc::CurveCtx<8>* C, const int32_t* digits,
                       int nwin, const uint32_t* table, uint32_t* const* out,
                       long long n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    switch (C->a_kind) {
      case ecc::A_M3: ecc::launch<ecc::A_M3>(*C, digits, nwin, table, out, n, s); break;
      case ecc::A_ZERO: ecc::launch<ecc::A_ZERO>(*C, digits, nwin, table, out, n, s); break;
      default: ecc::launch<ecc::A_GENERIC>(*C, digits, nwin, table, out, n, s); break;
    }
  }
  return (int)cudaGetLastError();
}

// digits: int32[nwin][n] MSW first; table: uint32[16][4][8][n];
// out: x, y, z, t. Returns cudaErrorInvalidValue for a curve with a != -1.
int windowed_mul_ed_k8_w4(const ecc::EdCurveCtx<8>* C, const int32_t* digits,
                          int nwin, const uint32_t* table,
                          uint32_t* const* out, long long n, void* stream) {
  if (C->a_kind != ecc::ED_A_M1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const unsigned blocks =
        (unsigned)((n + ecc::kThreads - 1) / ecc::kThreads);
    ecc::windowed_mul_ed_kernel<8><<<blocks, ecc::kThreads, 0,
                                     (cudaStream_t)stream>>>(
        *C, digits, nwin, table, out[0], out[1], out[2], out[3], n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

// The window loops of kernels 4 and 6 (short Weierstrass) and 7 and 6-ed
// (twisted Edwards) as templates over K, the formula set AK and the number
// of (table, digits) pairs NPAIRS, with their launchers. windowed.cu
// builds them at K = 8 (every a; Edwards a = -1; one and two pairs) and
// the Edwards loop at K = 14 (a = 1, one pair); windowed_wide.cu kernel 4
// at K = 12 (a = -3) and K = 16 (generic a); windowed_p521.cu kernel 4 at
// K = 17 (a = -3); straus_wide.cu kernel 6 at K = 12 and 16; straus_ed448.cu
// kernel 6-ed at K = 14 (a = 1); windowed_small.cu and straus_small.cu
// kernels 4 and 6 at K = 6 and 7 (every a) and K = 10 (a = -3, generic
// a); windowed_wide_alt.cu and straus_wide_alt.cu kernels 4 and 6 at
// K = 12 (generic a) and K = 16 (a = -3); straus_p521.cu kernel 6 at
// K = 17 (a = -3); windowed_wei448.cu and straus_wei448.cu kernels 4 and
// 6 at K = 14 (generic a: WEI448). Each file is one nvcc process of the
// parallel build.
// The design notes are in windowed.cu.
#pragma once

#include "edpoint.cuh"
#include "point.cuh"

namespace ecc {

constexpr int kWindow = 4;
constexpr int kEntries = 1 << kWindow;

// The (digits, table) pairs of one launch: digits int32[nwin][n] MSW
// first, table uint32[16][ncoord][K][n].
template <int NPAIRS>
struct Pairs {
  const int32_t* digits[NPAIRS];
  const uint32_t* table[NPAIRS];
};

template <int K, int AK, int NPAIRS>
__global__ void __launch_bounds__(128)
windowed_mul_kernel(const CurveCtx<K> C, const Pairs<NPAIRS> pr, int nwin,
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
#pragma unroll 1
    for (int pi = 0; pi < NPAIRS; ++pi) {
      const int dig = pr.digits[pi][(long long)wi * n + lane] & (kEntries - 1);
      const uint32_t* e = pr.table[pi] + dig * entry_stride;
      const Pt<K> T = load_pt<K>(e, e + coord_stride, e + 2 * coord_stride,
                                 n, lane);
      acc = rcb_add<K, AK>(acc, T, C);
    }
  }
  store_pt<K>(ox, oy, oz, n, lane, acc);
}

constexpr int kThreads = 128;

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <int NPAIRS>
Pairs<NPAIRS> pairs_of(const int32_t* const* digits,
                       const uint32_t* const* tables) {
  Pairs<NPAIRS> pr;
  for (int i = 0; i < NPAIRS; ++i) {
    pr.digits[i] = digits[i];
    pr.table[i] = tables[i];
  }
  return pr;
}

// Kernels 4 and 6 at K with NPAIRS pairs for the formula sets AKs (see
// launch_for_a); out: x, y, z.
template <int K, int NPAIRS, int... AKs>
int launch_w(const CurveCtx<K>* C, const int32_t* const* digits, int nwin,
             const uint32_t* const* tables, uint32_t* const* out,
             long long n, void* stream) {
  const Pairs<NPAIRS> pr = pairs_of<NPAIRS>(digits, tables);
  return launch_for_a<AKs...>(C->a_kind, n, [&](auto ak) {
    windowed_mul_kernel<K, decltype(ak)::value, NPAIRS>
        <<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
            *C, pr, nwin, out[0], out[1], out[2], n);
  });
}

// The Edwards loop of kernels 7 and 6-ed at K with the formula set AK and
// NPAIRS pairs (see windowed.cu); out: x, y, z, t.
template <int K, int AK, int NPAIRS>
__global__ void __launch_bounds__(128)
windowed_mul_ed_kernel(const EdCurveCtx<K> C, const Pairs<NPAIRS> pr,
                       int nwin, uint32_t* __restrict__ ox,
                       uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                       uint32_t* __restrict__ ot, long long n) {
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
      acc = ed_dbl<K, AK>(acc.x, acc.y, acc.z, C);
#pragma unroll 1
    for (int pi = 0; pi < NPAIRS; ++pi) {
      const int dig = pr.digits[pi][(long long)wi * n + lane] & (kEntries - 1);
      const uint32_t* e = pr.table[pi] + dig * entry_stride;
      const ExtPt<K> T = load_ext<K>(e, e + coord_stride,
                                     e + 2 * coord_stride,
                                     e + 3 * coord_stride, n, lane);
      acc = ed_add<K, AK>(acc, T, C);
    }
  }
  store_ext<K>(ox, oy, oz, ot, n, lane, acc);
}

template <int K, int AK, int NPAIRS>
int launch_ed(const EdCurveCtx<K>* C, const int32_t* const* digits,
              int nwin, const uint32_t* const* tables, uint32_t* const* out,
              long long n, void* stream) {
  if (C->a_kind != AK) return (int)cudaErrorInvalidValue;
  if (n > 0)
    windowed_mul_ed_kernel<K, AK, NPAIRS><<<blocks_for(n), kThreads, 0,
                                            (cudaStream_t)stream>>>(
        *C, pairs_of<NPAIRS>(digits, tables), nwin, out[0], out[1], out[2],
        out[3], n);
  return (int)cudaGetLastError();
}

}  // namespace ecc

// The C entry point NAME of kernel 4 (NPAIRS = 1) or 6 (NPAIRS = 2) for one
// (K, formula set AK). digits: NPAIRS pointers to int32[nwin][n] (MSW
// first); tables: NPAIRS pointers to uint32[16][3][K][n] (for kernel 6,
// P's then Q's); out: x, y, z (each uint32[K][n]). A context of another
// a_kind returns cudaErrorInvalidValue and launches nothing.
#define ECC_W_ENTRY_POINT(NAME, K, NPAIRS, AK)                             \
  int NAME(const ecc::CurveCtx<K>* C, const int32_t* const* digits,       \
           int nwin, const uint32_t* const* tables, uint32_t* const* out,  \
           long long n, void* stream) {                                    \
    return ecc::launch_w<K, NPAIRS, AK>(C, digits, nwin, tables, out, n,   \
                                        stream);                           \
  }

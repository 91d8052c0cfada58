// The window loops of kernels 4 and 6 (short Weierstrass) and 7 and 6-ed
// (twisted Edwards) as templates over K, the formula set AK and the number
// of (table, digits) pairs NPAIRS, with their launchers. Each loop is one
// text over a field type (the formulas of point.cuh and edpoint.cuh are
// templates over it) and comes in two forms:
//
// * a group of threads a lane (windowed_mul_group_kernel,
//   windowed_mul_ed_group_kernel; groupfield.cuh's GroupField), its shape
//   at each K set by groupfield.cuh's GroupShape: kernels 4 and 6 at
//   every (K, a), windowed.cu at K = 8 (every a), windowed_small.cu and
//   straus_small.cu at K = 6 and 7 (every a) and K = 10 (a = -3, generic
//   a), windowed_wide.cu and straus_wide.cu at K = 12 (a = -3) and K = 16
//   (generic a), windowed_wide_alt.cu and straus_wide_alt.cu at K = 12
//   (generic a) and K = 16 (a = -3), windowed_wei448.cu and
//   straus_wei448.cu at K = 14 (generic a: WEI448), windowed_p521.cu and
//   straus_p521.cu at K = 17 (a = -3: P-521); and the Edwards kernels 7 in
//   windowed_ed448.cu and 6-ed in straus_ed448.cu at K = 14 (a = 1: Ed448)
//   and 7 and 6-ed in windowed.cu at K = 8 (a = -1: Ed25519);
// * one thread a lane (windowed_mul_kernel, windowed_mul_ed_kernel;
//   field.cuh's ThreadField): no entry point of the package. Both forms
//   stay for scripts/time_group_loop.py, which builds every entry point
//   of kernels 4, 6, 7 and 6-ed in them (ECC_W_ENTRY_POINT,
//   ECC_ED_ENTRY_POINT) as the measure of the group loop.
//
// Each file is one nvcc process of the parallel build.
//
// Bound on the H100: integer multiply-add issue (the design notes are in
// windowed.cu). One thread a lane, 8192 lanes fill 64 of the 132 SMs with
// one warp a scheduler and run each product as one thread's chain of 2K^2
// multiply-adds: 10.9-15x the bound at every K, with 255 registers and
// spills at K >= 14. The group loop gives the SMs two or four times the
// warps, a thread 2 to 5 limbs of each element and carry chains of that
// length, needs no more than 128 registers, and on the H100 (80GB HBM3,
// 700 W) runs kernels 4 and 6 at 3.6-8x the bound (the most at K = 6
// and 7).
#pragma once

#include "edpoint.cuh"
#include "groupfield.cuh"
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

// The short-Weierstrass window loop over a field type F (field.cuh's
// ThreadField or groupfield.cuh's GroupField): per window to_jac, w
// doublings, from_jac, then one complete add of each pair's entry under
// its digit. Returns the lane's accumulator (in F's elements).
template <int AK, int NPAIRS, class F, class E = typename F::E>
__device__ __forceinline__ PtOf<E> window_loop(const F& f,
                                               const Pairs<NPAIRS>& pr,
                                               int nwin, long long n,
                                               long long lane) {
  PtOf<E> acc;
  acc.x = f.zero();
  acc.y = f.one();
  acc.z = f.zero();
  const long long coord_stride = (long long)F::kLimbs * n;  // a coordinate
  const long long entry_stride = 3 * coord_stride;          // an entry
#pragma unroll 1
  for (int wi = 0; wi < nwin; ++wi) {
    PtOf<E> J = to_jac(f, acc);
#pragma unroll 1
    for (int d = 0; d < kWindow; ++d) J = jac_dbl<AK>(f, J);
    acc = from_jac(f, J);
#pragma unroll 1
    for (int pi = 0; pi < NPAIRS; ++pi) {
      const int dig = pr.digits[pi][(long long)wi * n + lane] & (kEntries - 1);
      const uint32_t* e = pr.table[pi] + dig * entry_stride;
      PtOf<E> T;
      T.x = f.load(e, n, lane);
      T.y = f.load(e + coord_stride, n, lane);
      T.z = f.load(e + 2 * coord_stride, n, lane);
      acc = rcb_add<AK>(f, acc, T);
    }
  }
  return acc;
}

// Kernels 4 and 6, one thread a lane.
template <int K, int AK, int NPAIRS>
__global__ void __launch_bounds__(128)
windowed_mul_kernel(const CurveCtx<K> C, const Pairs<NPAIRS> pr, int nwin,
                    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                    uint32_t* __restrict__ oz, long long n) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  store_pt<K>(ox, oy, oz, n, lane,
              window_loop<AK>(ThreadField<K>(C), pr, nwin, n, lane));
}

// Kernels 4 and 6 where a group of TPI threads carries a lane
// (groupfield.cuh), in GroupShape<K>. The formulas are the same templates
// over GroupField, so the sequence of operations, and the result, is the
// one-thread loop's. A block of THREADS threads carries THREADS / TPI
// lanes; the threads past lane n - 1 (in the last block) repeat lane
// n - 1 and do not store, so that every warp's shuffles and votes see all
// 32 threads. Each thread of a group reads the digit itself (one address
// for the group) and its L limb rows of the entry: at one limb row the
// 32 / TPI lanes of a warp read adjacent words.
template <int K, int AK, int NPAIRS>
__global__ void __launch_bounds__(GroupShape<K>::kThreads,
                                  GroupShape<K>::kMinBlocks)
windowed_mul_group_kernel(const CurveCtx<K> C, const Pairs<NPAIRS> pr,
                          int nwin, uint32_t* __restrict__ ox,
                          uint32_t* __restrict__ oy,
                          uint32_t* __restrict__ oz, long long n) {
  using S = GroupShape<K>;
  using GF = GroupField<K, S::kTPI, S::kInline>;
  __shared__ uint32_t consts[GF::kSharedWords];
  GF::stage(consts, C);
  const GF f(consts, C.f.pinv);
  const long long g =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / S::kTPI;
  const long long lane = g < n ? g : n - 1;
  const PtOf<typename GF::E> acc = window_loop<AK>(f, pr, nwin, n, lane);
  if (g < n) {
    f.store(ox, n, lane, acc.x);
    f.store(oy, n, lane, acc.y);
    f.store(oz, n, lane, acc.z);
  }
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
// launch_for_a), one thread a lane; out: x, y, z.
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

// The same on the group loop, in GroupShape<K>.
template <int K, int NPAIRS, int... AKs>
int launch_wg(const CurveCtx<K>* C, const int32_t* const* digits, int nwin,
              const uint32_t* const* tables, uint32_t* const* out,
              long long n, void* stream) {
  using S = GroupShape<K>;
  const Pairs<NPAIRS> pr = pairs_of<NPAIRS>(digits, tables);
  const long long lanes = S::kThreads / S::kTPI;   // a block's lanes
  return launch_for_a<AKs...>(C->a_kind, n, [&](auto ak) {
    windowed_mul_group_kernel<K, decltype(ak)::value, NPAIRS>
        <<<(unsigned)((n + lanes - 1) / lanes), S::kThreads, 0,
           (cudaStream_t)stream>>>(*C, pr, nwin, out[0], out[1], out[2], n);
  });
}

// The Edwards window loop over a field type F (ThreadField over an
// EdCurveCtx, or GroupField): the accumulator starts at (0 : 1 : 1 : 0);
// per window w doublings, then one extended add of each pair's entry under
// its digit. Where products are calls (GroupField) the first w - 1
// doublings leave T untaken (ed_dbl's kT): a doubling reads X, Y and Z
// only, so only the last one before the adds needs it, and the products
// E*H of the others would be dead (on the H100 5.5% of kernel 7's time at
// K = 14). Where products are inlined (ThreadField) every doubling takes
// T: with a second doubling body, the one without T, the K = 8 kernels
// ran 15-21% slower on the H100 with fewer registers and no spill (most
// likely the loop's code outgrew the instruction cache).
// Returns the lane's accumulator (in F's elements).
template <int AK, int NPAIRS, class F, class E = typename F::E>
__device__ __forceinline__ ExtOf<E> ed_window_loop(const F& f,
                                                   const Pairs<NPAIRS>& pr,
                                                   int nwin, long long n,
                                                   long long lane) {
  ExtOf<E> acc;
  acc.x = f.zero();
  acc.y = f.one();
  acc.z = f.one();
  acc.t = f.zero();
  const long long coord_stride = (long long)F::kLimbs * n;  // a coordinate
  const long long entry_stride = 4 * coord_stride;          // an entry
  constexpr int kNoT = F::kInlineProducts ? 0 : kWindow - 1;
#pragma unroll 1
  for (int wi = 0; wi < nwin; ++wi) {
#pragma unroll 1
    for (int d = 0; d < kNoT; ++d)
      acc = ed_dbl<AK, false>(f, acc.x, acc.y, acc.z);
#pragma unroll 1
    for (int d = kNoT; d < kWindow; ++d)
      acc = ed_dbl<AK>(f, acc.x, acc.y, acc.z);
#pragma unroll 1
    for (int pi = 0; pi < NPAIRS; ++pi) {
      const int dig = pr.digits[pi][(long long)wi * n + lane] & (kEntries - 1);
      const uint32_t* e = pr.table[pi] + dig * entry_stride;
      ExtOf<E> T;
      T.x = f.load(e, n, lane);
      T.y = f.load(e + coord_stride, n, lane);
      T.z = f.load(e + 2 * coord_stride, n, lane);
      T.t = f.load(e + 3 * coord_stride, n, lane);
      acc = ed_add<AK>(f, acc, T);
    }
  }
  return acc;
}

// Kernels 7 and 6-ed, one thread a lane; out: x, y, z, t.
template <int K, int AK, int NPAIRS>
__global__ void __launch_bounds__(128)
windowed_mul_ed_kernel(const EdCurveCtx<K> C, const Pairs<NPAIRS> pr,
                       int nwin, uint32_t* __restrict__ ox,
                       uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                       uint32_t* __restrict__ ot, long long n) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const ThreadField<K, EdCurveCtx<K>> f(C);
  store_ext<K>(ox, oy, oz, ot, n, lane,
               ed_window_loop<AK>(f, pr, nwin, n, lane));
}

// Kernels 7 and 6-ed where a group of TPI threads carries a lane: as
// windowed_mul_group_kernel, with the Edwards loop and four coordinates.
template <int K, int AK, int NPAIRS>
__global__ void __launch_bounds__(GroupShape<K>::kThreads,
                                  GroupShape<K>::kMinBlocks)
windowed_mul_ed_group_kernel(const EdCurveCtx<K> C, const Pairs<NPAIRS> pr,
                             int nwin, uint32_t* __restrict__ ox,
                             uint32_t* __restrict__ oy,
                             uint32_t* __restrict__ oz,
                             uint32_t* __restrict__ ot, long long n) {
  using S = GroupShape<K>;
  using GF = GroupField<K, S::kTPI, S::kInline>;
  __shared__ uint32_t consts[GF::kSharedWords];
  GF::stage(consts, C);
  const GF f(consts, C.f.pinv);
  const long long g =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / S::kTPI;
  const long long lane = g < n ? g : n - 1;
  const ExtOf<typename GF::E> acc = ed_window_loop<AK>(f, pr, nwin, n, lane);
  if (g < n) {
    f.store(ox, n, lane, acc.x);
    f.store(oy, n, lane, acc.y);
    f.store(oz, n, lane, acc.z);
    f.store(ot, n, lane, acc.t);
  }
}

// Kernels 7 and 6-ed at K with the formula set AK and NPAIRS pairs, one
// thread a lane (launch_ed) or on the group loop in GroupShape<K>
// (launch_edg); out: x, y, z, t. A context of another a_kind returns
// cudaErrorInvalidValue and launches nothing.
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

template <int K, int AK, int NPAIRS>
int launch_edg(const EdCurveCtx<K>* C, const int32_t* const* digits,
               int nwin, const uint32_t* const* tables, uint32_t* const* out,
               long long n, void* stream) {
  using S = GroupShape<K>;
  if (C->a_kind != AK) return (int)cudaErrorInvalidValue;
  const long long lanes = S::kThreads / S::kTPI;   // a block's lanes
  if (n > 0)
    windowed_mul_ed_group_kernel<K, AK, NPAIRS>
        <<<(unsigned)((n + lanes - 1) / lanes), S::kThreads, 0,
           (cudaStream_t)stream>>>(*C, pairs_of<NPAIRS>(digits, tables),
                                   nwin, out[0], out[1], out[2], out[3], n);
  return (int)cudaGetLastError();
}

}  // namespace ecc

// The C entry point NAME of kernel 4 (NPAIRS = 1) or 6 (NPAIRS = 2) at K
// for the formula sets listed after NPAIRS (one, or all three at K = 8),
// one thread a lane. digits: NPAIRS pointers to int32[nwin][n] (MSW
// first); tables: NPAIRS pointers to uint32[16][3][K][n] (for kernel 6,
// P's then Q's); out: x, y, z (each uint32[K][n]). A context of another
// a_kind returns cudaErrorInvalidValue and launches nothing.
#define ECC_W_ENTRY_POINT(NAME, K, NPAIRS, ...)                            \
  int NAME(const ecc::CurveCtx<K>* C, const int32_t* const* digits,       \
           int nwin, const uint32_t* const* tables, uint32_t* const* out,  \
           long long n, void* stream) {                                    \
    return ecc::launch_w<K, NPAIRS, __VA_ARGS__>(C, digits, nwin, tables,  \
                                                 out, n, stream);          \
  }

// The same entry point built on the group loop.
#define ECC_WG_ENTRY_POINT(NAME, K, NPAIRS, ...)                           \
  int NAME(const ecc::CurveCtx<K>* C, const int32_t* const* digits,       \
           int nwin, const uint32_t* const* tables, uint32_t* const* out,  \
           long long n, void* stream) {                                    \
    return ecc::launch_wg<K, NPAIRS, __VA_ARGS__>(C, digits, nwin, tables, \
                                                  out, n, stream);         \
  }

// The C entry point NAME of kernel 7 (NPAIRS = 1) or 6-ed (NPAIRS = 2) for
// one (K, Edwards formula set AK), one thread a lane. digits: NPAIRS
// pointers to int32[nwin][n] (MSW first); tables: NPAIRS pointers to
// uint32[16][4][K][n] (for kernel 6-ed, P's then Q's); out: x, y, z, t
// (each uint32[K][n]). A context of another a_kind returns
// cudaErrorInvalidValue and launches nothing.
#define ECC_ED_ENTRY_POINT(NAME, K, NPAIRS, AK)                            \
  int NAME(const ecc::EdCurveCtx<K>* C, const int32_t* const* digits,     \
           int nwin, const uint32_t* const* tables, uint32_t* const* out,  \
           long long n, void* stream) {                                    \
    return ecc::launch_ed<K, AK, NPAIRS>(C, digits, nwin, tables, out, n,  \
                                         stream);                          \
  }

// The same entry point built on the group loop (6-ed at K = 8, both at
// K = 14).
#define ECC_EDG_ENTRY_POINT(NAME, K, NPAIRS, AK)                           \
  int NAME(const ecc::EdCurveCtx<K>* C, const int32_t* const* digits,     \
           int nwin, const uint32_t* const* tables, uint32_t* const* out,  \
           long long n, void* stream) {                                    \
    return ecc::launch_edg<K, AK, NPAIRS>(C, digits, nwin, tables, out, n, \
                                          stream);                         \
  }

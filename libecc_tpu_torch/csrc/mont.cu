// Kernel 1: batched Montgomery multiply and square, built for K = 6
// (192-bit moduli: P-192, the 192-bit Brainpool, SM2 and Koblitz curves),
// K = 7 (224-bit: P-224, BrainpoolP224r1/t1, secp224k1's p), K = 8
// (256-bit moduli), K = 10 (320-bit: BrainpoolP320r1/t1), K = 12 (384-bit:
// P-384, BrainpoolP384r1/t1), K = 14 (448-bit: Ed448's p and q), K = 16
// (512-bit: BrainpoolP512r1/t1, GOST512 and the other 512-bit curves) and
// K = 17 (521-bit: P-521's p = 2^521 - 1 and q).
//
// Replaces the TPU kernel libecc_tpu/ops/pallas/mont.py:_build -> call
// (pallas_call at :297; public mont_mul_relaxed :323, mont_sqr_relaxed
// :328; body _mont_body_refs :115). The K = 14 instance also stands for
// libecc_tpu/ops/pallas/rows.py:RowOps (:129; mul, sqr, _redc), the O(K)
// body those TPU kernels switch to when K > 30 (Ed448 is K = 32 limbs of
// 15 bits there, the 512-bit curves K = 37), and so does the K = 16
// instance, and the K = 17 one (P-521 is K = 37 there): on Hopper a 448-,
// 512- or 521-bit product is the same template at K = 14, 16 or 17, not a
// code path of its own. P-384 (K = 28 in JAX) runs the tile backend
// there; here it is the template at K = 12. K = 7 and K = 17 are the odd
// limb counts: nothing here pairs limbs, the squaring's cross terms run
// over i < j whatever K is, and P-521's p' = -p^-1 mod 2^32 is 1 (p is
// 2^521 - 1), R = 2^544. secp224k1's q has 225 bits: its scalars run the
// K = 8 instance beside the K = 7 one of its p.
//
// Bound on the H100: integer-multiply issue and memory are close. One
// product is 2K^2 + K 32-bit multiplies (K^2 + K(K+1)/2 + K for the
// square; a 32x32->64 product takes two multiply-add issue slots) against
// 3 x 4K bytes per lane: ~264 slots for 96 bytes at K = 8, about half the
// card's slot-to-byte ratio, so the multiplies alone leave it bound by
// bytes, while the carries and adds around them (as many instructions
// again) bring it to the issue limit. chip_smoke.py reports which bound
// its count gives. Kernels 2-4 keep the operands of many products in
// registers and are bound by issue.
// Design: one thread per lane, both operands and the 2K-word product in
// registers, fully unrolled at compile time (K is a template parameter),
// loads and stores limb-major so a warp's accesses to one limb coalesce.
// The ragged edge is masked; N need not be a multiple of the block size.
#include "field.cuh"

namespace ecc {

template <int K>
__global__ void __launch_bounds__(256)
mont_mul_kernel(const FieldCtx<K> f, const uint32_t* __restrict__ a,
                const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                long long n) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const Fe<K> x = load_fe<K>(a, n, lane);
  const Fe<K> y = load_fe<K>(b, n, lane);
  store_fe<K>(out, n, lane, fmul<K>(x, y, f));
}

template <int K>
__global__ void __launch_bounds__(256)
mont_sqr_kernel(const FieldCtx<K> f, const uint32_t* __restrict__ a,
                uint32_t* __restrict__ out, long long n) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  store_fe<K>(out, n, lane, fsqr<K>(load_fe<K>(a, n, lane), f));
}

constexpr int kThreads = 256;

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <int K>
int launch_mul(const FieldCtx<K>* f, const uint32_t* a, const uint32_t* b,
               uint32_t* out, long long n, void* stream) {
  if (n > 0)
    mont_mul_kernel<K><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        *f, a, b, out, n);
  return (int)cudaGetLastError();
}

template <int K>
int launch_sqr(const FieldCtx<K>* f, const uint32_t* a, uint32_t* out,
               long long n, void* stream) {
  if (n > 0)
    mont_sqr_kernel<K><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        *f, a, out, n);
  return (int)cudaGetLastError();
}

}  // namespace ecc

// One pair of entry points per limb count: K = 6 (192-bit moduli), K = 7
// (224-bit), K = 8 (256-bit), K = 10 (320-bit), K = 12 (384-bit), K = 14
// (448-bit, Ed448's p and q), K = 16 (512-bit) and K = 17 (521-bit,
// P-521).
extern "C" {

#define ECC_MONT_ENTRY_POINTS(K)                                           \
  int mont_mul_k##K(const ecc::FieldCtx<K>* f, const uint32_t* a,         \
                    const uint32_t* b, uint32_t* out, long long n,        \
                    void* stream) {                                        \
    return ecc::launch_mul<K>(f, a, b, out, n, stream);                    \
  }                                                                        \
  int mont_sqr_k##K(const ecc::FieldCtx<K>* f, const uint32_t* a,         \
                    uint32_t* out, long long n, void* stream) {            \
    return ecc::launch_sqr<K>(f, a, out, n, stream);                       \
  }

ECC_MONT_ENTRY_POINTS(6)
ECC_MONT_ENTRY_POINTS(7)
ECC_MONT_ENTRY_POINTS(8)
ECC_MONT_ENTRY_POINTS(10)
ECC_MONT_ENTRY_POINTS(12)
ECC_MONT_ENTRY_POINTS(14)
ECC_MONT_ENTRY_POINTS(16)
ECC_MONT_ENTRY_POINTS(17)

}  // extern "C"

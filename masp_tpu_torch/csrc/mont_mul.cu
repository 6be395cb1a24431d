// Batched Montgomery product a * b * R^-1 mod N for Fr (L = 16) and Fq (L = 24).
//
// Replaces the Pallas kernel _mont_mul_kernel (masp_tpu/kernels/field_kernels.py,
// called through pallas_mont_mul / klay_mont_mul). Operands and the result are
// (n, L) int32 rows of 16-bit limbs in Montgomery form, the layout of the
// port's tensors; the plain PyTorch version is mont_mul_plain in
// kernels/mont_mul.py.
//
// Bound: integer multiply-add throughput. Each product is 2 W^2 + W 32x32->64
// multiply-adds (W = 8 or 12 words) on 2L * 4 + L * 4 bytes of traffic, ~30 to
// 45 multiply-adds per byte. One thread per element keeps the whole CIOS
// accumulator in registers (no shared memory, no cross-thread carries): the
// elements are independent, and a warp of 32 elements keeps the multipliers
// busy without any synchronisation.

#include "field.cuh"

template <class F>
__global__ void __launch_bounds__(128)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  constexpr int L = 2 * F::W;
  Fe<F> x, y, r;
  load(x, a + i * L);
  load(y, b + i * L);
  fe_mul(r, x, y);
  store(out + i * L, r);
}

template <class F>
static int launch(const int32_t* a, const int32_t* b, int32_t* out, long long n, void* stream) {
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  mont_mul_kernel<F><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}

extern "C" int masp_mont_mul_fr(const int32_t* a, const int32_t* b, int32_t* out,
                                long long n, void* stream) {
  return launch<Fr>(a, b, out, n, stream);
}

extern "C" int masp_mont_mul_fq(const int32_t* a, const int32_t* b, int32_t* out,
                                long long n, void* stream) {
  return launch<Fq>(a, b, out, n, stream);
}

// Batched Montgomery product a * b * R^-1 mod N for Fr (L = 16) and Fq (L = 24),
// and the Fermat inversion a^(N-2) as one launch (mont_inv_kernel, below).
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

// --- Fermat inversion: out = a^(N-2), one launch per chain ----------------------
//
// Replaces the chain of _mont_mul_kernel launches that
// masp_tpu/ops/field_jax.py:233 mont_inv_small runs (one lax.scan over the
// Pallas product), for Fq and for Fr: in Fq the root inverse of every
// batch-affine ladder level and of every batched inversion (the fetch's
// to_affine). The plain version is mont_inv_plain in kernels/mont_mul.py,
// the same 4-bit fixed-window chain over the plain product: table a^0 ..
// a^15 (14 products), then for each lower nibble of N - 2 four squarings and
// one table product: 14 + 95 x 5 = 489 products for Fq, 14 + 63 x 5 = 329
// for Fr. The inverse is unique and fe_mul fully reduces, so the limbs equal
// the chain's whatever order it runs in; 0 maps to 0.
//
// Bound: latency. The chain is dependent products; on the proof path it
// runs on one or two rows, so one thread walks it with the accumulator in
// registers, the table in shared memory (one 16-entry table per row, words
// lane-minor so a warp's table reads hit 32 banks) and the exponent's nibbles
// in constant memory (every lane reads the same nibble: a broadcast). Its cost
// is the chain's (2 W^2 + W) multiply-adds a product on one thread instead
// of one launch per product from the host.

// q - 2 and r - 2 in base 16, most significant nibble first
static __constant__ uint8_t FQ_INV_NIBBLES[96] = {
    1, 10, 0, 1, 1, 1, 14, 10, 3, 9, 7, 15, 14, 6, 9, 10, 4, 11, 1, 11, 10, 7, 11, 6,
    4, 3, 4, 11, 10, 12, 13, 7, 6, 4, 7, 7, 4, 11, 8, 4, 15, 3, 8, 5, 1, 2, 11, 15,
    6, 7, 3, 0, 13, 2, 10, 0, 15, 6, 11, 0, 15, 6, 2, 4, 1, 14, 10, 11, 15, 15, 15, 14,
    11, 1, 5, 3, 15, 15, 15, 15, 11, 9, 15, 14, 15, 15, 15, 15, 15, 15, 15, 15, 10, 10, 10, 9,
};
static __constant__ uint8_t FR_INV_NIBBLES[64] = {
    7, 3, 14, 13, 10, 7, 5, 3, 2, 9, 9, 13, 7, 13, 4, 8, 3, 3, 3, 9, 13, 8, 0, 8,
    0, 9, 10, 1, 13, 8, 0, 5, 5, 3, 11, 13, 10, 4, 0, 2, 15, 15, 15, 14, 5, 11, 15, 14,
    15, 15, 15, 15, 15, 15, 15, 14, 15, 15, 15, 15, 15, 15, 15, 15,
};

template <class F>
struct InvExp;
template <>
struct InvExp<Fq> {
  static constexpr int NIBBLES = 96;
  __device__ __forceinline__ static int nib(int r) { return FQ_INV_NIBBLES[r]; }
};
template <>
struct InvExp<Fr> {
  static constexpr int NIBBLES = 64;
  __device__ __forceinline__ static int nib(int r) { return FR_INV_NIBBLES[r]; }
};

constexpr int INV_THREADS = 32;

template <class F>
__global__ void __launch_bounds__(INV_THREADS)
mont_inv_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out, long long n) {
  constexpr int W = F::W;
  __shared__ uint32_t table[16][W][INV_THREADS];
  const int lane = threadIdx.x;
  const long long i = (long long)blockIdx.x * INV_THREADS + lane;
  Fe<F> x, p;
  if (i < n) {
    load(x, a + i * (2 * W));
  } else {
#pragma unroll
    for (int j = 0; j < W; j++) x.w[j] = 0;
  }
#pragma unroll
  for (int j = 0; j < W; j++) {
    table[0][j][lane] = F::one(j);
    table[1][j][lane] = x.w[j];
  }
  p = x;
  for (int k = 2; k < 16; k++) {
    fe_mul(p, p, x);
#pragma unroll
    for (int j = 0; j < W; j++) table[k][j][lane] = p.w[j];
  }
  Fe<F> acc, t;
  const int top = InvExp<F>::nib(0);
#pragma unroll
  for (int j = 0; j < W; j++) acc.w[j] = table[top][j][lane];
  for (int r = 1; r < InvExp<F>::NIBBLES; r++) {
#pragma unroll
    for (int s = 0; s < 4; s++) fe_mul(acc, acc, acc);
    const int nib = InvExp<F>::nib(r);
#pragma unroll
    for (int j = 0; j < W; j++) t.w[j] = table[nib][j][lane];
    fe_mul(acc, acc, t);
  }
  if (i < n) store(out + i * (2 * W), acc);
}

template <class F>
static int launch_inv(const int32_t* a, int32_t* out, long long n, void* stream) {
  const long long blocks = (n + INV_THREADS - 1) / INV_THREADS;
  mont_inv_kernel<F><<<(unsigned)blocks, INV_THREADS, 0, (cudaStream_t)stream>>>(a, out, n);
  return (int)cudaGetLastError();
}

extern "C" int masp_mont_inv_fr(const int32_t* a, int32_t* out, long long n, void* stream) {
  return launch_inv<Fr>(a, out, n, stream);
}

extern "C" int masp_mont_inv_fq(const int32_t* a, int32_t* out, long long n, void* stream) {
  return launch_inv<Fq>(a, out, n, stream);
}

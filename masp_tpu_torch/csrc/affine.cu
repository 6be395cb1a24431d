// One batch-affine ladder level on BLS12-381 G1, the elementwise halves
// around the batched inversion. Replaces the Pallas kernels
// _affine_pre_kernel and _affine_post_kernel
// (masp_tpu/kernels/field_kernels.py, behind _affine_pre_callable and
// _affine_post_callable); kernels/affine.py runs the product-tree inversion
// between them through the Fq mont_mul kernel, as klay_affine_level does.
//
// An affine node is a row of 2K + 1 = 49 int32: [x | y | f], x and y as 24
// 16-bit Montgomery limbs (canonical, < q), f != 0 marking the identity.
// Operand rows may be strided (the ladder pairs even and odd rows of one
// tensor in place); output rows are contiguous. The plain PyTorch versions
// are affine_pre_plain and affine_post_plain in kernels/affine.py.
//
// affine_pre: the case masks, the slope numerator n (3 x1^2 when doubling,
// else y2 - y1) and denominator d (2 y1 or x2 - x1, and 1 on every lane that
// adds nothing, so that the product tree stays invertible), and a case code
// (bit 0: P1 is the identity, bit 1: P2 is, bit 2: P1 + P2 is, as P + (-P)).
// affine_post: lam = n / d from d's inverse, x3 = lam^2 - x1 - x2,
// y3 = lam (x1 - x3) - y1, the identity pass-throughs, and identity results
// normalised to (0, mont-1) with flag 1.
//
// Bound: bytes. Per lane pre reads 2 x 49 and writes 49 words (588 B) for
// one Fq product (600 multiply-adds); post reads 4 x 24 + 2 x 49 + 1 words
// and writes 49 (784 B) for three products. At 3.35 TB/s and ~1.7e13
// multiply-adds/s that is ~5x more time in bytes than in arithmetic. The
// lanes are independent, so one thread per lane holds its operands and the
// formula in registers and no intermediate touches device memory: each
// kernel moves only its inputs and outputs once.

#include "field.cuh"

using FqE = Fe<Fq>;

constexpr int K = 24;        // limbs per coordinate
constexpr int ROW = 2 * K + 1;  // [x | y | f]

__device__ __forceinline__ bool fe_eq(const FqE& a, const FqE& b) {
  uint32_t diff = 0;
#pragma unroll
  for (int j = 0; j < Fq::W; j++) diff |= a.w[j] ^ b.w[j];
  return diff == 0;
}

__device__ __forceinline__ void fe_sel(FqE& r, bool m, const FqE& a, const FqE& b) {
#pragma unroll
  for (int j = 0; j < Fq::W; j++) r.w[j] = m ? a.w[j] : b.w[j];
}

__device__ __forceinline__ void fe_const(FqE& r, const uint32_t* c) {
#pragma unroll
  for (int j = 0; j < Fq::W; j++) r.w[j] = c[j];
}

__global__ void __launch_bounds__(128)
affine_pre_kernel(const int32_t* __restrict__ p1, long long s1,
                  const int32_t* __restrict__ p2, long long s2,
                  int32_t* __restrict__ n_out, int32_t* __restrict__ d_out,
                  int32_t* __restrict__ code_out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t* a = p1 + i * s1;
  const int32_t* b = p2 + i * s2;
  FqE x1, y1, x2, y2;
  load(x1, a);
  load(y1, a + K);
  load(x2, b);
  load(y2, b + K);
  const bool i1 = a[2 * K] != 0;
  const bool i2 = b[2 * K] != 0;

  const bool fin = !i1 && !i2;
  const bool xeq = fe_eq(x1, x2);
  FqE zero, t, u;
#pragma unroll
  for (int j = 0; j < Fq::W; j++) zero.w[j] = 0u;
  fe_sub(t, zero, y2);  // -y2 mod q
  const bool yneg = fe_eq(y1, t);
  const bool res_inf = fin && xeq && yneg;
  const bool use_dbl = fin && xeq && !yneg;
  const bool live = fin && !res_inf;

  // n = use_dbl ? 3 x1^2 : y2 - y1
  fe_mul(t, x1, x1);
  fe_add(u, t, t);
  fe_add(u, u, t);
  fe_sub(t, y2, y1);
  fe_sel(u, use_dbl, u, t);
  store(n_out + i * K, u);
  // d = live ? (use_dbl ? 2 y1 : x2 - x1) : mont-1
  fe_add(t, y1, y1);
  fe_sub(u, x2, x1);
  fe_sel(t, use_dbl, t, u);
  fe_const(u, FQ_ONE);
  fe_sel(t, live, t, u);
  store(d_out + i * K, t);
  code_out[i] = (int32_t)((i1 ? 1u : 0u) | (i2 ? 2u : 0u) | (res_inf ? 4u : 0u));
}

__global__ void __launch_bounds__(128)
affine_post_kernel(const int32_t* __restrict__ nr, const int32_t* __restrict__ ivr,
                   const int32_t* __restrict__ p1, long long s1,
                   const int32_t* __restrict__ p2, long long s2,
                   const int32_t* __restrict__ code, int32_t* __restrict__ out,
                   long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t* a = p1 + i * s1;
  const int32_t* b = p2 + i * s2;
  FqE num, iv, x1, y1, x2, y2, lam, x3, y3, t;
  load(num, nr + i * K);
  load(iv, ivr + i * K);
  load(x1, a);
  load(y1, a + K);
  load(x2, b);
  load(y2, b + K);
  const uint32_t c = (uint32_t)code[i];
  const bool i1 = (c & 1u) != 0;
  const bool i2 = (c & 2u) != 0;
  const bool res_inf = (c & 4u) != 0;

  fe_mul(lam, num, iv);
  fe_mul(t, lam, lam);
  fe_sub(x3, t, x1);
  fe_sub(x3, x3, x2);
  fe_sub(t, x1, x3);
  fe_mul(y3, lam, t);
  fe_sub(y3, y3, y1);

  // i1 ? P2 : (i2 ? P1 : P3), then identity results -> (0, mont-1)
  fe_sel(x3, i2, x1, x3);
  fe_sel(x3, i1, x2, x3);
  fe_sel(y3, i2, y1, y3);
  fe_sel(y3, i1, y2, y3);
  const bool fo = (i1 && i2) || res_inf;
#pragma unroll
  for (int j = 0; j < Fq::W; j++) {
    x3.w[j] = fo ? 0u : x3.w[j];
    y3.w[j] = fo ? FQ_ONE[j] : y3.w[j];
  }
  int32_t* o = out + i * ROW;
  store(o, x3);
  store(o + K, y3);
  o[2 * K] = fo ? 1 : 0;
}

static long long blocks_for(long long n, int threads) { return (n + threads - 1) / threads; }

extern "C" int masp_affine_pre(const int32_t* p1, long long s1, const int32_t* p2, long long s2,
                               int32_t* n_out, int32_t* d_out, int32_t* code_out, long long n,
                               void* stream) {
  const int threads = 128;
  affine_pre_kernel<<<(unsigned)blocks_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
      p1, s1, p2, s2, n_out, d_out, code_out, n);
  return (int)cudaGetLastError();
}

extern "C" int masp_affine_post(const int32_t* nr, const int32_t* ivr, const int32_t* p1,
                                long long s1, const int32_t* p2, long long s2,
                                const int32_t* code, int32_t* out, long long n, void* stream) {
  const int threads = 128;
  affine_post_kernel<<<(unsigned)blocks_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
      nr, ivr, p1, s1, p2, s2, code, out, n);
  return (int)cudaGetLastError();
}

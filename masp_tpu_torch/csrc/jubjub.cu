// Jubjub over Fr (the BLS12-381 scalar field): the complete Edwards add, the
// Pedersen fold and the constant-time square root, one thread per output row.
//
// None of the three replaces a Pallas body: the JAX package composes each
// from its Fr Montgomery product (masp_tpu/kernels/field_kernels.py:350
// through pallas_mont_mul :648) inside an XLA program. Composed from the
// port's product kernel, one Edwards add would be about 60 launches, a
// Jubjub MSM of 1,024 points some 48k, so each program is one kernel here:
//
//   jubjub_add_kernel     masp_tpu/ops/jubjub_jax.py:104 JubjubOps.add_points
//   fr_sqrt_kernel        masp_tpu/ops/jubjub_jax.py:220 batch_sqrt (its lax.scan)
//   pedersen_fold_kernel  masp_tpu/ops/pedersen_jax.py:77 _reduce_fn (its fori_loop)
//
// Points are packed rows of 48 int32 16-bit limbs, X | Y | Z in projective
// twisted-Edwards coordinates (a = -1), Montgomery form over Fr, the layout
// of the port's tensors. The arithmetic is field.cuh's fe_mul / fe_add /
// fe_sub over Fe<Fr>, every result fully reduced, so each kernel gives the
// limbs of its plain version in kernels/jubjub.py (and of the JAX programs):
// any evaluation order of one formula over canonical elements does.
//
// Bounds (12 Fr products an add, 2 (2 W^2 + W) = 272 32-bit multiply-adds a
// product at W = 8): an add moves 3 x 192 B against 3,264 multiply-adds,
// about 5.7 a byte, near the card's ratio (1.67e13 IMAD/s over 3.35e12 B/s);
// the fold reads one index and one cached table row a step and writes one
// row a hash, so it is bound by operations; the square root reads and
// writes one row for about a thousand dependent products: operations. So
// each thread keeps its point or its Tonelli-Shanks state in registers for
// the whole walk, loads its rows limb by limb and takes its constants (d,
// the root of unity, the exponent's bits) from device memory that every
// thread of a warp reads at once. A simple kernel first: no staging.

#include "field.cuh"

using FrE = Fe<Fr>;

constexpr int JUB_THREADS = 128;
constexpr int PT = 48;  // int32 limbs a packed point: X | Y | Z

__device__ __forceinline__ bool fr_eq(const FrE& a, const FrE& b) {
  uint32_t diff = 0;
#pragma unroll
  for (int j = 0; j < Fr::W; j++) diff |= a.w[j] ^ b.w[j];
  return diff == 0;
}

// r = m ? a : b
__device__ __forceinline__ void fr_sel(FrE& r, bool m, const FrE& a, const FrE& b) {
#pragma unroll
  for (int j = 0; j < Fr::W; j++) r.w[j] = m ? a.w[j] : b.w[j];
}

__device__ __forceinline__ void fr_one(FrE& r) {
#pragma unroll
  for (int j = 0; j < Fr::W; j++) r.w[j] = Fr::one(j);
}

struct EdPoint {
  FrE X, Y, Z;
};

__device__ __forceinline__ void load_point(EdPoint& p, const int32_t* __restrict__ row) {
  load(p.X, row);
  load(p.Y, row + 16);
  load(p.Z, row + 32);
}

__device__ __forceinline__ void store_point(int32_t* __restrict__ row, const EdPoint& p) {
  store(row, p.X);
  store(row + 16, p.Y);
  store(row + 32, p.Z);
}

// add-2008-bbjlp with a = -1, complete on Jubjub (jubjub_jax.py:109-119):
// A = Z1 Z2, B = A^2, C = X1 X2, D = Y1 Y2, E = d C D, F = B - E, G = B + E,
// H = (X1 + Y1)(X2 + Y2) - (C + D), X3 = A F H, Y3 = A G (D + C), Z3 = F G.
// r may alias p or q.
__device__ __forceinline__ void edwards_add(EdPoint& r, const EdPoint& p, const EdPoint& q, const FrE& d) {
  FrE A, B, C, D, E, F, G, H, s, t;
  fe_mul(A, p.Z, q.Z);
  fe_mul(B, A, A);
  fe_mul(C, p.X, q.X);
  fe_mul(D, p.Y, q.Y);
  fe_add(s, p.X, p.Y);
  fe_add(t, q.X, q.Y);
  fe_mul(H, s, t);
  fe_mul(t, C, D);
  fe_mul(E, d, t);
  fe_sub(F, B, E);
  fe_add(G, B, E);
  fe_add(s, D, C);
  fe_sub(H, H, s);
  fe_mul(t, A, F);
  fe_mul(r.X, t, H);
  fe_mul(t, A, G);
  fe_mul(r.Y, t, s);
  fe_mul(r.Z, F, G);
}

// out[i] = p[i] + q[i]; row i of p starts at p + i * sp (int32), of q at
// q + i * sq; out is contiguous
__global__ void __launch_bounds__(JUB_THREADS)
jubjub_add_kernel(const int32_t* __restrict__ p, long long sp, const int32_t* __restrict__ q, long long sq,
                  int32_t* __restrict__ out, long long n, const int32_t* __restrict__ dconst) {
  const long long i = (long long)blockIdx.x * JUB_THREADS + threadIdx.x;
  if (i >= n) return;
  FrE d;
  load(d, dconst);
  EdPoint a, b;
  load_point(a, p + i * sp);
  load_point(b, q + i * sq);
  edwards_add(a, a, b, d);
  store_point(out + i * PT, a);
}

// out[n] = sum over c = 0 .. C-1, in that order, of table[c][idx[c][n]],
// from the identity (0 : 1 : 1): the serial fold of pedersen_jax.py:96-100,
// so the projective limbs are the JAX fori_loop's. table: (C, 9, 48) rows,
// the chunk's nine digit multiples; idx: (C, N) digit + 4, in 0 .. 8.
__global__ void __launch_bounds__(JUB_THREADS)
pedersen_fold_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ idx,
                     int32_t* __restrict__ out, long long C, long long N, const int32_t* __restrict__ dconst) {
  const long long i = (long long)blockIdx.x * JUB_THREADS + threadIdx.x;
  if (i >= N) return;
  FrE d;
  load(d, dconst);
  EdPoint acc, step;
#pragma unroll
  for (int j = 0; j < Fr::W; j++) acc.X.w[j] = 0u;
  fr_one(acc.Y);
  fr_one(acc.Z);
  for (long long c = 0; c < C; c++) {
    const int k = __ldg(idx + c * N + i);
    load_point(step, table + (c * 9 + k) * PT);
    edwards_add(acc, acc, step, d);
  }
  store_point(out + i * PT, acc);
}

// The ff crate's constant-time Tonelli-Shanks (sqrt_tonelli_shanks) over
// Fr, with 2^S | r - 1: w = a^((t - 1) / 2) from the exponent's bits (most
// significant first, from the identity, one squaring a bit and a product
// where the bit is set, as field_jax.mont_pow_fixed walks them), x = a w,
// b = x w, z = the 2^S-th root of unity, then for max_v = S .. 1 the inner
// steps j = 2 .. max_v - 1 and one boundary step: the step stream of
// jubjub_jax.py:203-217, every branch a select. ok = (x^2 == a); the root
// is some square root of a where one exists, 0 for 0.
__global__ void __launch_bounds__(JUB_THREADS)
fr_sqrt_kernel(const int32_t* __restrict__ a_in, int32_t* __restrict__ root, int32_t* __restrict__ ok,
               long long n, const int32_t* __restrict__ zconst, const int32_t* __restrict__ bits, int nbits,
               int S) {
  const long long i = (long long)blockIdx.x * JUB_THREADS + threadIdx.x;
  if (i >= n) return;
  FrE a, one, w, x, b, z, tmp, sq, t;
  load(a, a_in + i * 16);
  fr_one(one);
  w = one;
  for (int e = 0; e < nbits; e++) {
    fe_mul(w, w, w);
    if (__ldg(bits + e)) fe_mul(w, w, a);
  }
  fe_mul(x, a, w);
  fe_mul(b, x, w);
  load(z, zconst);
  int v = S, k = 1;
  bool jltv = true;
  fe_mul(tmp, b, b);
  for (int max_v = S; max_v >= 1; max_v--) {
    for (int j = 2; j < max_v; j++) {
      // inner step
      const bool tmp_is_one = fr_eq(tmp, one);
      fr_sel(t, tmp_is_one, z, tmp);
      fe_mul(sq, t, t);
      const bool jltv_i = jltv && j != v;
      k = tmp_is_one ? k : j;
      // new_z = tmp_is_one ? sq : z, kept where jltv_i
      fr_sel(z, jltv_i && tmp_is_one, sq, z);
      fr_sel(tmp, tmp_is_one, tmp, sq);
      jltv = jltv_i;
    }
    // boundary step: x, z, b, v, then the next run's k, tmp, jltv
    const bool b_is_one = fr_eq(b, one);
    fe_mul(t, x, z);
    fr_sel(x, b_is_one, x, t);
    fe_mul(z, z, z);
    fe_mul(b, b, z);
    v = k;
    k = 1;
    fe_mul(tmp, b, b);
    jltv = true;
  }
  fe_mul(sq, x, x);
  store(root + i * 16, x);
  ok[i] = fr_eq(sq, a) ? 1 : 0;
}

static int check_launch(long long n) {
  return n <= 0 || n >= (1ll << 31) ? (int)cudaErrorInvalidValue : 0;
}

static unsigned blocks_for(long long n) { return (unsigned)((n + JUB_THREADS - 1) / JUB_THREADS); }

// p, q: n packed rows at row strides sp, sq (int32); out: n contiguous rows;
// d: the Montgomery limbs of the curve's d
extern "C" int masp_jubjub_add(const int32_t* p, long long sp, const int32_t* q, long long sq, int32_t* out,
                               long long n, const int32_t* d, void* stream) {
  if (int err = check_launch(n)) return err;
  jubjub_add_kernel<<<blocks_for(n), JUB_THREADS, 0, (cudaStream_t)stream>>>(p, sp, q, sq, out, n, d);
  return (int)cudaGetLastError();
}

// table: (C, 9, 48) contiguous; idx: (C, N) contiguous; out: (N, 48)
extern "C" int masp_pedersen_fold(const int32_t* table, const int32_t* idx, int32_t* out, long long C, long long N,
                                  const int32_t* d, void* stream) {
  if (int err = check_launch(N)) return err;
  if (C < 0) return (int)cudaErrorInvalidValue;
  pedersen_fold_kernel<<<blocks_for(N), JUB_THREADS, 0, (cudaStream_t)stream>>>(table, idx, out, C, N, d);
  return (int)cudaGetLastError();
}

// a, root: n contiguous rows of 16 limbs; ok: n int32; z: the root of
// unity's 16 limbs; bits: nbits int32 0/1, most significant first; S: the
// 2-adicity of r - 1
extern "C" int masp_fr_sqrt(const int32_t* a, int32_t* root, int32_t* ok, long long n, const int32_t* z,
                            const int32_t* bits, int nbits, int S, void* stream) {
  if (int err = check_launch(n)) return err;
  fr_sqrt_kernel<<<blocks_for(n), JUB_THREADS, 0, (cudaStream_t)stream>>>(a, root, ok, n, z, bits, nbits, S);
  return (int)cudaGetLastError();
}

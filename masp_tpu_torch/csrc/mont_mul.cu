// Batched Montgomery product a * b * R^-1 mod N for Fr (L = 16) and Fq (L = 24),
// and the inversion, a divstep GCD with one thread a row (mont_inv_kernel, below).
//
// mont_mul_kernel<F> replaces the Pallas kernel _mont_mul_kernel
// (masp_tpu/kernels/field_kernels.py:350, its pallas_call at :636, reached
// through pallas_mont_mul :648 and klay_mont_mul :580). Operands and the
// result are rows of L int32 16-bit limbs in Montgomery form, the layout of
// the port's tensors; the plain PyTorch version is mont_mul_plain in
// kernels/mont_mul.py. The arithmetic is fe_mul (field.cuh: CIOS over W = 8
// or 12 32-bit words, fully reduced), so the limbs equal the plain version's.
//
// Bound: bytes. A product moves 3 rows of L int32 (Fr 3 x 64 B against
// 2(2 W^2 + W) = 272 32-bit multiply-adds, Fq 3 x 96 B against 600), about
// 1.4 and 2.1 multiply-adds a byte where the card does about 5 (1.67e13
// IMAD/s over 3.35e12 B/s). Measured (PERF.md): with one thread a row
// loading its row limb by limb, each warp load touched 32 rows at a 64- or
// 96-byte stride, and the kernel ran at 26% (Fr) and 17% (Fq) of its byte
// bound; the main path also copied every broadcast or strided operand to a
// contiguous tensor before each launch. So each warp of a 128-thread block,
// one product a lane, stages its 32 rows of both operands in shared memory
// with 16-byte loads on consecutive chunks (packed to 32-bit words, an odd
// row stride in words so that the lanes' row reads hit 32 banks: field.cuh's
// staging helpers, which mont_mul_mxu.cu shares), multiplies
// from registers, and writes the result back through shared memory with
// 16-byte stores on consecutive chunks; it waits for itself only. Each
// operand is read where it lies, through a two-level row map: row i starts
// (i / inner) * s_outer + (i % inner) * s_inner int32 from its base. That
// covers an NTT stage's odd half (a strided view), its twiddles (broadcast,
// s_outer = 0), powers broadcast over the transforms and a scalar (both
// strides 0), without a copy. Measured after the change (PERF.md): Fr at
// 3 x 2^17 rows at about 75% of its byte bound, launches of about one wave
// (an NTT stage's 3 x 2^16 products) at about 50%: suspected, not measured,
// that there every warp loads, multiplies and stores at about the same time
// as the others, so the phases do not overlap.

#include "field.cuh"

// one operand: row i starts at base + (i / inner) * s_outer + (i % inner) * s_inner
struct RowMap {
  const int32_t* base;
  long long inner, s_outer, s_inner;
};

template <class F>
struct MontRows : Staging<F> {
  static constexpr int ROWS = 128;  // products a block, one a thread
};

// row i's int32 offset from the map's base; i < 2^31 and inner <= n
__device__ __forceinline__ long long row_offset(const RowMap& m, long long i) {
  const unsigned inner = (unsigned)m.inner;
  const unsigned q = (unsigned)i / inner, r = (unsigned)i - q * inner;
  return (long long)q * m.s_outer + (long long)r * m.s_inner;
}

// Each warp stages, multiplies and writes its own 32 rows, so it waits for
// itself only (__syncwarp; no block barrier). vec: bit 0 (a) and bit 1 (b)
// set where that operand's base and strides are 16-byte aligned, so that
// its chunks load as int4.
template <class F>
__global__ void __launch_bounds__(MontRows<F>::ROWS)
mont_mul_kernel(RowMap a, RowMap b, int32_t* __restrict__ out, long long n, int vec) {
  using M = MontRows<F>;
  __shared__ uint32_t smem[M::ROWS / 32][2 * M::AREA];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long first = (long long)blockIdx.x * M::ROWS + 32 * warp;  // the warp's first row
  const long long live = n - first;  // rows of the warp below n (may exceed 32)
  if (live <= 0) return;
  uint32_t* A = smem[warp];
  uint32_t* B = A + M::AREA;

  // each lane maps its own row; rows past n read row 0 and stage as 0
  {
    const long long i = lane < live ? first + lane : 0;
    const long long oa = row_offset(a, i), ob = row_offset(b, i);
    int4 va[M::CHUNKS], vb[M::CHUNKS];
    if (vec & 1) load_chunks<F, true>(va, a.base, oa, lane);
    else load_chunks<F, false>(va, a.base, oa, lane);
    if (vec & 2) load_chunks<F, true>(vb, b.base, ob, lane);
    else load_chunks<F, false>(vb, b.base, ob, lane);
    stage_chunks<F>(A, va, live, lane);
    stage_chunks<F>(B, vb, live, lane);
  }
  __syncwarp();

  // one product a lane; the result replaces its own row of a's area
  {
    uint32_t* ra = A + lane * M::STRIDE;
    const uint32_t* rb = B + lane * M::STRIDE;
    Fe<F> x, y, r;
#pragma unroll
    for (int j = 0; j < M::W; j++) {
      x.w[j] = ra[j];
      y.w[j] = rb[j];
    }
    fe_mul(r, x, y);
#pragma unroll
    for (int j = 0; j < M::W; j++) ra[j] = r.w[j];
  }
  __syncwarp();

  store_chunks<F>(out + first * M::L, A, live, lane);
}

// 16-byte loads need a 16-byte aligned base and strides that are multiples of 4 int32
static int aligned(const RowMap& m) {
  return (uintptr_t)m.base % 16 == 0 && m.s_outer % 4 == 0 && m.s_inner % 4 == 0;
}

template <class F>
static int launch(RowMap a, RowMap b, int32_t* out, long long n, void* stream) {
  if (n <= 0 || n >= (1ll << 31) || a.inner < 1 || a.inner > n || b.inner < 1 || b.inner > n ||
      (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int vec = aligned(a) | (aligned(b) << 1);
  const long long blocks = (n + MontRows<F>::ROWS - 1) / MontRows<F>::ROWS;
  mont_mul_kernel<F><<<(unsigned)blocks, MontRows<F>::ROWS, 0, (cudaStream_t)stream>>>(a, b, out, n, vec);
  return (int)cudaGetLastError();
}

// a and b: base pointer, inner, s_outer, s_inner (int32 units); out: n
// contiguous rows
extern "C" int masp_mont_mul_fr(const int32_t* a, long long a_inner, long long a_outer, long long a_stride,
                                const int32_t* b, long long b_inner, long long b_outer, long long b_stride,
                                int32_t* out, long long n, void* stream) {
  return launch<Fr>({a, a_inner, a_outer, a_stride}, {b, b_inner, b_outer, b_stride}, out, n, stream);
}

extern "C" int masp_mont_mul_fq(const int32_t* a, long long a_inner, long long a_outer, long long a_stride,
                                const int32_t* b, long long b_inner, long long b_outer, long long b_stride,
                                int32_t* out, long long n, void* stream) {
  return launch<Fq>({a, a_inner, a_outer, a_stride}, {b, b_inner, b_outer, b_stride}, out, n, stream);
}

// --- inversion: a divstep GCD, one launch for a batch of rows ---------------------
//
// mont_inv_kernel<F> replaces masp_tpu/ops/field_jax.py:233 mont_inv_small,
// a lax.scan of 4-bit fixed-window Fermat steps over the Pallas product
// _mont_mul_kernel (masp_tpu/kernels/field_kernels.py:350): a^(N-2), 489
// dependent products for Fq and 329 for Fr. In Fq it inverts the root of
// every batched inversion (the fetch's to_affine, each batch-affine ladder
// level); in Fr that of the Jubjub path's (decompression, the bulk Merkle
// tree). The plain version is mont_inv_plain in kernels/mont_mul.py, the
// same algorithm step for step in int64 tensors (on Python ints for a few
// rows).
//
// Algorithm: Bernstein and Yang's constant-time extended GCD ("Fast
// constant-time gcd computation and modular inversion", 2019), in the 32-bit
// form of libsecp256k1's modinv32. The input row is x = a R (Montgomery
// form, R = 2^(32W)), packed into K signed 30-bit limbs (K = 13 for Fq, 9 for
// Fr: |f|, |g| <= N and d, e in (-2N, N) with a sign). With f = N, g = x,
// d = 0, e = 1 and delta = 1, each of BATCHES batches runs 30 branch-free
// divsteps on the low limbs of f and g alone, which yields a transition
// matrix scaled by 2^30 (entries in [-2^30, 2^30]: int32); the matrix is
// applied to (f, g), divided by 2^30 exactly, and to (d, e), plus the
// multiple of N (from N^-1 mod 2^30) that clears their low 30 bits. f = d x
// and g = e x mod N hold throughout. The count is fixed: the paper's
// Theorem 11.2 bounds the divsteps from delta = 1 that bring g to 0 by
// floor((49 b + 80) / 17) for f^2 + 4 g^2 <= 5 2^(2b), here f = N < 2^b and
// g < 2^b: 1,102 for Fq (b = 381; 37 batches, 1,110 steps) and 739 for Fr
// (b = 255; 25 batches, 750). Then g = 0, f = +-1 (f = N for x = 0) and
// x^-1 = sign(f) d, normalised into [0, N); one fe_mul by R^3 mod N gives
// a^-1 R, the Montgomery form of the inverse. The inverse is unique and
// fe_mul fully reduces, so the limbs equal the Fermat chain's
// (kernels/mont_mul.fermat_chain) and host pow(x, N - 2, N); 0 maps to 0 (g =
// 0 leaves d = 0). Every row runs the same instructions: no branch depends on
// the data.
//
// Bound: latency. On the proof path the kernel sees one to a few rows, so
// one thread walks one row's whole dependent chain, in registers (no shared
// memory). The batches' loop body is the chain: 1,277 SASS instructions for
// Fq and 1,139 for Fr (chip_smoke.py's "sass" lines, from cuobjdump -sass),
// about 28 a divstep (the masked updates of f, u, v and g, q, r are
// single-word LOP3/IADD steps) and the rest the two matrix products, 32 x 32
// -> 64-bit IMAD.WIDE carry chains; 48,767 instructions a row for Fq and
// 29,272 for Fr, against the 489 (329) dependent CIOS products of the
// Fermat chain it replaces. Measured (PERF.md): 0.046 ms (Fq) and
// 0.027 ms (Fr) a launch at 1 row, launch included, about 1.9 cycles an
// instruction at 1.98 GHz. The kernel table's operations bound counts this
// kernel's own 32-bit operations (28 a divstep, 2 a 32 x 32 -> 64-bit
// product; 41,448 a row for Fq, 25,872 for Fr: chip_smoke.py _divstep_ops)
// at the card's INT32 rate, across all its lanes; one row's chain, not that
// rate, sets the time. 32 threads a block keep the 1,003-row check one wave.

constexpr int INV_THREADS = 32;
constexpr int DIVSTEPS = 30;
constexpr int32_t M30 = 0x3fffffff;

// N in signed 30-bit limbs, little-endian
static __constant__ int32_t FQ_N30[13] = {
    0x3fffaaab, 0x27fbffff, 0x153ffffb, 0x2affffac, 0x30f6241e, 0x034a83da, 0x112bf673,
    0x12e13ce1, 0x2cd76477, 0x1ed90d2e, 0x29a4b1ba, 0x3a8e5ff9, 0x001a0111};
static __constant__ int32_t FR_N30[9] = {
    0x00000001, 0x3ffffffc, 0x3fe5bfef, 0x2f6900bf, 0x21d80553, 0x27602026, 0x17d48333,
    0x29d4ca67, 0x000073ed};
// R^3 mod N in 32-bit words
static __constant__ uint32_t FQ_R3[12] = {
    0xd94ca1e0u, 0xed48ac6bu, 0x03a7adf8u, 0x315f831eu, 0x615e29ddu, 0x9a53352au,
    0x921e1761u, 0x34c04e5eu, 0x65724728u, 0x2512d435u, 0x91755d4du, 0x0aa63460u};
static __constant__ uint32_t FR_R3[8] = {
    0x439b73afu, 0xc62c1807u, 0x8cf06990u, 0x1b3e0d18u, 0xc7b5f418u, 0x73d13c71u,
    0xc8db33e9u, 0x6e2a5bb9u};

template <class F>
struct Inv;
template <>
struct Inv<Fq> {
  static constexpr int K = 13;                  // signed 30-bit limbs
  static constexpr int BATCHES = 37;            // 1,110 divsteps >= 1,102
  static constexpr uint32_t NINV30 = 0x30003u;  // N^-1 mod 2^30
  __device__ __forceinline__ static int32_t n30(int k) { return FQ_N30[k]; }
  __device__ __forceinline__ static uint32_t r3(int j) { return FQ_R3[j]; }
};
template <>
struct Inv<Fr> {
  static constexpr int K = 9;
  static constexpr int BATCHES = 25;  // 750 divsteps >= 739
  static constexpr uint32_t NINV30 = 0x1u;
  __device__ __forceinline__ static int32_t n30(int k) { return FR_N30[k]; }
  __device__ __forceinline__ static uint32_t r3(int j) { return FR_R3[j]; }
};

// the transition matrix [[u, v], [q, r]] of a batch, scaled by 2^30
struct Trans {
  int32_t u, v, q, r;
};

// DIVSTEPS divsteps on the low 32 bits of f and g (only their low bits
// decide), with eta = -delta: where delta > 0 and g is odd, (f, g) <- (g,
// (g - f) / 2) and delta <- 1 - delta, else g <- (g + (g odd) f) / 2 and
// delta <- 1 + delta. Masks, no branches. Returns the new eta.
__device__ __forceinline__ int32_t divsteps_30(int32_t eta, uint32_t f, uint32_t g, Trans& t) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
#pragma unroll
  for (int i = 0; i < DIVSTEPS; i++) {
    uint32_t c1 = (uint32_t)(eta >> 31);  // all ones where delta > 0
    const uint32_t c2 = 0u - (g & 1u);    // all ones where g is odd
    g += ((f ^ c1) - c1) & c2;            // g +- f where g is odd
    q += ((u ^ c1) - c1) & c2;
    r += ((v ^ c1) - c1) & c2;
    c1 &= c2;  // the swap
    eta = (eta ^ (int32_t)c1) - ((int32_t)c1 + 1);
    f += g & c1;  // f <- the old g where swapped
    u += q & c1;
    v += r & c1;
    g >>= 1;
    u <<= 1;  // the matrix scales by 2^30 instead of halving g's row
    v <<= 1;
  }
  t = {(int32_t)u, (int32_t)v, (int32_t)q, (int32_t)r};
  return eta;
}

// (f, g) <- t (f, g) / 2^30, exact; limbs 0 .. K-2 in [0, 2^30), the top signed
template <int K>
__device__ __forceinline__ void update_fg(int32_t (&f)[K], int32_t (&g)[K], const Trans& t) {
  int64_t cf = (int64_t)t.u * f[0] + (int64_t)t.v * g[0];
  int64_t cg = (int64_t)t.q * f[0] + (int64_t)t.r * g[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int k = 1; k < K; k++) {
    cf += (int64_t)t.u * f[k] + (int64_t)t.v * g[k];
    cg += (int64_t)t.q * f[k] + (int64_t)t.r * g[k];
    f[k - 1] = (int32_t)cf & M30;
    g[k - 1] = (int32_t)cg & M30;
    cf >>= 30;
    cg >>= 30;
  }
  f[K - 1] = (int32_t)cf;
  g[K - 1] = (int32_t)cg;
}

// (d, e) <- (t (d, e) + N (md, me)) / 2^30 with (md, me) chosen so that the
// sum's low 30 bits vanish, starting from t's column where d or e is
// negative: d, e stay in (-2N, N) (libsecp256k1's update_de)
template <class F>
__device__ __forceinline__ void update_de(int32_t (&d)[Inv<F>::K], int32_t (&e)[Inv<F>::K], const Trans& t) {
  using I = Inv<F>;
  constexpr int K = I::K;
  const int32_t sd = d[K - 1] >> 31, se = e[K - 1] >> 31;
  int32_t md = (t.u & sd) + (t.v & se);
  int32_t me = (t.q & sd) + (t.r & se);
  int64_t cd = (int64_t)t.u * d[0] + (int64_t)t.v * e[0];
  int64_t ce = (int64_t)t.q * d[0] + (int64_t)t.r * e[0];
  md -= (int32_t)((I::NINV30 * (uint32_t)cd + (uint32_t)md) & (uint32_t)M30);
  me -= (int32_t)((I::NINV30 * (uint32_t)ce + (uint32_t)me) & (uint32_t)M30);
  cd += (int64_t)I::n30(0) * md;
  ce += (int64_t)I::n30(0) * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int k = 1; k < K; k++) {
    cd += (int64_t)t.u * d[k] + (int64_t)t.v * e[k] + (int64_t)I::n30(k) * md;
    ce += (int64_t)t.q * d[k] + (int64_t)t.r * e[k] + (int64_t)I::n30(k) * me;
    d[k - 1] = (int32_t)cd & M30;
    e[k - 1] = (int32_t)ce & M30;
    cd >>= 30;
    ce >>= 30;
  }
  d[K - 1] = (int32_t)cd;
  e[K - 1] = (int32_t)ce;
}

template <int K>
__device__ __forceinline__ void carry30(int32_t (&d)[K]) {
#pragma unroll
  for (int k = 0; k < K - 1; k++) {
    d[k + 1] += d[k] >> 30;
    d[k] &= M30;
  }
}

// d in (-2N, N) -> sign(f) d in [0, N): add N if negative, negate where f <
// 0, add N if negative
template <class F>
__device__ __forceinline__ void normalize(int32_t (&d)[Inv<F>::K], int32_t f_top) {
  constexpr int K = Inv<F>::K;
  int32_t add = d[K - 1] >> 31;
#pragma unroll
  for (int k = 0; k < K; k++) d[k] += Inv<F>::n30(k) & add;
  const int32_t neg = f_top >> 31;
#pragma unroll
  for (int k = 0; k < K; k++) d[k] = (d[k] ^ neg) - neg;
  carry30(d);
  add = d[K - 1] >> 31;
#pragma unroll
  for (int k = 0; k < K; k++) d[k] += Inv<F>::n30(k) & add;
  carry30(d);
}

// 32-bit words -> 30-bit limbs and back (compile-time offsets: limb k's bit
// 0 lies 30 k - 32 j bits above word j's)
template <class F>
__device__ __forceinline__ void to_s30(int32_t (&s)[Inv<F>::K], const Fe<F>& a) {
#pragma unroll
  for (int k = 0; k < Inv<F>::K; k++) {
    uint32_t x = 0;
#pragma unroll
    for (int j = 0; j < F::W; j++) {
      const int off = 32 * j - 30 * k;
      if (off > -32 && off < 30) x |= off >= 0 ? a.w[j] << off : a.w[j] >> -off;
    }
    s[k] = (int32_t)(x & (uint32_t)M30);
  }
}

template <class F>
__device__ __forceinline__ void from_s30(Fe<F>& a, const int32_t (&s)[Inv<F>::K]) {
#pragma unroll
  for (int j = 0; j < F::W; j++) {
    uint32_t x = 0;
#pragma unroll
    for (int k = 0; k < Inv<F>::K; k++) {
      const int off = 30 * k - 32 * j;
      if (off > -30 && off < 32) x |= off >= 0 ? (uint32_t)s[k] << off : (uint32_t)s[k] >> -off;
    }
    a.w[j] = x;
  }
}

template <class F>
__global__ void __launch_bounds__(INV_THREADS)
mont_inv_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out, long long n) {
  using I = Inv<F>;
  constexpr int K = I::K;
  const long long i = (long long)blockIdx.x * INV_THREADS + threadIdx.x;
  if (i >= n) return;
  Fe<F> x;
  load(x, a + i * (2 * F::W));
  int32_t f[K], g[K], d[K], e[K];
  to_s30<F>(g, x);
#pragma unroll
  for (int k = 0; k < K; k++) {
    f[k] = I::n30(k);
    d[k] = 0;
    e[k] = k == 0 ? 1 : 0;
  }
  int32_t eta = -1;  // -delta, delta = 1
#pragma unroll 1
  for (int b = 0; b < I::BATCHES; b++) {
    Trans t;
    eta = divsteps_30(eta, (uint32_t)f[0], (uint32_t)g[0], t);
    update_de<F>(d, e, t);
    update_fg<K>(f, g, t);
  }
  normalize<F>(d, f[K - 1]);
  Fe<F> inv, r3, y;
  from_s30<F>(inv, d);
#pragma unroll
  for (int j = 0; j < F::W; j++) r3.w[j] = I::r3(j);
  fe_mul(y, inv, r3);
  store(out + i * (2 * F::W), y);
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

// Batched Montgomery product a * b * R^-1 mod N for Fr (L = 16) and Fq (L = 24),
// and the Fermat inversion a^(N-2) as one launch (mont_inv_kernel, below).
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
// row stride in words so that the lanes' row reads hit 32 banks), multiplies
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
struct MontRows {
  static constexpr int W = F::W;
  static constexpr int L = 2 * W;
  static constexpr int ROWS = 128;          // products a block, one a thread
  static constexpr int CHUNKS = L / 4;      // 16-byte chunks a row: 4 (Fr), 6 (Fq)
  static constexpr int STRIDE = W + 1;      // words a staged row: odd (9, 13)
  static constexpr int AREA = 32 * STRIDE;  // one operand's rows of one warp
};

// row i's int32 offset from the map's base; i < 2^31 and inner <= n
__device__ __forceinline__ long long row_offset(const RowMap& m, long long i) {
  const unsigned inner = (unsigned)m.inner;
  const unsigned q = (unsigned)i / inner, r = (unsigned)i - q * inner;
  return (long long)q * m.s_outer + (long long)r * m.s_inner;
}

// the lane's CHUNKS loads of its warp's 32 rows of one operand (chunk c =
// lane + 32 k: row c / CHUNKS, whose offset that row's lane holds in off),
// all issued before any is used
template <class F, bool VEC>
__device__ __forceinline__ void load_chunks(int4 (&v)[MontRows<F>::CHUNKS], const int32_t* base,
                                            long long off, int lane) {
  using M = MontRows<F>;
#pragma unroll
  for (int k = 0; k < M::CHUNKS; k++) {
    const int c = lane + 32 * k;
    const int32_t* src = base + __shfl_sync(0xffffffffu, off, c / M::CHUNKS) + 4 * (c % M::CHUNKS);
    if (VEC) {
      v[k] = __ldg(reinterpret_cast<const int4*>(src));
    } else {
      v[k] = make_int4(__ldg(src), __ldg(src + 1), __ldg(src + 2), __ldg(src + 3));
    }
  }
}

// the loaded chunks as packed words into the warp's staging area; rows past n as 0
template <class F>
__device__ __forceinline__ void stage_chunks(uint32_t* area, const int4 (&v)[MontRows<F>::CHUNKS],
                                             long long live, int lane) {
  using M = MontRows<F>;
#pragma unroll
  for (int k = 0; k < M::CHUNKS; k++) {
    const int c = lane + 32 * k;
    const int r = c / M::CHUNKS;
    const uint32_t keep = r < live ? ~0u : 0u;
    uint32_t* d = area + r * M::STRIDE + 2 * (c % M::CHUNKS);
    d[0] = ((uint32_t)v[k].x | ((uint32_t)v[k].y << 16)) & keep;
    d[1] = ((uint32_t)v[k].z | ((uint32_t)v[k].w << 16)) & keep;
  }
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

  // the warp's output rows are consecutive: 16 bytes a lane, in order
#pragma unroll
  for (int k = 0; k < M::CHUNKS; k++) {
    const int c = lane + 32 * k;
    const int r = c / M::CHUNKS;
    if (r < live) {
      const uint32_t* s = A + r * M::STRIDE + 2 * (c % M::CHUNKS);
      const int4 v = make_int4((int)(s[0] & 0xffffu), (int)(s[0] >> 16),
                               (int)(s[1] & 0xffffu), (int)(s[1] >> 16));
      *reinterpret_cast<int4*>(out + first * M::L + 4 * (long long)c) = v;
    }
  }
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

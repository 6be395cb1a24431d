// One batch-affine ladder level on BLS12-381 G1 and G2, the elementwise
// halves around the batched inversion: affine_pre_kernel<E> and
// affine_post_kernel<E>, one template over the coordinate element, E = FqE
// (G1) or Fq2E (G2). For G1 they replace the Pallas kernels
// _affine_pre_kernel and _affine_post_kernel
// (masp_tpu/kernels/field_kernels.py, behind _affine_pre_callable and
// _affine_post_callable); for G2 the JAX package's composed level,
// masp_tpu/ops/msm_sorted.py:435 _affine_level over its Fq2 operations, which
// has no Pallas body. kernels/affine.py runs the product-tree inversion
// between them through the Fq mont_mul kernel, as klay_affine_level does.
//
// An affine node is a row of 2K + 1 int32: [x | y | f], x and y as K 16-bit
// Montgomery limbs (canonical, < q; K = 24 on G1, 48 on G2, c0 then c1), f != 0
// marking the identity, whose coordinates may hold any canonical values.
// Operand rows may be strided (the ladder pairs even and odd rows of one
// tensor in place); output rows are contiguous. The plain PyTorch versions
// are affine_pre_plain and affine_post_plain in kernels/affine.py.
//
// affine_pre: the case masks, the slope numerator n (3 x1^2 when doubling,
// else y2 - y1), the denominator d (2 y1 or x2 - x1, and 1 on every lane that
// adds nothing, so that the product tree stays invertible) and a case code
// (bit 0: P1 is the identity, bit 1: P2 is, bit 2: P1 + P2 is, as P + (-P),
// bit 3: doubling). It writes n, the code and d's norm to Fq: d itself on G1,
// d0^2 + d1^2 on G2, so that one Fq product tree inverts every group's
// denominators. affine_post: d again from the points and the code (post
// reads no d), d^-1 from the norm's inverse (on G2 (d0 - d1 u) / (d0^2 +
// d1^2)), lam = n d^-1, x3 = lam^2 - x1 - x2, y3 = lam (x1 - x3) - y1, the
// identity pass-throughs, and identity results normalised to (0, mont-1)
// with flag 1. The inverse of a non-zero element of Fq2 is unique, d0^2 +
// d1^2 != 0 for d != 0 (q = 3 mod 4: -1 is no square), and every step reduces
// fully, so lam, x3 and y3 have the limbs of the composed Fq2 level.
//
// Bound: bytes. Per lane, G1 pre reads 2 x 49 int32 and writes 24 + 24 + 1
// (588 B), post reads 24 + 24 + 2 x 49 + 1 and writes 49 (784 B); G2 pre
// reads 2 x 97 and writes 48 + 24 + 1 (1,068 B), post reads 48 + 24 + 2 x 97
// + 1 and writes 97 (1,456 B). The arithmetic, at most 3 Fq products a lane
// on G1 and 2 + 3 (pre) or 10 (post) on G2, takes less time at the card's
// multiply-add rate. The rows of one warp lie 2K + 1 (or twice that) words
// apart, so one thread per lane loading its own row touches 32 sectors per
// load instruction. Instead a block first stages its lanes' operand rows in
// shared memory: threads take consecutive words of the rows (the ladder's
// two operands are one contiguous span), pack each pair of limbs into a
// 32-bit word, and store them at an odd stride (2K/2 + 1 words a row), so
// that one thread per lane then reads its row on 32 banks. Outputs leave the
// same way, staged and written as consecutive words. A G2 lane's four
// operands are 96 words: the thread keeps them in shared memory and loads
// each when a step needs it, so that only the step's values and one Fq2
// product's temporaries live in registers.

#include "field.cuh"

template <class E>
struct Affine {
  static constexpr int WORDS = sizeof(E) / 4;  // 32-bit words a coordinate: 12 or 24
  static constexpr int L = 2 * WORDS;          // 16-bit limbs a coordinate: 24 or 48
  static constexpr int ROW = 2 * L + 1;        // int32 a row [x | y | f]: 49 or 97
  static constexpr int SROW = 2 * WORDS + 1;   // words a staged row: 25 or 49 (odd)
  static constexpr int SN = WORDS + 1;         // words a staged n: 13 or 25 (odd)
  static constexpr int SQ = Fq::W + 1;         // words a staged norm or inverse: 13
  static constexpr int LANES = WORDS == Fq::W ? 128 : 64;  // one thread a lane
  // [P1 rows | P2 rows | n | norm or its inverse]: 38,912 or 34,816 bytes
  static constexpr int SMEM = LANES * (2 * SROW + SN + SQ);
  // staging steps unrolled in pre and in post (see stage_rows): more loads
  // in flight, as long as the staging needs no more registers than the
  // arithmetic; G2 post's Fq2 products already hold the most, so a deeper
  // unroll there costs occupancy (PERF.md)
  static constexpr int PRE_UNROLL = 12;
  static constexpr int POST_UNROLL = WORDS == Fq::W ? 12 : 2;
};

// d's norm to Fq, and d^-1 from the norm's inverse
__device__ __forceinline__ void norm(FqE& r, const FqE& d) { r = d; }

__device__ __forceinline__ void norm(FqE& r, const Fq2E& d) {
  FqE t;
  fe_mul(r, d.c0, d.c0);
  fe_mul(t, d.c1, d.c1);
  fe_add(r, r, t);
}

__device__ __forceinline__ void inv_from_norm(FqE& d, const FqE& ninv) { d = ninv; }

__device__ __forceinline__ void inv_from_norm(Fq2E& d, const FqE& ninv) {
  FqE t;
  fe_mul(d.c0, d.c0, ninv);
  fe_mul(t, d.c1, ninv);
  neg(d.c1, t);
}

// a^2; on Fq2 (a0 + a1)(a0 - a1) + 2 a0 a1 u: two Fq products
__device__ __forceinline__ void sqr(FqE& r, const FqE& a) { fe_mul(r, a, a); }

__device__ __forceinline__ void sqr(Fq2E& r, const Fq2E& a) {
  FqE s, d, m;
  fe_add(s, a.c0, a.c1);
  fe_sub(d, a.c0, a.c1);
  fe_mul(m, a.c0, a.c1);
  fe_mul(r.c0, s, d);
  fe_add(r.c1, m, m);
}

__device__ __forceinline__ uint32_t pack(const int32_t* p) {
  return (uint32_t)__ldg(p) | ((uint32_t)__ldg(p + 1) << 16);
}

// rows [x | y | f] of a block's lanes (row stride s int32) into shared
// memory as SROW packed words a row, the flag as read; lanes past n hold 0.
// The loop body has no branch, so that U unrolled steps issue their loads
// together: a lane past n reads the last row, the flag word its one limb
// twice. U trades loads in flight against registers.
template <class E, int U>
__device__ __forceinline__ void stage_rows(uint32_t* dst, const int32_t* __restrict__ src, long long s,
                                           long long first, long long n) {
  using A = Affine<E>;
#pragma unroll U
  for (int i = 0; i < A::SROW; i++) {
    const int k = threadIdx.x + i * A::LANES;
    const int r = k / A::SROW, w = k - r * A::SROW;
    const bool limbs = w < 2 * A::WORDS;
    const int32_t* p = src + (first + r < n ? first + r : n - 1) * s + 2 * w;
    const uint32_t lo = (uint32_t)__ldg(p), hi = (uint32_t)__ldg(p + (limbs ? 1 : 0));
    dst[k] = first + r < n ? (limbs ? lo | (hi << 16) : lo) : 0u;
  }
}

// contiguous rows of 2 WT limbs into shared memory, WT + 1 words a row
template <int LANES, int WT, int U>
__device__ __forceinline__ void stage_flat(uint32_t* dst, const int32_t* __restrict__ src, long long first,
                                           long long n) {
#pragma unroll U
  for (int i = 0; i < WT; i++) {
    const int k = threadIdx.x + i * LANES;
    const int r = k / WT, w = k - r * WT;
    const uint32_t v = pack(src + (first + r < n ? first + r : n - 1) * (2 * WT) + 2 * w);
    dst[r * (WT + 1) + w] = first + r < n ? v : 0u;
  }
}

// staged words back to contiguous rows of LIMBS int32 (SW words a staged
// row), one int32 a thread and step; with FLAG the last limb is the word
// itself
template <int LANES, int LIMBS, int SW, bool FLAG>
__device__ __forceinline__ void unstage(int32_t* __restrict__ dst, const uint32_t* src, long long first,
                                        long long n) {
#pragma unroll 8
  for (int i = 0; i < LIMBS; i++) {
    const int g = threadIdx.x + i * LANES;
    const int r = g / LIMBS, l = g - r * LIMBS;
    if (first + r < n) {
      const uint32_t word = src[r * SW + l / 2];
      const bool whole = FLAG && l == LIMBS - 1;
      dst[first * LIMBS + g] = (int32_t)(whole ? word : (l & 1) ? word >> 16 : word & 0xffffu);
    }
  }
}

template <class E>
__global__ void __launch_bounds__(Affine<E>::LANES)
affine_pre_kernel(const int32_t* __restrict__ p1, long long s1, const int32_t* __restrict__ p2,
                  long long s2, int32_t* __restrict__ n_out, int32_t* __restrict__ norm_out,
                  int32_t* __restrict__ code_out, long long n) {
  using A = Affine<E>;
  constexpr int W = A::WORDS;
  __shared__ uint32_t smem[A::SMEM];
  uint32_t* sA = smem;
  uint32_t* sB = sA + A::LANES * A::SROW;
  uint32_t* sN = sB + A::LANES * A::SROW;
  uint32_t* sQ = sN + A::LANES * A::SN;
  const int t = threadIdx.x;
  const long long first = (long long)blockIdx.x * A::LANES;
  stage_rows<E, A::PRE_UNROLL>(sA, p1, s1, first, n);
  stage_rows<E, A::PRE_UNROLL>(sB, p2, s2, first, n);
  __syncthreads();

  const uint32_t* a = sA + t * A::SROW;
  const uint32_t* b = sB + t * A::SROW;
  const bool i1 = a[2 * W] != 0;
  const bool i2 = b[2 * W] != 0;
  const bool fin = !i1 && !i2;
  E u, v;
  lds(u, a);
  lds(v, b);
  const bool xeq = eq(u, v);
  lds(u, b + W);
  neg(u, u);  // -y2
  lds(v, a + W);
  const bool yneg = eq(v, u);
  const bool res_inf = fin && xeq && yneg;
  const bool use_dbl = fin && xeq && !yneg;
  const bool live = fin && !res_inf;

  // n = use_dbl ? 3 x1^2 : y2 - y1
  if (use_dbl) {
    lds(u, a);
    sqr(v, u);
    add(u, v, v);
    add(u, u, v);
  } else {
    lds(u, b + W);
    lds(v, a + W);
    sub(u, u, v);
  }
  sts(sN + t * A::SN, u);
  // d = live ? (use_dbl ? 2 y1 : x2 - x1) : mont-1, and its norm
  if (use_dbl) {
    lds(u, a + W);
    add(u, u, u);
  } else {
    lds(u, b);
    lds(v, a);
    sub(u, u, v);
  }
  if (!live) mont_one_or_zero(u, true);
  FqE q;
  norm(q, u);
  sts(sQ + t * A::SQ, q);
  if (first + t < n)
    code_out[first + t] = (int32_t)((i1 ? 1u : 0u) | (i2 ? 2u : 0u) | (res_inf ? 4u : 0u) |
                                    (use_dbl ? 8u : 0u));
  __syncthreads();
  unstage<A::LANES, A::L, A::SN, false>(n_out, sN, first, n);
  unstage<A::LANES, 2 * Fq::W, A::SQ, false>(norm_out, sQ, first, n);
}

template <class E>
__global__ void __launch_bounds__(Affine<E>::LANES)
affine_post_kernel(const int32_t* __restrict__ nr, const int32_t* __restrict__ ninvr,
                   const int32_t* __restrict__ p1, long long s1, const int32_t* __restrict__ p2,
                   long long s2, const int32_t* __restrict__ code, int32_t* __restrict__ out,
                   long long n) {
  using A = Affine<E>;
  constexpr int W = A::WORDS;
  __shared__ uint32_t smem[A::SMEM];
  uint32_t* sA = smem;
  uint32_t* sB = sA + A::LANES * A::SROW;
  uint32_t* sN = sB + A::LANES * A::SROW;
  uint32_t* sQ = sN + A::LANES * A::SN;
  const int t = threadIdx.x;
  const long long first = (long long)blockIdx.x * A::LANES;
  stage_rows<E, A::POST_UNROLL>(sA, p1, s1, first, n);
  stage_rows<E, A::POST_UNROLL>(sB, p2, s2, first, n);
  stage_flat<A::LANES, W, A::POST_UNROLL>(sN, nr, first, n);
  stage_flat<A::LANES, Fq::W, A::POST_UNROLL>(sQ, ninvr, first, n);
  const uint32_t c = first + t < n ? (uint32_t)code[first + t] : 7u;
  __syncthreads();

  // the result row overwrites this lane's staged P1 row once it is read
  uint32_t* a = sA + t * A::SROW;
  const uint32_t* b = sB + t * A::SROW;
  const bool i1 = (c & 1u) != 0;
  const bool i2 = (c & 2u) != 0;
  const bool res_inf = (c & 4u) != 0;
  const bool use_dbl = (c & 8u) != 0;
  const bool fo = (i1 && i2) || res_inf;
  E xo, yo;
  if (i1 || i2 || res_inf) {  // no slope: i1 ? P2 : P1, identity results -> (0, mont-1)
    const uint32_t* src = i1 ? b : a;
    lds(xo, src);
    lds(yo, src + W);
    if (fo) {
      keep_or_zero(xo, xo, false);
      mont_one_or_zero(yo, true);
    }
  } else {
    E d, u;
    if (use_dbl) {  // on G1 d is dead: its inverse is the norm's
      lds(d, a + W);
      add(d, d, d);
    } else {
      lds(d, b);
      lds(u, a);
      sub(d, d, u);
    }
    FqE ninv;
    lds(ninv, sQ + t * A::SQ);
    inv_from_norm(d, ninv);
    lds(u, sN + t * A::SN);
    E lam;
    mul(lam, u, d);
    sqr(xo, lam);
    lds(u, a);
    sub(xo, xo, u);
    lds(u, b);
    sub(xo, xo, u);  // x3 = lam^2 - x1 - x2
    lds(u, a);
    sub(u, u, xo);
    mul(yo, lam, u);
    lds(u, a + W);
    sub(yo, yo, u);  // y3 = lam (x1 - x3) - y1
  }
  sts(a, xo);
  sts(a + W, yo);
  a[2 * W] = fo ? 1u : 0u;
  __syncthreads();
  unstage<A::LANES, A::ROW, A::SROW, true>(out, sA, first, n);
}

template <class E>
static unsigned blocks_for(long long n) {
  return (unsigned)((n + Affine<E>::LANES - 1) / Affine<E>::LANES);
}

template <class E>
static int launch_pre(const int32_t* p1, long long s1, const int32_t* p2, long long s2, int32_t* n_out,
                      int32_t* norm_out, int32_t* code_out, long long n, void* stream) {
  affine_pre_kernel<E><<<blocks_for<E>(n), Affine<E>::LANES, 0, (cudaStream_t)stream>>>(
      p1, s1, p2, s2, n_out, norm_out, code_out, n);
  return (int)cudaGetLastError();
}

template <class E>
static int launch_post(const int32_t* nr, const int32_t* ninvr, const int32_t* p1, long long s1,
                       const int32_t* p2, long long s2, const int32_t* code, int32_t* out, long long n,
                       void* stream) {
  affine_post_kernel<E><<<blocks_for<E>(n), Affine<E>::LANES, 0, (cudaStream_t)stream>>>(
      nr, ninvr, p1, s1, p2, s2, code, out, n);
  return (int)cudaGetLastError();
}

// group: 1 (G1, rows of 49 int32) or 2 (G2, rows of 97)
extern "C" int masp_affine_pre(int group, const int32_t* p1, long long s1, const int32_t* p2,
                               long long s2, int32_t* n_out, int32_t* norm_out, int32_t* code_out,
                               long long n, void* stream) {
  if (group == 1) return launch_pre<FqE>(p1, s1, p2, s2, n_out, norm_out, code_out, n, stream);
  if (group == 2) return launch_pre<Fq2E>(p1, s1, p2, s2, n_out, norm_out, code_out, n, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int masp_affine_post(int group, const int32_t* nr, const int32_t* ninvr, const int32_t* p1,
                                long long s1, const int32_t* p2, long long s2, const int32_t* code,
                                int32_t* out, long long n, void* stream) {
  if (group == 1) return launch_post<FqE>(nr, ninvr, p1, s1, p2, s2, code, out, n, stream);
  if (group == 2) return launch_post<Fq2E>(nr, ninvr, p1, s1, p2, s2, code, out, n, stream);
  return (int)cudaErrorInvalidValue;
}

// Montgomery field arithmetic for BLS12-381 Fr and Fq, one element per thread.
//
// Elements live in registers as 32-bit words (W = 8 for Fr, 12 for Fq),
// packed from pairs of the 16-bit limbs that the port's tensors hold
// (int32 rows of L = 2W limbs). R is 2^256 for Fr and 2^384 for Fq, the same
// as the JAX package's 16-bit-limb R, so the Montgomery forms agree limb for
// limb. Every result is fully reduced (< N); products use CIOS with 64-bit
// partial products. add/sub assume canonical inputs, as the curve formulas
// always pass.
//
// The coordinate elements of the curve kernels are FqE (G1) and Fq2E =
// Fq[u]/(u^2 + 1) (G2, c0 then c1 at a 24-limb offset), with one set of
// overloads (mul, add, sub, neg, eq, sel, mont_one_or_zero, keep_or_zero,
// lds/sts), so that a kernel template over the element serves both groups.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

static __constant__ uint32_t FR_N[8] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
static __constant__ uint32_t FQ_N[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
    0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
    0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
// R mod r: the Montgomery form of 1 in Fr
static __constant__ uint32_t FR_ONE[8] = {
    0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
    0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};
// R mod q: the Montgomery form of 1 in Fq
static __constant__ uint32_t FQ_ONE[12] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
    0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
    0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};

struct Fr {
  static constexpr int W = 8;
  static constexpr uint32_t NINV = 0xffffffffu;  // -N^-1 mod 2^32
  __device__ __forceinline__ static uint32_t mod(int i) { return FR_N[i]; }
  __device__ __forceinline__ static uint32_t one(int i) { return FR_ONE[i]; }
};

struct Fq {
  static constexpr int W = 12;
  static constexpr uint32_t NINV = 0xfffcfffdu;  // -N^-1 mod 2^32
  __device__ __forceinline__ static uint32_t mod(int i) { return FQ_N[i]; }
  __device__ __forceinline__ static uint32_t one(int i) { return FQ_ONE[i]; }
};

template <class F>
struct Fe {
  uint32_t w[F::W];
};

// --- limb rows <-> registers ------------------------------------------------

template <class F>
__device__ __forceinline__ void load(Fe<F>& r, const int32_t* __restrict__ p) {
#pragma unroll
  for (int i = 0; i < F::W; i++)
    r.w[i] = (uint32_t)p[2 * i] | ((uint32_t)p[2 * i + 1] << 16);
}

template <class F>
__device__ __forceinline__ void store(int32_t* __restrict__ p, const Fe<F>& a) {
#pragma unroll
  for (int i = 0; i < F::W; i++) {
    p[2 * i] = (int32_t)(a.w[i] & 0xffffu);
    p[2 * i + 1] = (int32_t)(a.w[i] >> 16);
  }
}

// --- a warp's 32 limb rows through shared memory --------------------------------
//
// A warp that works on 32 consecutive rows (one a lane) moves them between
// device memory and a staging area in shared memory with 16-byte accesses on
// consecutive chunks, instead of one limb a lane at a row's stride: the
// chunks of the 32 rows are spread over the lanes (chunk c = lane + 32 k
// is chunk c % CHUNKS of row c / CHUNKS). A staged row is W packed 32-bit
// words at an odd stride, so that the lanes' reads of their own rows hit 32
// banks. Used by mont_mul_kernel<F> (mont_mul.cu) and mont_mul_mxu_kernel.

template <class F>
struct Staging {
  static constexpr int W = F::W;
  static constexpr int L = 2 * W;
  static constexpr int CHUNKS = L / 4;      // 16-byte chunks a row: 4 (Fr), 6 (Fq)
  static constexpr int STRIDE = W + 1;      // words a staged row: odd (9, 13)
  static constexpr int AREA = 32 * STRIDE;  // one operand's rows of one warp
};

// the lane's CHUNKS loads of its warp's 32 rows of one operand (chunk c =
// lane + 32 k: row c / CHUNKS, whose int32 offset from base that row's lane
// holds in off), all issued before any is used; VEC: 16-byte loads (base and
// offsets 16-byte aligned), else 4-byte ones. Every lane of the warp calls it.
template <class F, bool VEC>
__device__ __forceinline__ void load_chunks(int4 (&v)[Staging<F>::CHUNKS], const int32_t* base,
                                            long long off, int lane) {
  using M = Staging<F>;
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

// the loaded chunks as packed words into the warp's staging area; rows at
// or past live as 0
template <class F>
__device__ __forceinline__ void stage_chunks(uint32_t* area, const int4 (&v)[Staging<F>::CHUNKS],
                                             long long live, int lane) {
  using M = Staging<F>;
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

// the staged rows below live back to 16-bit limbs at out (the warp's first
// row; rows contiguous, 16-byte aligned): 16 bytes a lane, in order
template <class F>
__device__ __forceinline__ void store_chunks(int32_t* __restrict__ out, const uint32_t* area, long long live,
                                             int lane) {
  using M = Staging<F>;
#pragma unroll
  for (int k = 0; k < M::CHUNKS; k++) {
    const int c = lane + 32 * k;
    const int r = c / M::CHUNKS;
    if (r < live) {
      const uint32_t* s = area + r * M::STRIDE + 2 * (c % M::CHUNKS);
      const int4 v = make_int4((int)(s[0] & 0xffffu), (int)(s[0] >> 16),
                               (int)(s[1] & 0xffffu), (int)(s[1] >> 16));
      *reinterpret_cast<int4*>(out + 4 * (long long)c) = v;
    }
  }
}

// --- arithmetic ---------------------------------------------------------------

// r = t - N when t + carry * 2^(32W) >= N, else t
template <class F>
__device__ __forceinline__ void reduce_once(Fe<F>& r, const uint32_t* t, uint32_t carry) {
  uint32_t d[F::W];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < F::W; j++) {
    uint64_t x = (uint64_t)t[j] - F::mod(j) - borrow;
    d[j] = (uint32_t)x;
    borrow = (uint32_t)(x >> 63);
  }
  const bool ge = carry != 0 || borrow == 0;
#pragma unroll
  for (int j = 0; j < F::W; j++) r.w[j] = ge ? d[j] : t[j];
}

template <class F>
__device__ __forceinline__ void fe_add(Fe<F>& r, const Fe<F>& a, const Fe<F>& b) {
  uint32_t s[F::W];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < F::W; j++) {
    uint64_t x = (uint64_t)a.w[j] + b.w[j] + c;
    s[j] = (uint32_t)x;
    c = x >> 32;
  }
  reduce_once<F>(r, s, (uint32_t)c);
}

template <class F>
__device__ __forceinline__ void fe_sub(Fe<F>& r, const Fe<F>& a, const Fe<F>& b) {
  uint32_t d[F::W];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < F::W; j++) {
    uint64_t x = (uint64_t)a.w[j] - b.w[j] - borrow;
    d[j] = (uint32_t)x;
    borrow = (uint32_t)(x >> 63);
  }
  const uint32_t mask = 0u - borrow;  // add N back when a < b
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < F::W; j++) {
    uint64_t x = (uint64_t)d[j] + (F::mod(j) & mask) + c;
    r.w[j] = (uint32_t)x;
    c = x >> 32;
  }
}

// CIOS Montgomery product r = a * b * 2^(-32W) mod N
template <class F>
__device__ __forceinline__ void fe_mul(Fe<F>& r, const Fe<F>& a, const Fe<F>& b) {
  constexpr int W = F::W;
  uint32_t t[W + 2];
#pragma unroll
  for (int j = 0; j < W + 2; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < W; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < W; j++) {
      uint64_t x = (uint64_t)a.w[j] * b.w[i] + t[j] + c;
      t[j] = (uint32_t)x;
      c = x >> 32;
    }
    uint64_t x = (uint64_t)t[W] + c;
    t[W] = (uint32_t)x;
    t[W + 1] = (uint32_t)(x >> 32);
    const uint32_t m = t[0] * F::NINV;
    x = (uint64_t)m * F::mod(0) + t[0];
    c = x >> 32;
#pragma unroll
    for (int j = 1; j < W; j++) {
      x = (uint64_t)m * F::mod(j) + t[j] + c;
      t[j - 1] = (uint32_t)x;
      c = x >> 32;
    }
    x = (uint64_t)t[W] + c;
    t[W - 1] = (uint32_t)x;
    t[W] = t[W + 1] + (uint32_t)(x >> 32);
  }
  reduce_once<F>(r, t, t[W]);
}

// --- coordinate elements: Fq (G1) and Fq2 (G2) -----------------------------------

using FqE = Fe<Fq>;

struct Fq2E {
  FqE c0, c1;
};

__device__ __forceinline__ void mul(FqE& r, const FqE& a, const FqE& b) { fe_mul(r, a, b); }
__device__ __forceinline__ void add(FqE& r, const FqE& a, const FqE& b) { fe_add(r, a, b); }
__device__ __forceinline__ void sub(FqE& r, const FqE& a, const FqE& b) { fe_sub(r, a, b); }

// Karatsuba: c0 = a0 b0 - a1 b1, c1 = (a0 + a1)(b0 + b1) - a0 b0 - a1 b1
__device__ __forceinline__ void mul(Fq2E& r, const Fq2E& a, const Fq2E& b) {
  FqE v0, v1, sa, sb, s;
  fe_mul(v0, a.c0, b.c0);
  fe_mul(v1, a.c1, b.c1);
  fe_add(sa, a.c0, a.c1);
  fe_add(sb, b.c0, b.c1);
  fe_mul(s, sa, sb);
  fe_sub(r.c0, v0, v1);
  fe_sub(s, s, v0);
  fe_sub(r.c1, s, v1);
}

__device__ __forceinline__ void add(Fq2E& r, const Fq2E& a, const Fq2E& b) {
  fe_add(r.c0, a.c0, b.c0);
  fe_add(r.c1, a.c1, b.c1);
}

__device__ __forceinline__ void sub(Fq2E& r, const Fq2E& a, const Fq2E& b) {
  fe_sub(r.c0, a.c0, b.c0);
  fe_sub(r.c1, a.c1, b.c1);
}

// -a mod q (per coefficient)
__device__ __forceinline__ void neg(FqE& r, const FqE& a) {
  FqE zero;
#pragma unroll
  for (int j = 0; j < Fq::W; j++) zero.w[j] = 0u;
  fe_sub(r, zero, a);
}

__device__ __forceinline__ void neg(Fq2E& r, const Fq2E& a) {
  neg(r.c0, a.c0);
  neg(r.c1, a.c1);
}

__device__ __forceinline__ bool eq(const FqE& a, const FqE& b) {
  uint32_t diff = 0;
#pragma unroll
  for (int j = 0; j < Fq::W; j++) diff |= a.w[j] ^ b.w[j];
  return diff == 0;
}

__device__ __forceinline__ bool eq(const Fq2E& a, const Fq2E& b) {
  return eq(a.c0, b.c0) && eq(a.c1, b.c1);
}

// r = m ? a : b
__device__ __forceinline__ void sel(FqE& r, bool m, const FqE& a, const FqE& b) {
#pragma unroll
  for (int j = 0; j < Fq::W; j++) r.w[j] = m ? a.w[j] : b.w[j];
}

__device__ __forceinline__ void sel(Fq2E& r, bool m, const Fq2E& a, const Fq2E& b) {
  sel(r.c0, m, a.c0, b.c0);
  sel(r.c1, m, a.c1, b.c1);
}

// mont-1 where m, else 0 (on Fq2 the real part)
__device__ __forceinline__ void mont_one_or_zero(FqE& r, bool m) {
#pragma unroll
  for (int j = 0; j < Fq::W; j++) r.w[j] = m ? FQ_ONE[j] : 0u;
}

__device__ __forceinline__ void mont_one_or_zero(Fq2E& r, bool m) {
  mont_one_or_zero(r.c0, m);
  mont_one_or_zero(r.c1, false);
}

__device__ __forceinline__ void keep_or_zero(FqE& r, const FqE& a, bool m) {
#pragma unroll
  for (int j = 0; j < Fq::W; j++) r.w[j] = m ? a.w[j] : 0u;
}

__device__ __forceinline__ void keep_or_zero(Fq2E& r, const Fq2E& a, bool m) {
  keep_or_zero(r.c0, a.c0, m);
  keep_or_zero(r.c1, a.c1, m);
}

// elements as packed 32-bit words in shared memory (c1 follows c0)
__device__ __forceinline__ void lds(FqE& r, const uint32_t* s) {
#pragma unroll
  for (int j = 0; j < Fq::W; j++) r.w[j] = s[j];
}

__device__ __forceinline__ void lds(Fq2E& r, const uint32_t* s) {
  lds(r.c0, s);
  lds(r.c1, s + Fq::W);
}

__device__ __forceinline__ void sts(uint32_t* s, const FqE& a) {
#pragma unroll
  for (int j = 0; j < Fq::W; j++) s[j] = a.w[j];
}

__device__ __forceinline__ void sts(uint32_t* s, const Fq2E& a) {
  sts(s, a.c0);
  sts(s + Fq::W, a.c1);
}

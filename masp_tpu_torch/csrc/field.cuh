// Montgomery field arithmetic for BLS12-381 Fr and Fq, one element per thread.
//
// Elements live in registers as 32-bit words (W = 8 for Fr, 12 for Fq),
// packed from pairs of the 16-bit limbs that the port's tensors hold
// (int32 rows of L = 2W limbs). R is 2^256 for Fr and 2^384 for Fq, the same
// as the JAX package's 16-bit-limb R, so the Montgomery forms agree limb for
// limb. Every result is fully reduced (< N); products use CIOS with 64-bit
// partial products. add/sub assume canonical inputs, as the curve formulas
// always pass.
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
// R mod q: the Montgomery form of 1 in Fq
static __constant__ uint32_t FQ_ONE[12] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
    0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
    0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};

struct Fr {
  static constexpr int W = 8;
  static constexpr uint32_t NINV = 0xffffffffu;  // -N^-1 mod 2^32
  __device__ __forceinline__ static uint32_t mod(int i) { return FR_N[i]; }
};

struct Fq {
  static constexpr int W = 12;
  static constexpr uint32_t NINV = 0xfffcfffdu;  // -N^-1 mod 2^32
  __device__ __forceinline__ static uint32_t mod(int i) { return FQ_N[i]; }
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

// Complete projective point addition on BLS12-381 G1 (over Fq) and G2 (over
// Fq2 = Fq[u]/(u^2 + 1)): Renes-Costello-Batina 2015 Algorithm 7, a = 0,
// b3 = 12 on G1 and 12(1 + u) on G2. One template covers the four Pallas
// kernel bodies it replaces (masp_tpu/kernels/field_kernels.py, all behind
// _g_add_callable): _g1_add_kernel, _g2_add_kernel, and the leaf forms
// _g1_add01_kernel / _g2_add01_kernel, specialised to Z in {0, mont-1}
// (9 field products instead of 12; the identity mask is Z's limb 0 != 0). The
// leaf form gives the complete formula's limbs exactly: with such Z,
// (Y1+Z1)(Y2+Z2) - t1 - t2 = Y1 Z2 + Z1 Y2 is a masked select.
//
// Points are rows of 16-bit limbs, [X | Y | Z] with K = 24 limbs per
// coordinate on G1 and K = 48 (c0 then c1) on G2. Operand rows may be
// strided (the MSM ladder pairs even and odd rows of one tensor in place);
// output rows are contiguous. The plain PyTorch version is point_add_plain in
// kernels/point_add.py.
//
// Bound: integer multiply-add throughput: a G1 add is 12 Fq products (2 * 144
// + 12 multiply-adds each), a G2 add 36, against 9 * 96 or 9 * 192 bytes of
// rows. One thread per point pair keeps the whole formula in registers, as the
// Pallas kernel keeps it in VMEM: no intermediate touches device memory, and
// pairs are independent, so no thread waits on another. G2's operands alone
// are 6 * 24 words; ptxas's spill report is kept with the build.

#include "field.cuh"

using FqE = Fe<Fq>;

struct Fq2E {
  FqE c0, c1;
};

// --- per-coordinate-field operations -------------------------------------------

__device__ __forceinline__ void mul(FqE& r, const FqE& a, const FqE& b) { fe_mul(r, a, b); }
__device__ __forceinline__ void add(FqE& r, const FqE& a, const FqE& b) { fe_add(r, a, b); }
__device__ __forceinline__ void sub(FqE& r, const FqE& a, const FqE& b) { fe_sub(r, a, b); }

__device__ __forceinline__ void times12(FqE& r, const FqE& a) {
  FqE t;
  fe_add(t, a, a);
  fe_add(t, t, a);  // 3a
  fe_add(t, t, t);  // 6a
  fe_add(r, t, t);  // 12a
}

__device__ __forceinline__ void b3(FqE& r, const FqE& a) { times12(r, a); }

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

// * 12(1 + u): scale by 12, then (c0 - c1) + (c0 + c1) u
__device__ __forceinline__ void b3(Fq2E& r, const Fq2E& a) {
  FqE t0, t1;
  times12(t0, a.c0);
  times12(t1, a.c1);
  fe_sub(r.c0, t0, t1);
  fe_add(r.c1, t0, t1);
}

__device__ __forceinline__ void load(Fq2E& r, const int32_t* p) {
  load(r.c0, p);
  load(r.c1, p + 24);
}

__device__ __forceinline__ void store(int32_t* p, const Fq2E& a) {
  store(p, a.c0);
  store(p + 24, a.c1);
}

// identity mask of a leaf operand: Z's first 16-bit limb != 0 (mont-1 has
// limb 0 = 0xfffd; on G2 it is c0's limb)
__device__ __forceinline__ bool live(const FqE& z) { return (z.w[0] & 0xffffu) != 0; }
__device__ __forceinline__ bool live(const Fq2E& z) { return live(z.c0); }

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

// --- the formulas ------------------------------------------------------------

template <class E>
__device__ __forceinline__ void rcb_tail(E& X3, E& Y3, E& Z3, E& t0, E& t1, E& t2,
                                         E& t3, E& t4) {
  add(X3, t0, t0);
  add(t0, X3, t0);
  b3(t2, t2);
  add(Z3, t1, t2);
  sub(t1, t1, t2);
  b3(Y3, Y3);
  mul(X3, t4, Y3);
  mul(t2, t3, t1);
  sub(X3, t2, X3);
  mul(Y3, Y3, t0);
  mul(t1, t1, Z3);
  add(Y3, t1, Y3);
  mul(t0, t0, t3);
  mul(Z3, Z3, t4);
  add(Z3, Z3, t0);
}

template <class E>
__device__ __forceinline__ void rcb_add(E& X3, E& Y3, E& Z3, const E& X1, const E& Y1,
                                        const E& Z1, const E& X2, const E& Y2, const E& Z2) {
  E t0, t1, t2, t3, t4;
  mul(t0, X1, X2);
  mul(t1, Y1, Y2);
  mul(t2, Z1, Z2);
  add(t3, X1, Y1);
  add(t4, X2, Y2);
  mul(t3, t3, t4);
  add(t4, t0, t1);
  sub(t3, t3, t4);
  add(t4, Y1, Z1);
  add(X3, Y2, Z2);
  mul(t4, t4, X3);
  add(X3, t1, t2);
  sub(t4, t4, X3);
  add(X3, X1, Z1);
  add(Y3, X2, Z2);
  mul(X3, X3, Y3);
  add(Y3, t0, t2);
  sub(Y3, X3, Y3);
  rcb_tail(X3, Y3, Z3, t0, t1, t2, t3, t4);
}

template <class E>
__device__ __forceinline__ void rcb_add01(E& X3, E& Y3, E& Z3, const E& X1, const E& Y1,
                                          const E& Z1, const E& X2, const E& Y2,
                                          const E& Z2) {
  const bool m1 = live(Z1);
  const bool m2 = live(Z2);
  E t0, t1, t2, t3, t4, u, v;
  mul(t0, X1, X2);
  mul(t1, Y1, Y2);
  mont_one_or_zero(t2, m1 && m2);
  add(t3, X1, Y1);
  add(t4, X2, Y2);
  mul(t3, t3, t4);
  add(t4, t0, t1);
  sub(t3, t3, t4);
  keep_or_zero(u, Y1, m2);
  keep_or_zero(v, Y2, m1);
  add(t4, u, v);  // (Y1+Z1)(Y2+Z2) - t1 - t2
  keep_or_zero(u, X1, m2);
  keep_or_zero(v, X2, m1);
  add(Y3, u, v);  // (X1+Z1)(X2+Z2) - t0 - t2
  rcb_tail(X3, Y3, Z3, t0, t1, t2, t3, t4);
}

template <class E, int K, bool LEAF>
__global__ void __launch_bounds__(128)
point_add_kernel(const int32_t* __restrict__ p, long long p_stride,
                 const int32_t* __restrict__ q, long long q_stride,
                 int32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t* pr = p + i * p_stride;
  const int32_t* qr = q + i * q_stride;
  E X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3;
  load(X1, pr);
  load(Y1, pr + K);
  load(Z1, pr + 2 * K);
  load(X2, qr);
  load(Y2, qr + K);
  load(Z2, qr + 2 * K);
  if (LEAF)
    rcb_add01(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2);
  else
    rcb_add(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2);
  int32_t* o = out + i * (3 * K);
  store(o, X3);
  store(o + K, Y3);
  store(o + 2 * K, Z3);
}

template <class E, int K, bool LEAF>
static int launch(const int32_t* p, long long ps, const int32_t* q, long long qs,
                  int32_t* out, long long n, void* stream) {
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  point_add_kernel<E, K, LEAF><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      p, ps, q, qs, out, n);
  return (int)cudaGetLastError();
}

// group: 1 (G1) or 2 (G2); leaf01: operands have Z in {0, mont-1}
extern "C" int masp_point_add(int group, int leaf01, const int32_t* p, long long p_stride,
                              const int32_t* q, long long q_stride, int32_t* out,
                              long long n, void* stream) {
  if (group == 1)
    return leaf01 ? launch<FqE, 24, true>(p, p_stride, q, q_stride, out, n, stream)
                  : launch<FqE, 24, false>(p, p_stride, q, q_stride, out, n, stream);
  if (group == 2)
    return leaf01 ? launch<Fq2E, 48, true>(p, p_stride, q, q_stride, out, n, stream)
                  : launch<Fq2E, 48, false>(p, p_stride, q, q_stride, out, n, stream);
  return (int)cudaErrorInvalidValue;
}

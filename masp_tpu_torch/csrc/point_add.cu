// Complete projective point addition on BLS12-381 G1 (over Fq) and G2 (over
// Fq2 = Fq[u]/(u^2 + 1)): Renes-Costello-Batina 2015 Algorithm 7, a = 0,
// b3 = 12 on G1 and 12(1 + u) on G2. Two kernels cover the four Pallas kernel
// bodies they replace (masp_tpu/kernels/field_kernels.py, all behind
// _g_add_callable): point_add_kernel, one thread per pair, for _g1_add_kernel
// and the leaf forms _g1_add01_kernel / _g2_add01_kernel, specialised to Z in
// {0, mont-1} (9 field products instead of 12; the identity mask is Z's limb
// 0 != 0); g2_add_kernel, a group of threads per pair, for _g2_add_kernel. The
// leaf form gives the complete formula's limbs exactly: with such Z,
// (Y1+Z1)(Y2+Z2) - t1 - t2 = Y1 Z2 + Z1 Y2 is a masked select.
//
// Points are rows of 16-bit limbs, [X | Y | Z], with K = 24 limbs per
// coordinate on G1 and K = 48 (c0 then c1) on G2. Operand rows may be
// strided (the MSM ladder pairs even and odd rows of one tensor in place);
// output rows are contiguous. The plain PyTorch version is point_add_plain in
// kernels/point_add.py.
//
// Bound: integer multiply-add throughput: a G1 add is 12 Fq products (2 * 144
// + 12 multiply-adds each), a G2 add 36, against 9 * 96 or 9 * 192 bytes of
// rows. point_add_kernel keeps the whole formula of a pair in one thread's
// registers, as the Pallas kernel keeps it in VMEM: no intermediate touches
// device memory, and pairs are independent, so no thread waits on another.
// On G2 that is 6 * 24 words of operands alone: 255 registers and spills, and
// a critical path of 36 dependent Fq products, which the narrow chains of the
// bucket reduction pay in full. g2_add_kernel splits the pair instead (see
// its section below).

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

// --- G2 complete add, a group of threads per pair -----------------------------
//
// The twelve Fq2 products of Algorithm 7 fall into two layers of six
// independent products, with linear steps before, between and after them:
//   layer 1: P_j = (A_u + A_v)(B_u + B_v) over the operands' coordinates
//            (G2_L1: X 0, Y 1, Z 2, 3 = zero);
//   linear:  O_j = P_d + s * beta(P_a - P_b - P_c) (G2_LIN: index 6 = zero,
//            s = +-1, beta = b3 when set): 3 t0, P1 -+ b3 P2, the three cross
//            terms, b3 of the X-Z cross term;
//   layer 2: Q_j = O_a * O_b (G2_L2);
//   output:  coordinate i, coefficient c = Q_a + s Q_b (G2_OUT), j = 2 i + c.
// kernels/point_add.py holds the same tables (a test checks that they agree)
// and a test runs them on host ints against the host curve. Every step is a
// fully reduced field operation, so the limbs equal point_add_kernel's.
//
// A pair gets a group of six threads; thread j of the group computes product,
// operand or output j of every step, each Fq2 product by Karatsuba (3 Fq
// products). Six won over three threads per pair at every width measured
// (PERF.md). A step's work differs per thread only in the addresses and signs
// it reads from the tables, so a warp never diverges on it. The block stages
// its pairs' rows in shared memory with 16-byte loads, packed to 32-bit
// words, and the steps exchange their Fq2 values there (24 words each), with
// a barrier between steps; the output rows go back with 16-byte stores. A
// thread holds two Fq2 operands and one product at a time instead of the
// whole formula, and the critical path is 6 dependent Fq products instead of
// 36.

__constant__ int G2_L1[6][2] = {{0, 3}, {1, 3}, {2, 3}, {0, 1}, {1, 2}, {0, 2}};
// d, s, beta, a, b, c
__constant__ int G2_LIN[6][6] = {
    {0, -1, 0, 6, 0, 0},  // t0 = 3 P0 = P0 - (0 - P0 - P0)
    {1, -1, 1, 2, 6, 6},  // t1 = P1 - b3 P2
    {1, 1, 1, 2, 6, 6},   // Z3 = P1 + b3 P2
    {6, 1, 0, 3, 0, 1},   // t3 = P3 - P0 - P1
    {6, 1, 0, 4, 1, 2},   // t4 = P4 - P1 - P2
    {6, 1, 1, 5, 0, 2},   // Y3 = b3 (P5 - P0 - P2)
};
__constant__ int G2_L2[6][2] = {{4, 5}, {3, 1}, {5, 0}, {1, 2}, {0, 3}, {2, 4}};
// a, b, s: X3 = Q1 - Q0, Y3 = Q3 + Q2, Z3 = Q5 + Q4
__constant__ int G2_OUT[3][3] = {{1, 0, -1}, {3, 2, 1}, {5, 4, 1}};

namespace g2 {
constexpr int BLOCK = 96;        // threads per block
constexpr int TPP = 6;           // threads per pair
constexpr int PAIRS = BLOCK / TPP;
constexpr int W = Fq::W;         // words per Fq
constexpr int E = 2 * W;         // words per Fq2
constexpr int CHUNKS = 3 * E / 2;  // 16-byte chunks per point row (36)
// per pair: area A (the two operand points, then the O_j, then the output
// point) and area B (the P_j, then the Q_j); odd stride against bank conflicts
constexpr int AREA_B = 6 * E;
constexpr int PAIR_WORDS = 12 * E + 1;
}  // namespace g2

__device__ __forceinline__ void lds(FqE& r, const uint32_t* s) {
#pragma unroll
  for (int j = 0; j < Fq::W; j++) r.w[j] = s[j];
}

__device__ __forceinline__ void sts(uint32_t* s, const FqE& a) {
#pragma unroll
  for (int j = 0; j < Fq::W; j++) s[j] = a.w[j];
}

// the Fq2 value at slot k of a staging area, zero when k == zero
__device__ __forceinline__ void lds2(Fq2E& r, const uint32_t* s, int k, int zero) {
  const uint32_t m = k == zero ? 0u : ~0u;
  const uint32_t* e = s + (k == zero ? 0 : k) * g2::E;
#pragma unroll
  for (int j = 0; j < Fq::W; j++) {
    r.c0.w[j] = e[j] & m;
    r.c1.w[j] = e[Fq::W + j] & m;
  }
}

__device__ __forceinline__ void sts2(uint32_t* s, const Fq2E& a) {
  sts(s, a.c0);
  sts(s + Fq::W, a.c1);
}

__device__ __forceinline__ void pick(FqE& r, const FqE& a, const FqE& b, bool m) {
#pragma unroll
  for (int j = 0; j < Fq::W; j++) r.w[j] = m ? a.w[j] : b.w[j];
}

// r = a + s b with s = +-1
__device__ __forceinline__ void add_signed(FqE& r, const FqE& a, const FqE& b, int s) {
  FqE x, y;
  fe_add(x, a, b);
  fe_sub(y, a, b);
  pick(r, y, x, s < 0);
}

__device__ __forceinline__ void add_signed(Fq2E& r, const Fq2E& a, const Fq2E& b, int s) {
  add_signed(r.c0, a.c0, b.c0, s);
  add_signed(r.c1, a.c1, b.c1, s);
}

__global__ void __launch_bounds__(g2::BLOCK)
g2_add_kernel(const int32_t* __restrict__ p, long long p_stride,
              const int32_t* __restrict__ q, long long q_stride,
              int32_t* __restrict__ out, long long n, int vec) {
  constexpr int PAIRS = g2::PAIRS;
  __shared__ uint32_t smem[PAIRS * g2::PAIR_WORDS];
  const int tid = threadIdx.x;
  const long long first = (long long)blockIdx.x * PAIRS;
  const int mine = tid / g2::TPP;  // this thread's pair in the block
  const int j = tid % g2::TPP;     // its product, operand or output
  uint32_t* A = smem + mine * g2::PAIR_WORDS;
  uint32_t* B = A + g2::AREA_B;

  // stage both operand rows of every pair as 32-bit words (pairs past n: 0)
  for (int c = tid; c < PAIRS * 2 * g2::CHUNKS; c += g2::BLOCK) {
    const int pr = c / (2 * g2::CHUNKS);
    const int which = (c / g2::CHUNKS) & 1;
    const int k = c % g2::CHUNKS;
    const long long row = first + pr;
    int4 v = make_int4(0, 0, 0, 0);
    if (row < n) {
      const int32_t* src = (which ? q + row * q_stride : p + row * p_stride) + 4 * k;
      if (vec) {
        v = __ldg(reinterpret_cast<const int4*>(src));
      } else {
        v = make_int4(__ldg(src), __ldg(src + 1), __ldg(src + 2), __ldg(src + 3));
      }
    }
    uint32_t* d = smem + pr * g2::PAIR_WORDS + which * (3 * g2::E) + 2 * k;
    d[0] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    d[1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
  __syncthreads();

  // layer 1: P_j = (A_u + A_v)(B_u + B_v) into area B
  {
    Fq2E x, y, u, v;
    lds2(x, A, G2_L1[j][0], 3);
    lds2(u, A, G2_L1[j][1], 3);
    add(x, x, u);
    lds2(y, A + 3 * g2::E, G2_L1[j][0], 3);
    lds2(v, A + 3 * g2::E, G2_L1[j][1], 3);
    add(y, y, v);
    mul(u, x, y);
    sts2(B + j * g2::E, u);
  }
  __syncthreads();

  // linear: O_j = P_d + s beta(P_a - P_b - P_c) into area A
  {
    Fq2E x, y, z;
    lds2(x, B, G2_LIN[j][3], 6);
    lds2(y, B, G2_LIN[j][4], 6);
    sub(x, x, y);
    lds2(y, B, G2_LIN[j][5], 6);
    sub(x, x, y);
    b3(y, x);
    const bool beta = G2_LIN[j][2] != 0;
    pick(x.c0, y.c0, x.c0, beta);
    pick(x.c1, y.c1, x.c1, beta);
    lds2(z, B, G2_LIN[j][0], 6);
    add_signed(y, z, x, G2_LIN[j][1]);
    sts2(A + j * g2::E, y);
  }
  __syncthreads();

  // layer 2: Q_j = O_a O_b into area B
  {
    Fq2E x, y, z;
    lds2(x, A, G2_L2[j][0], 6);
    lds2(y, A, G2_L2[j][1], 6);
    mul(z, x, y);
    sts2(B + j * g2::E, z);
  }
  __syncthreads();

  // output coefficient j = 2 i + c: Q_a + s Q_b into area A, as a point row
  {
    const int i = j >> 1, c = (j & 1) * Fq::W;
    FqE x, y, z;
    lds(x, B + G2_OUT[i][0] * g2::E + c);
    lds(y, B + G2_OUT[i][1] * g2::E + c);
    add_signed(z, x, y, G2_OUT[i][2]);
    sts(A + i * g2::E + c, z);
  }
  __syncthreads();

  // write the output rows back, 16 bytes a thread
  for (int c = tid; c < PAIRS * g2::CHUNKS; c += g2::BLOCK) {
    const int pr = c / g2::CHUNKS;
    const int k = c % g2::CHUNKS;
    const long long row = first + pr;
    if (row < n) {
      const uint32_t* s = smem + pr * g2::PAIR_WORDS + 2 * k;
      const int4 v = make_int4((int)(s[0] & 0xffffu), (int)(s[0] >> 16),
                               (int)(s[1] & 0xffffu), (int)(s[1] >> 16));
      *reinterpret_cast<int4*>(out + row * (3 * g2::E * 2) + 4 * k) = v;
    }
  }
}

static int launch_g2(const int32_t* p, long long ps, const int32_t* q, long long qs,
                     int32_t* out, long long n, void* stream) {
  constexpr int PAIRS = g2::PAIRS;
  // 16-byte loads need 16-byte aligned rows
  const int vec = ((uintptr_t)p % 16 == 0) && ((uintptr_t)q % 16 == 0) && (ps % 4 == 0) &&
                  (qs % 4 == 0);
  const long long blocks = (n + PAIRS - 1) / PAIRS;
  g2_add_kernel<<<(unsigned)blocks, g2::BLOCK, 0, (cudaStream_t)stream>>>(
      p, ps, q, qs, out, n, vec);
  return (int)cudaGetLastError();
}

// group: 1 (G1) or 2 (G2); leaf01: operands have Z in {0, mont-1}
extern "C" int masp_point_add(int group, int leaf01, const int32_t* p,
                              long long p_stride, const int32_t* q, long long q_stride,
                              int32_t* out, long long n, void* stream) {
  if (group == 1)
    return leaf01 ? launch<FqE, 24, true>(p, p_stride, q, q_stride, out, n, stream)
                  : launch<FqE, 24, false>(p, p_stride, q, q_stride, out, n, stream);
  if (group == 2 && leaf01)
    return launch<Fq2E, 48, true>(p, p_stride, q, q_stride, out, n, stream);
  if (group == 2) return launch_g2(p, p_stride, q, q_stride, out, n, stream);
  return (int)cudaErrorInvalidValue;
}

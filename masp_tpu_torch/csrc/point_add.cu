// Complete projective point addition on BLS12-381 G1 (over Fq) and G2 (over
// Fq2 = Fq[u]/(u^2 + 1)): Renes-Costello-Batina 2015 Algorithm 7, a = 0,
// b3 = 12 on G1 and 12(1 + u) on G2. Two kernels cover the four Pallas kernel
// bodies they replace (masp_tpu/kernels/field_kernels.py, all behind
// _g_add_callable): group_add_kernel, a group of six threads per pair, for
// _g1_add_kernel and _g2_add_kernel (one template over the coordinate
// field); point_add_kernel, one thread per pair, for the leaf forms
// _g1_add01_kernel / _g2_add01_kernel, specialised to Z in {0, mont-1} (9
// field products instead of 12; the identity mask is Z's limb 0 != 0). The
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
// rows. The Pallas kernels keep the whole formula of a pair in VMEM; one
// thread holding it in registers needs 184 registers on G1 and spills on G2
// (6 * 24 words of operands alone), and runs 12 or 36 dependent field
// products, which the narrow chains of the bucket reduction pay in full.
// group_add_kernel splits the pair over six threads instead (see its section
// below); the leaf forms, 9 and 3 launches per 3 proofs, keep one thread.

#include "field.cuh"

// --- the curve constant b3 and the leaf identity mask -------------------------------

__device__ __forceinline__ void times12(FqE& r, const FqE& a) {
  FqE t;
  fe_add(t, a, a);
  fe_add(t, t, a);  // 3a
  fe_add(t, t, t);  // 6a
  fe_add(r, t, t);  // 12a
}

__device__ __forceinline__ void b3(FqE& r, const FqE& a) { times12(r, a); }

// * 12(1 + u): scale by 12, then (c0 - c1) + (c0 + c1) u
__device__ __forceinline__ void b3(Fq2E& r, const Fq2E& a) {
  FqE t0, t1;
  times12(t0, a.c0);
  times12(t1, a.c1);
  fe_sub(r.c0, t0, t1);
  fe_add(r.c1, t0, t1);
}

// identity mask of a leaf operand: Z's first 16-bit limb != 0 (mont-1 has
// limb 0 = 0xfffd; on G2 it is c0's limb)
__device__ __forceinline__ bool live(const FqE& z) { return (z.w[0] & 0xffffu) != 0; }
__device__ __forceinline__ bool live(const Fq2E& z) { return live(z.c0); }

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

// the leaf forms: one thread per pair
template <class E, int K>
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
  rcb_add01(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2);
  int32_t* o = out + i * (3 * K);
  store(o, X3);
  store(o + K, Y3);
  store(o + 2 * K, Z3);
}

template <class E, int K>
static int launch_leaf(const int32_t* p, long long ps, const int32_t* q, long long qs,
                       int32_t* out, long long n, void* stream) {
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  point_add_kernel<E, K><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      p, ps, q, qs, out, n);
  return (int)cudaGetLastError();
}

// --- the complete add, a group of six threads per pair ---------------------------
//
// The twelve products of Algorithm 7 (Fq on G1, Fq2 on G2) fall into two
// layers of six independent products, with linear steps before, between and
// after them:
//   layer 1: P_j = (A_u + A_v)(B_u + B_v) over the operands' coordinates
//            (ADD_L1: X 0, Y 1, Z 2, 3 = zero);
//   linear:  O_j = P_d + s * beta(P_a - P_b - P_c) (ADD_LIN: index 6 = zero,
//            s = +-1, beta = b3 when set): 3 t0, P1 -+ b3 P2, the three cross
//            terms, b3 of the X-Z cross term;
//   layer 2: Q_j = O_a * O_b (ADD_L2);
//   output:  coordinate i (coefficient c on G2) = Q_a + s Q_b (ADD_OUT).
// The tables describe the formula, not the group: both instantiations read
// the one copy below. kernels/point_add.py holds the same tables (a test
// checks that they agree) and a test runs them on host ints against the host
// curve. Every step is a fully reduced field operation, so the limbs equal
// the plain version's.
//
// A pair gets a group of six threads; thread j of the group computes product,
// operand or output j of every step: one Fq product per layer on G1, one
// Karatsuba Fq2 product (3 Fq products) on G2. The output step has 3 Fq
// values on G1 (threads 0-2) and 6 on G2 (coefficient c of coordinate i is
// thread 2 i + c). Six won over three threads per pair at every width
// measured on G2 (PERF.md). A step's work differs per thread only in the
// addresses and signs it reads from the tables, so a warp never diverges on
// it. The block stages its pairs' rows in shared memory with 16-byte loads,
// packed to 32-bit words, and the steps exchange their values there, with a
// barrier between steps; the output rows go back with 16-byte stores. A
// thread holds two operands and one product at a time instead of the whole
// formula, and the critical path is 2 dependent products (6 Fq products on
// G2) instead of 12 (36).

__constant__ int ADD_L1[6][2] = {{0, 3}, {1, 3}, {2, 3}, {0, 1}, {1, 2}, {0, 2}};
// d, s, beta, a, b, c
__constant__ int ADD_LIN[6][6] = {
    {0, -1, 0, 6, 0, 0},  // t0 = 3 P0 = P0 - (0 - P0 - P0)
    {1, -1, 1, 2, 6, 6},  // t1 = P1 - b3 P2
    {1, 1, 1, 2, 6, 6},   // Z3 = P1 + b3 P2
    {6, 1, 0, 3, 0, 1},   // t3 = P3 - P0 - P1
    {6, 1, 0, 4, 1, 2},   // t4 = P4 - P1 - P2
    {6, 1, 1, 5, 0, 2},   // Y3 = b3 (P5 - P0 - P2)
};
__constant__ int ADD_L2[6][2] = {{4, 5}, {3, 1}, {5, 0}, {1, 2}, {0, 3}, {2, 4}};
// a, b, s: X3 = Q1 - Q0, Y3 = Q3 + Q2, Z3 = Q5 + Q4
__constant__ int ADD_OUT[3][3] = {{1, 0, -1}, {3, 2, 1}, {5, 4, 1}};

// Threads a block of the G1 instantiation (a multiple of 6). 96 and 192
// were measured (PERF.md, chip_smoke.py builds both); the G2 one keeps 96.
#ifndef MASP_G1_ADD_BLOCK
#define MASP_G1_ADD_BLOCK 96
#endif

// the staging of one pair over coordinate elements E (FqE or Fq2E)
template <class E>
struct GroupAdd {
  static constexpr int WORDS = sizeof(E) / 4;  // 32-bit words per coordinate: 12 or 24
  static constexpr int K = 2 * WORDS;          // 16-bit limbs per coordinate: 24 or 48
  static constexpr int CPE = WORDS / Fq::W;    // Fq coefficients per coordinate: 1 or 2
  static constexpr int BLOCK = CPE == 1 ? MASP_G1_ADD_BLOCK : 96;  // threads per block
  static constexpr int TPP = 6;                // threads per pair
  static constexpr int PAIRS = BLOCK / TPP;
  static constexpr int CHUNKS = 3 * K / 4;     // 16-byte chunks per point row: 18 or 36
  // per pair: area A (the two operand points, then the O_j, then the output
  // point) and area B (the P_j, then the Q_j); odd stride against bank
  // conflicts: 145 or 289 words
  static constexpr int AREA_B = 6 * WORDS;
  static constexpr int PAIR_WORDS = 12 * WORDS + 1;
  static_assert(BLOCK % TPP == 0, "a block holds whole pairs");
};

// the value at slot k of a staging area, zero when k == zero
__device__ __forceinline__ void lds_slot(FqE& r, const uint32_t* s, int k, int zero) {
  const uint32_t m = k == zero ? 0u : ~0u;
  const uint32_t* e = s + (k == zero ? 0 : k) * Fq::W;
#pragma unroll
  for (int j = 0; j < Fq::W; j++) r.w[j] = e[j] & m;
}

__device__ __forceinline__ void lds_slot(Fq2E& r, const uint32_t* s, int k, int zero) {
  const uint32_t m = k == zero ? 0u : ~0u;
  const uint32_t* e = s + (k == zero ? 0 : k) * (2 * Fq::W);
#pragma unroll
  for (int j = 0; j < Fq::W; j++) {
    r.c0.w[j] = e[j] & m;
    r.c1.w[j] = e[Fq::W + j] & m;
  }
}

// r = a + s b with s = +-1
__device__ __forceinline__ void add_signed(FqE& r, const FqE& a, const FqE& b, int s) {
  FqE x, y;
  fe_add(x, a, b);
  fe_sub(y, a, b);
  sel(r, s < 0, y, x);
}

__device__ __forceinline__ void add_signed(Fq2E& r, const Fq2E& a, const Fq2E& b, int s) {
  add_signed(r.c0, a.c0, b.c0, s);
  add_signed(r.c1, a.c1, b.c1, s);
}

template <class E>
__global__ void __launch_bounds__(GroupAdd<E>::BLOCK)
group_add_kernel(const int32_t* __restrict__ p, long long p_stride,
                 const int32_t* __restrict__ q, long long q_stride,
                 int32_t* __restrict__ out, long long n, int vec) {
  using G = GroupAdd<E>;
  constexpr int WORDS = G::WORDS;
  __shared__ uint32_t smem[G::PAIRS * G::PAIR_WORDS];
  const int tid = threadIdx.x;
  const long long first = (long long)blockIdx.x * G::PAIRS;
  const int mine = tid / G::TPP;  // this thread's pair in the block
  const int j = tid % G::TPP;     // its product, operand or output
  uint32_t* A = smem + mine * G::PAIR_WORDS;
  uint32_t* B = A + G::AREA_B;

  // stage both operand rows of every pair as 32-bit words (pairs past n: 0)
  for (int c = tid; c < G::PAIRS * 2 * G::CHUNKS; c += G::BLOCK) {
    const int pr = c / (2 * G::CHUNKS);
    const int which = (c / G::CHUNKS) & 1;
    const int k = c % G::CHUNKS;
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
    uint32_t* d = smem + pr * G::PAIR_WORDS + which * (3 * WORDS) + 2 * k;
    d[0] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    d[1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
  __syncthreads();

  // layer 1: P_j = (A_u + A_v)(B_u + B_v) into area B
  {
    E x, y, u, v;
    lds_slot(x, A, ADD_L1[j][0], 3);
    lds_slot(u, A, ADD_L1[j][1], 3);
    add(x, x, u);
    lds_slot(y, A + 3 * WORDS, ADD_L1[j][0], 3);
    lds_slot(v, A + 3 * WORDS, ADD_L1[j][1], 3);
    add(y, y, v);
    mul(u, x, y);
    sts(B + j * WORDS, u);
  }
  __syncthreads();

  // linear: O_j = P_d + s beta(P_a - P_b - P_c) into area A
  {
    E x, y, z;
    lds_slot(x, B, ADD_LIN[j][3], 6);
    lds_slot(y, B, ADD_LIN[j][4], 6);
    sub(x, x, y);
    lds_slot(y, B, ADD_LIN[j][5], 6);
    sub(x, x, y);
    b3(y, x);
    sel(x, ADD_LIN[j][2] != 0, y, x);
    lds_slot(z, B, ADD_LIN[j][0], 6);
    add_signed(y, z, x, ADD_LIN[j][1]);
    sts(A + j * WORDS, y);
  }
  __syncthreads();

  // layer 2: Q_j = O_a O_b into area B
  {
    E x, y, z;
    lds_slot(x, A, ADD_L2[j][0], 6);
    lds_slot(y, A, ADD_L2[j][1], 6);
    mul(z, x, y);
    sts(B + j * WORDS, z);
  }
  __syncthreads();

  // output Fq value j (coordinate i = j / CPE, coefficient j % CPE):
  // Q_a + s Q_b into area A, as a point row
  if (3 * G::CPE == G::TPP || j < 3 * G::CPE) {
    const int i = j / G::CPE, c = (j % G::CPE) * Fq::W;
    FqE x, y, z;
    lds(x, B + ADD_OUT[i][0] * WORDS + c);
    lds(y, B + ADD_OUT[i][1] * WORDS + c);
    add_signed(z, x, y, ADD_OUT[i][2]);
    sts(A + i * WORDS + c, z);
  }
  __syncthreads();

  // write the output rows back, 16 bytes a thread
  for (int c = tid; c < G::PAIRS * G::CHUNKS; c += G::BLOCK) {
    const int pr = c / G::CHUNKS;
    const int k = c % G::CHUNKS;
    const long long row = first + pr;
    if (row < n) {
      const uint32_t* s = smem + pr * G::PAIR_WORDS + 2 * k;
      const int4 v = make_int4((int)(s[0] & 0xffffu), (int)(s[0] >> 16),
                               (int)(s[1] & 0xffffu), (int)(s[1] >> 16));
      *reinterpret_cast<int4*>(out + row * (3 * G::K) + 4 * k) = v;
    }
  }
}

template <class E>
static int launch_group(const int32_t* p, long long ps, const int32_t* q, long long qs,
                        int32_t* out, long long n, void* stream) {
  using G = GroupAdd<E>;
  // 16-byte loads need 16-byte aligned rows
  const int vec = ((uintptr_t)p % 16 == 0) && ((uintptr_t)q % 16 == 0) && (ps % 4 == 0) &&
                  (qs % 4 == 0);
  const long long blocks = (n + G::PAIRS - 1) / G::PAIRS;
  group_add_kernel<E><<<(unsigned)blocks, G::BLOCK, 0, (cudaStream_t)stream>>>(
      p, ps, q, qs, out, n, vec);
  return (int)cudaGetLastError();
}

// group: 1 (G1) or 2 (G2); leaf01: operands have Z in {0, mont-1}
extern "C" int masp_point_add(int group, int leaf01, const int32_t* p,
                              long long p_stride, const int32_t* q, long long q_stride,
                              int32_t* out, long long n, void* stream) {
  if (group == 1)
    return leaf01 ? launch_leaf<FqE, 24>(p, p_stride, q, q_stride, out, n, stream)
                  : launch_group<FqE>(p, p_stride, q, q_stride, out, n, stream);
  if (group == 2)
    return leaf01 ? launch_leaf<Fq2E, 48>(p, p_stride, q, q_stride, out, n, stream)
                  : launch_group<Fq2E>(p, p_stride, q, q_stride, out, n, stream);
  return (int)cudaErrorInvalidValue;
}

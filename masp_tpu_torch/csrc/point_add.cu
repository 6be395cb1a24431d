// Complete projective point addition on BLS12-381 G1 (over Fq) and G2 (over
// Fq2 = Fq[u]/(u^2 + 1)): Renes-Costello-Batina 2015 Algorithm 7, a = 0,
// b3 = 12 on G1 and 12(1 + u) on G2. One kernel template,
// group_add_kernel<E, LEAF>, a group of six threads per pair, covers the four
// Pallas kernel bodies it replaces (masp_tpu/kernels/field_kernels.py, all
// behind _g_add_callable): E is the coordinate field (FqE on G1, Fq2E on G2);
// LEAF = false is the complete add (_g1_add_kernel, _g2_add_kernel), LEAF =
// true the leaf form (_g1_add01_kernel, _g2_add01_kernel), specialised to Z in
// {0, mont-1}: 9 field products instead of 12, the identity mask is Z's limb 0
// != 0. The leaf form gives the complete formula's limbs exactly: with such Z,
// Z1 Z2 is mont-1 or 0 and (Y1+Z1)(Y2+Z2) - t1 - t2 = Y1 Z2 + Z1 Y2 is a
// masked select.
//
// Points are rows of 16-bit limbs, [X | Y | Z], with K = 24 limbs per
// coordinate on G1 and K = 48 (c0 then c1) on G2. Operand rows may be
// strided (the MSM ladder pairs even and odd rows of one tensor in place);
// output rows are contiguous. The plain PyTorch version is point_add_plain in
// kernels/point_add.py.
//
// Bound: integer multiply-add throughput: a G1 add is 12 Fq products (2 * 144
// + 12 multiply-adds each), a G1 leaf 9, a G2 add 36, a G2 leaf 27, against
// 9 * 96 or 9 * 192 bytes of rows. The Pallas kernels keep the whole formula
// of a pair in VMEM; one thread holding it in registers needs 144-184
// registers on G1 and spills on G2 (6 * 24 words of operands alone), and runs
// 9-36 dependent field products. The kernel splits the pair over six threads
// instead (see its section below).

#include "field.cuh"

// --- the curve constant b3 and the leaf identity mask ------------------------

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

// identity mask of a leaf operand from its staged Z: the first 16-bit limb
// != 0 (mont-1 has limb 0 = 0xfffd; on G2 it is c0's limb), the low half of
// Z's first packed word
__device__ __forceinline__ bool live(const uint32_t* z) { return (z[0] & 0xffffu) != 0; }

// --- the adds, a group of six threads per pair -----------------------------------
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
// The leaf form (LEAF) replaces three products of layer 1 by the selects
// that Z in {0, mont-1} collapses them to: P2 = Z1 Z2 = mont-1 when both
// operands are live, else 0; P4 and P5 = keep(A_u, live B) + keep(B_u, live
// A) with u = ADD_L1[j][0], the cross terms Y1 Z2 + Z1 Y2 and X1 Z2 + Z1 X2
// themselves. Its linear step reads LEAF_LIN, which takes those two as they
// are; layer 2 and the output step are the complete add's.
// The tables describe the formula, not the group: every instantiation reads
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
// measured on G2, and on the leaf form everywhere but G1's 2^21-pair launch
// (PERF.md). A step's work differs per thread only in the addresses and
// signs it reads from the tables, so a warp never diverges on it, except in
// the leaf's layer 1: there a pair's three products and three selects (a
// few dozen instructions each select) go to threads by their place in the
// block, the products to the first half, so that only the warp across the
// middle runs both; with the six threads of every pair running both paths
// the leaf took 11% (G1) and 4-6% (G2) longer (PERF.md). The block stages
// its pairs' rows in shared memory with 16-byte loads, packed to 32-bit
// words, and the steps exchange their values there, with a barrier between
// steps; the output rows go back with 16-byte stores. A thread holds two
// operands and one product at a time instead of the whole formula, and the
// critical path is 2 dependent products (6 Fq products on G2) instead of
// 9-12 (27-36).

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
// the leaf's linear step: ADD_LIN with rows 4 and 5 on the selects
__constant__ int LEAF_LIN[6][6] = {
    {0, -1, 0, 6, 0, 0},  // t0 = 3 P0
    {1, -1, 1, 2, 6, 6},  // t1 = P1 - b3 P2
    {1, 1, 1, 2, 6, 6},   // Z3 = P1 + b3 P2
    {6, 1, 0, 3, 0, 1},   // t3 = P3 - P0 - P1
    {4, 1, 0, 6, 6, 6},   // t4 = P4
    {6, 1, 1, 5, 6, 6},   // Y3 = b3 P5
};
__constant__ int ADD_L2[6][2] = {{4, 5}, {3, 1}, {5, 0}, {1, 2}, {0, 3}, {2, 4}};
// a, b, s: X3 = Q1 - Q0, Y3 = Q3 + Q2, Z3 = Q5 + Q4
__constant__ int ADD_OUT[3][3] = {{1, 0, -1}, {3, 2, 1}, {5, 4, 1}};

template <bool LEAF>
__device__ __forceinline__ int lin(int j, int k) { return LEAF ? LEAF_LIN[j][k] : ADD_LIN[j][k]; }

// Threads a block of the G1 instantiations (a multiple of 6). 96 and 192
// were measured (PERF.md, chip_smoke.py builds both); the G2 ones keep 96.
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

template <class E, bool LEAF>
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

  // layer 1: P_j = (A_u + A_v)(B_u + B_v) into area B. The leaf form writes
  // selects for slots 2, 4 and 5, and its threads take their pair and slot by
  // their place in the block: the first 3 PAIRS threads the products of
  // slots 0, 1 and 3, the rest the selects, so that at most one warp runs
  // both paths
  {
    const int role = tid / G::PAIRS;
    const int k = !LEAF ? j : role == 2 ? 3 : role == 3 ? 2 : role;  // the slot
    uint32_t* a = LEAF ? smem + (tid % G::PAIRS) * G::PAIR_WORDS : A;
    E x, y;
    if (LEAF && role >= 3) {
      const bool live1 = live(a + 2 * WORDS), live2 = live(a + 5 * WORDS);
      if (k == 2) {
        mont_one_or_zero(x, live1 && live2);  // Z1 Z2
      } else {  // A_u Z2 + Z1 B_u
        lds_slot(x, a, ADD_L1[k][0], 3);
        keep_or_zero(x, x, live2);
        lds_slot(y, a + 3 * WORDS, ADD_L1[k][0], 3);
        keep_or_zero(y, y, live1);
        add(x, x, y);
      }
    } else {
      E u, v;
      lds_slot(u, a, ADD_L1[k][0], 3);
      lds_slot(v, a, ADD_L1[k][1], 3);
      add(u, u, v);
      lds_slot(y, a + 3 * WORDS, ADD_L1[k][0], 3);
      lds_slot(v, a + 3 * WORDS, ADD_L1[k][1], 3);
      add(y, y, v);
      mul(x, u, y);
    }
    sts(a + G::AREA_B + k * WORDS, x);
  }
  __syncthreads();

  // linear: O_j = P_d + s beta(P_a - P_b - P_c) into area A
  {
    E x, y, z;
    lds_slot(x, B, lin<LEAF>(j, 3), 6);
    lds_slot(y, B, lin<LEAF>(j, 4), 6);
    sub(x, x, y);
    lds_slot(y, B, lin<LEAF>(j, 5), 6);
    sub(x, x, y);
    b3(y, x);
    sel(x, lin<LEAF>(j, 2) != 0, y, x);
    lds_slot(z, B, lin<LEAF>(j, 0), 6);
    add_signed(y, z, x, lin<LEAF>(j, 1));
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

template <class E, bool LEAF>
static int launch_group(const int32_t* p, long long ps, const int32_t* q, long long qs,
                        int32_t* out, long long n, void* stream) {
  using G = GroupAdd<E>;
  // 16-byte loads need 16-byte aligned rows
  const int vec = ((uintptr_t)p % 16 == 0) && ((uintptr_t)q % 16 == 0) && (ps % 4 == 0) &&
                  (qs % 4 == 0);
  const long long blocks = (n + G::PAIRS - 1) / G::PAIRS;
  group_add_kernel<E, LEAF><<<(unsigned)blocks, G::BLOCK, 0, (cudaStream_t)stream>>>(
      p, ps, q, qs, out, n, vec);
  return (int)cudaGetLastError();
}

// group: 1 (G1) or 2 (G2); leaf01: operands have Z in {0, mont-1}
extern "C" int masp_point_add(int group, int leaf01, const int32_t* p,
                              long long p_stride, const int32_t* q, long long q_stride,
                              int32_t* out, long long n, void* stream) {
  if (group == 1)
    return leaf01 ? launch_group<FqE, true>(p, p_stride, q, q_stride, out, n, stream)
                  : launch_group<FqE, false>(p, p_stride, q, q_stride, out, n, stream);
  if (group == 2)
    return leaf01 ? launch_group<Fq2E, true>(p, p_stride, q, q_stride, out, n, stream)
                  : launch_group<Fq2E, false>(p, p_stride, q, q_stride, out, n, stream);
  return (int)cudaErrorInvalidValue;
}

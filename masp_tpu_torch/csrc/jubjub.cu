// Jubjub over Fr (the BLS12-381 scalar field): the complete Edwards add and
// the Pedersen fold, a group of threads per add, and the constant-time
// square root, one thread a row.
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
// of the port's tensors. Every field operation gives a fully reduced
// element, so any arrangement of one formula over canonical elements gives
// the limbs of the plain versions in kernels/jubjub.py (and of the JAX
// programs); a fold must still add its chunks in order, since another order
// gives the same point under another Z.
//
// Bounds (2 (2 W^2 + W) = 272 32-bit multiply-adds a product at W = 8): an
// add is 12 products against 3 x 192 B of rows, about 5.7 multiply-adds a
// byte, near the card's ratio (1.67e13 IMAD/s over 3.35e12 B/s); a fold
// step is 11 products (the mixed add below) against one index and one
// cached table entry; a square root 881 dependent products against two
// rows. All three are bound by operations, and at the widths the
// Jubjub path launches (an MSM's bucket chains at 1-32 pairs, a tree's
// levels at 64-32,768 hashes) by the latency of dependent products.
//
// The design against that: (1) the Fr product is fr_mul, a carry chain in
// PTX (below) instead of field.cuh's C-level CIOS fe_mul, and a square is
// fr_sqr, which forms each cross product once; the square root walks its
// exponent by 4-bit windows; (2) the add and the fold give each pair (hash)
// a group of GROUP threads of one warp that share the formula's products in
// layers of independent products, with the linear steps between them; the
// operands live in shared memory as packed 32-bit words, staged with 16-byte
// loads and written back with 16-byte stores, and the layers synchronise
// with __syncwarp only; (3) the fold's table is made for it: every entry
// has Z = 1, so each step is the mixed add (Z1 Z2 = Z1), and E = d C D is
// (X1 Y1)(d X2 Y2) with d X2 Y2 precomputed, 11 products in 3 layers; the
// block's hashes walk the chunks in step, so chunk c + 1's nine entries are
// copied into shared memory (cp.async, double-buffered) while chunk c is
// added, and every hash reads its own digits two chunks ahead, coalesced.

#include "field.cuh"

using FrE = Fe<Fr>;

constexpr int PT = 48;  // int32 limbs a packed point: X | Y | Z

// Threads a pair (hash) and threads a block of the add and the fold. 4 and
// 128 were kept after measuring 2 threads a pair and 64 and 256 threads a
// block (PERF.md; masp_tpu_torch/tools/bench_jubjub.py builds and times
// each).
#ifndef MASP_JUBJUB_GROUP
#define MASP_JUBJUB_GROUP 4
#endif
#ifndef MASP_JUBJUB_BLOCK
#define MASP_JUBJUB_BLOCK 128
#endif
constexpr int GROUP = MASP_JUBJUB_GROUP;
constexpr int BLOCK = MASP_JUBJUB_BLOCK;
static_assert(32 % GROUP == 0 && BLOCK % 32 == 0, "a group lies in one warp, a block holds whole warps");

// --- the carry-chain Fr product ---------------------------------------------------
//
// r = a b 2^-256 mod r over 8 words, operand scanning (CIOS) with the
// partial products in two accumulators: E holds the products of a's even
// words and O those of its odd words, one word higher, so that each row
// a * b_i is two unbroken mad.lo / madc.hi carry chains over 8 words, in
// flight together. The reduction uses Fr's N[0] = 1 and -N^-1 mod 2^32 =
// 2^32 - 1: m = -E0, and E0 + m N0 is 0 with a carry exactly when E0 != 0,
// so that step is one add. After a row and its reduction the value is
// E / 2^32 + O, which the next row takes as E' = O + (E's word 1) and O' =
// E's words 2 .. 8 and O's word 8, one word higher: only the add of E's
// word 1 carries, and its carry enters O' 's chain. The value stays below
// 2N < 2^256, so the final E + O fits 8 words, and one conditional
// subtraction of N reduces it. Each asm block is one chain that starts
// without a carry in, so no carry flag crosses two asm statements.
// 38 instructions a row; tests/test_torch_redesign.py holds the constants,
// and the result is the unique (ab + MN) / R reduced, fe_mul's.

constexpr uint32_t FR_W0 = 0x00000001u, FR_W1 = 0xffffffffu, FR_W2 = 0xfffe5bfeu, FR_W3 = 0x53bda402u,
                   FR_W4 = 0x09a1d805u, FR_W5 = 0x3339d808u, FR_W6 = 0x299d7d48u, FR_W7 = 0x73eda753u;

// r = t - N where t >= N, else t, for t < 2N
__device__ __forceinline__ void fr_reduce(FrE& r, const uint32_t* t) {
  uint32_t d[8], borrow;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=&r"(d[0]), "=&r"(d[1]), "=&r"(d[2]), "=&r"(d[3]), "=&r"(d[4]), "=&r"(d[5]), "=&r"(d[6]), "=&r"(d[7]),
        "=&r"(borrow)
      : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]), "r"(t[6]), "r"(t[7]), "r"(FR_W0),
        "r"(FR_W1), "r"(FR_W2), "r"(FR_W3), "r"(FR_W4), "r"(FR_W5), "r"(FR_W6), "r"(FR_W7));
#pragma unroll
  for (int j = 0; j < 8; j++) r.w[j] = borrow ? t[j] : d[j];
}

// One reduction row of fr_mul and fr_sqr on the value E + O 2^32 (9 words
// each): m = -E0; E += m N_even and O += m N_odd, and c (the carry of the
// row's regrouping, below) at position 1, where m N0's high word, 0, goes.
// E0 + m is 0 with a carry exactly when E0 != 0, and so is E0 + (2^32 - 1)
// = E0 + FR_W1: the chain adds that instead, E0 is not read again.
__device__ __forceinline__ void fr_reduce_row(uint32_t (&e)[9], uint32_t (&o)[9], uint32_t c) {
  const uint32_t m = 0u - e[0];
  asm("add.cc.u32 %0, %0, %10;\n\t"
      "addc.cc.u32 %1, %1, %11;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
      "madc.lo.cc.u32 %4, %9, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %9, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %9, %14, %6;\n\t"
      "madc.hi.cc.u32 %7, %9, %14, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]), "+r"(e[7]),
        "+r"(e[8])
      : "r"(m), "r"(FR_W1), "r"(c), "r"(FR_W2), "r"(FR_W4), "r"(FR_W6));
  asm("mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
      "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
      "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
      "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]), "+r"(o[6]), "+r"(o[7]),
        "+r"(o[8])
      : "r"(m), "r"(FR_W1), "r"(FR_W3), "r"(FR_W5), "r"(FR_W7));
}

// t = E / 2^32 + O after the last row (below 2^256: O8 is 0, the carry out none)
__device__ __forceinline__ void fr_shift_sum(uint32_t (&t)[8], const uint32_t (&e)[9], const uint32_t (&o)[9]) {
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=&r"(t[0]), "=&r"(t[1]), "=&r"(t[2]), "=&r"(t[3]), "=&r"(t[4]), "=&r"(t[5]), "=&r"(t[6]), "=&r"(t[7])
      : "r"(e[1]), "r"(e[2]), "r"(e[3]), "r"(e[4]), "r"(e[5]), "r"(e[6]), "r"(e[7]), "r"(e[8]), "r"(o[0]),
        "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]), "r"(o[6]), "r"(o[7]));
}

__device__ __forceinline__ void fr_mul(FrE& r, const FrE& x, const FrE& y) {
  const uint32_t* a = x.w;
  uint32_t e[9], o[9];
  // row 0: the products alone
#pragma unroll
  for (int k = 0; k < 4; k++) {
    e[2 * k] = a[2 * k] * y.w[0];
    e[2 * k + 1] = __umulhi(a[2 * k], y.w[0]);
    o[2 * k] = a[2 * k + 1] * y.w[0];
    o[2 * k + 1] = __umulhi(a[2 * k + 1], y.w[0]);
  }
  e[8] = 0;
  o[8] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint32_t b = y.w[i];
    if (i > 0) {
      uint32_t E0, O[9];
      // E0 = O0 + E1; O' = [E2 .. E8, O8] + a_odd b, the carry of E0 in
      asm("add.cc.u32 %0, %10, %11;\n\t"
          "madc.lo.cc.u32 %1, %12, %16, %17;\n\t"
          "madc.hi.cc.u32 %2, %12, %16, %18;\n\t"
          "madc.lo.cc.u32 %3, %13, %16, %19;\n\t"
          "madc.hi.cc.u32 %4, %13, %16, %20;\n\t"
          "madc.lo.cc.u32 %5, %14, %16, %21;\n\t"
          "madc.hi.cc.u32 %6, %14, %16, %22;\n\t"
          "madc.lo.cc.u32 %7, %15, %16, %23;\n\t"
          "madc.hi.cc.u32 %8, %15, %16, %24;\n\t"
          "addc.u32 %9, 0, 0;"
          : "=&r"(E0), "=&r"(O[0]), "=&r"(O[1]), "=&r"(O[2]), "=&r"(O[3]), "=&r"(O[4]), "=&r"(O[5]),
            "=&r"(O[6]), "=&r"(O[7]), "=&r"(O[8])
          : "r"(o[0]), "r"(e[1]), "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(b), "r"(e[2]), "r"(e[3]),
            "r"(e[4]), "r"(e[5]), "r"(e[6]), "r"(e[7]), "r"(e[8]), "r"(o[8]));
      // E' = [E0, O1 .. O7] + a_even b
      uint32_t E[9];
      E[0] = E0;
      asm("mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
          "madc.hi.cc.u32 %1, %9, %13, %14;\n\t"
          "madc.lo.cc.u32 %2, %10, %13, %15;\n\t"
          "madc.hi.cc.u32 %3, %10, %13, %16;\n\t"
          "madc.lo.cc.u32 %4, %11, %13, %17;\n\t"
          "madc.hi.cc.u32 %5, %11, %13, %18;\n\t"
          "madc.lo.cc.u32 %6, %12, %13, %19;\n\t"
          "madc.hi.cc.u32 %7, %12, %13, %20;\n\t"
          "addc.u32 %8, 0, 0;"
          : "+r"(E[0]), "=&r"(E[1]), "=&r"(E[2]), "=&r"(E[3]), "=&r"(E[4]), "=&r"(E[5]), "=&r"(E[6]),
            "=&r"(E[7]), "=&r"(E[8])
          : "r"(a[0]), "r"(a[2]), "r"(a[4]), "r"(a[6]), "r"(b), "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]),
            "r"(o[5]), "r"(o[6]), "r"(o[7]));
#pragma unroll
      for (int k = 0; k < 9; k++) {
        e[k] = E[k];
        o[k] = O[k];
      }
    }
    fr_reduce_row(e, o, 0u);
  }
  // t = E / 2^32 + O (O8 is 0: t < 2N < 2^256), then t - N where t >= N
  uint32_t t[8];
  fr_shift_sum(t, e, o);
  fr_reduce(r, t);
}

// --- the carry-chain Fr squaring --------------------------------------------------------
//
// r = a^2 2^-256 mod r, fr_mul(a, a)'s limbs with each cross product a_i a_j
// (i < j) formed once. The wide square T (16 words) first: the cross
// products of row i, a_i a_j for j > i at positions i + j, are two unbroken
// chains, j = i + 1, i + 3, ... from the odd position 2i + 1 (accumulator
// q) and j = i + 2, i + 4, ... from the even position 2i + 2 (accumulator
// p); each chain's carry enters the word above its end, which holds at most
// a carry bit of the row before (the rows below i sum to less than
// 2^(32 (i + 8) + 1) in either accumulator), so it carries no further. Then
// T = 2 (p + q) + sum a_i^2 2^(64 i). The reduction splits T = T_lo + T_hi
// 2^256: (T + M N) / R = (T_lo + M N) / R + T_hi, the first term fr_mul's
// reduction rows without the product (E starts as T_lo, O as 0), at most N,
// and T_hi < N, so the sum is below 2N and one conditional subtraction
// gives the unique reduced value, fr_mul's. Without the product chain, a
// row's regrouping carry (E0 = O0 + E1) enters the reduction chain at
// position 1. Multiply-adds: 2 (28 + 8) for T and 2 x 7 a reduction row,
// 184 against fr_mul's 240.

// acc[0 .. 2K] += b (x[0] + x[2] 2^64 + ... + x[2K - 2] 2^(64 (K - 1))), the carry into acc[2K]
template <int K>
__device__ __forceinline__ void sqr_row(uint32_t* acc, const uint32_t* x, uint32_t b);

template <>
__device__ __forceinline__ void sqr_row<1>(uint32_t* acc, const uint32_t* x, uint32_t b) {
  asm("mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
      "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
      "addc.u32 %2, %2, 0;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2])
      : "r"(x[0]), "r"(b));
}

template <>
__device__ __forceinline__ void sqr_row<2>(uint32_t* acc, const uint32_t* x, uint32_t b) {
  asm("mad.lo.cc.u32 %0, %5, %7, %0;\n\t"
      "madc.hi.cc.u32 %1, %5, %7, %1;\n\t"
      "madc.lo.cc.u32 %2, %6, %7, %2;\n\t"
      "madc.hi.cc.u32 %3, %6, %7, %3;\n\t"
      "addc.u32 %4, %4, 0;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4])
      : "r"(x[0]), "r"(x[2]), "r"(b));
}

template <>
__device__ __forceinline__ void sqr_row<3>(uint32_t* acc, const uint32_t* x, uint32_t b) {
  asm("mad.lo.cc.u32 %0, %7, %10, %0;\n\t"
      "madc.hi.cc.u32 %1, %7, %10, %1;\n\t"
      "madc.lo.cc.u32 %2, %8, %10, %2;\n\t"
      "madc.hi.cc.u32 %3, %8, %10, %3;\n\t"
      "madc.lo.cc.u32 %4, %9, %10, %4;\n\t"
      "madc.hi.cc.u32 %5, %9, %10, %5;\n\t"
      "addc.u32 %6, %6, 0;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6])
      : "r"(x[0]), "r"(x[2]), "r"(x[4]), "r"(b));
}

__device__ __forceinline__ void fr_sqr(FrE& r, const FrE& x) {
  const uint32_t* a = x.w;
  uint32_t p[16], q[16];
#pragma unroll
  for (int k = 0; k < 16; k++) p[k] = q[k] = 0;
  // row 0: the products alone, a0 a_j at j (q: j odd, p: j even)
#pragma unroll
  for (int j = 1; j < 8; j++) {
    uint32_t* acc = j & 1 ? q : p;
    acc[j] = a[0] * a[j];
    acc[j + 1] = __umulhi(a[0], a[j]);
  }
  // rows 1 .. 6: row i's chains of (8 - i) / 2 and (7 - i) / 2 products
  sqr_row<3>(q + 3, a + 2, a[1]);
  sqr_row<3>(p + 4, a + 3, a[1]);
  sqr_row<3>(q + 5, a + 3, a[2]);
  sqr_row<2>(p + 6, a + 4, a[2]);
  sqr_row<2>(q + 7, a + 4, a[3]);
  sqr_row<2>(p + 8, a + 5, a[3]);
  sqr_row<2>(q + 9, a + 5, a[4]);
  sqr_row<1>(p + 10, a + 6, a[4]);
  sqr_row<1>(q + 11, a + 6, a[5]);
  sqr_row<1>(p + 12, a + 7, a[5]);
  sqr_row<1>(q + 13, a + 7, a[6]);
  // q = p + q: the cross products' sum, below 2^509 (p holds words 2 .. 14)
  asm("add.cc.u32 %0, %0, %14;\n\t"
      "addc.cc.u32 %1, %1, %15;\n\t"
      "addc.cc.u32 %2, %2, %16;\n\t"
      "addc.cc.u32 %3, %3, %17;\n\t"
      "addc.cc.u32 %4, %4, %18;\n\t"
      "addc.cc.u32 %5, %5, %19;\n\t"
      "addc.cc.u32 %6, %6, %20;\n\t"
      "addc.cc.u32 %7, %7, %21;\n\t"
      "addc.cc.u32 %8, %8, %22;\n\t"
      "addc.cc.u32 %9, %9, %23;\n\t"
      "addc.cc.u32 %10, %10, %24;\n\t"
      "addc.cc.u32 %11, %11, %25;\n\t"
      "addc.cc.u32 %12, %12, %26;\n\t"
      "addc.u32 %13, %13, 0;"
      : "+r"(q[2]), "+r"(q[3]), "+r"(q[4]), "+r"(q[5]), "+r"(q[6]), "+r"(q[7]), "+r"(q[8]), "+r"(q[9]),
        "+r"(q[10]), "+r"(q[11]), "+r"(q[12]), "+r"(q[13]), "+r"(q[14]), "+r"(q[15])
      : "r"(p[2]), "r"(p[3]), "r"(p[4]), "r"(p[5]), "r"(p[6]), "r"(p[7]), "r"(p[8]), "r"(p[9]), "r"(p[10]),
        "r"(p[11]), "r"(p[12]), "r"(p[13]), "r"(p[14]));
  // T = 2 q + the squares a_i^2 at 2i
  uint32_t t[16];
  t[0] = a[0] * a[0];
  t[1] = q[1] << 1;
#pragma unroll
  for (int k = 2; k < 16; k++) t[k] = __funnelshift_l(q[k - 1], q[k], 1);
  asm("mad.hi.cc.u32 %0, %15, %15, %0;\n\t"
      "madc.lo.cc.u32 %1, %16, %16, %1;\n\t"
      "madc.hi.cc.u32 %2, %16, %16, %2;\n\t"
      "madc.lo.cc.u32 %3, %17, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %17, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %18, %18, %5;\n\t"
      "madc.hi.cc.u32 %6, %18, %18, %6;\n\t"
      "madc.lo.cc.u32 %7, %19, %19, %7;\n\t"
      "madc.hi.cc.u32 %8, %19, %19, %8;\n\t"
      "madc.lo.cc.u32 %9, %20, %20, %9;\n\t"
      "madc.hi.cc.u32 %10, %20, %20, %10;\n\t"
      "madc.lo.cc.u32 %11, %21, %21, %11;\n\t"
      "madc.hi.cc.u32 %12, %21, %21, %12;\n\t"
      "madc.lo.cc.u32 %13, %22, %22, %13;\n\t"
      "madc.hi.u32 %14, %22, %22, %14;"
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]),
        "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13]), "+r"(t[14]), "+r"(t[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]));
  // (T_lo + M N) / R by fr_mul's reduction rows
  uint32_t e[9], o[9];
#pragma unroll
  for (int k = 0; k < 8; k++) e[k] = t[k];
  e[8] = 0;
#pragma unroll
  for (int k = 0; k < 9; k++) o[k] = 0;
  fr_reduce_row(e, o, 0u);
#pragma unroll
  for (int i = 1; i < 8; i++) {
    // the value / 2^32: E = [O0 + E1, O1 .. O7, 0], O = [E2 .. E8, O8, 0], the carry of O0 + E1 as c
    uint32_t E0, c;
    asm("add.cc.u32 %0, %2, %3;\n\t"
        "addc.u32 %1, 0, 0;"
        : "=&r"(E0), "=r"(c)
        : "r"(o[0]), "r"(e[1]));
    uint32_t E[9], O[9];
    E[0] = E0;
#pragma unroll
    for (int k = 1; k < 8; k++) E[k] = o[k];
    E[8] = 0;
#pragma unroll
    for (int k = 0; k < 7; k++) O[k] = e[k + 2];
    O[7] = o[8];
    O[8] = 0;
#pragma unroll
    for (int k = 0; k < 9; k++) {
      e[k] = E[k];
      o[k] = O[k];
    }
    fr_reduce_row(e, o, c);
  }
  // u = E / 2^32 + O + T_hi, below 2N
  uint32_t u[8];
  fr_shift_sum(u, e, o);
  asm("add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32 %7, %7, %15;"
      : "+r"(u[0]), "+r"(u[1]), "+r"(u[2]), "+r"(u[3]), "+r"(u[4]), "+r"(u[5]), "+r"(u[6]), "+r"(u[7])
      : "r"(t[8]), "r"(t[9]), "r"(t[10]), "r"(t[11]), "r"(t[12]), "r"(t[13]), "r"(t[14]), "r"(t[15]));
  fr_reduce(r, u);
}

// r = a + s b, s = -1 where neg, over canonical elements: a + b, or a + (N - b)
// (a + N for b = 0), below 2N either way, then reduced. Two carry chains
// and a select each way, with no branch on the sign.
__device__ __forceinline__ void fr_add_signed(FrE& r, const FrE& a, const FrE& b, bool neg) {
  uint32_t nb[8], t[8];
  asm("sub.cc.u32 %0, %8, %16;\n\t"
      "subc.cc.u32 %1, %9, %17;\n\t"
      "subc.cc.u32 %2, %10, %18;\n\t"
      "subc.cc.u32 %3, %11, %19;\n\t"
      "subc.cc.u32 %4, %12, %20;\n\t"
      "subc.cc.u32 %5, %13, %21;\n\t"
      "subc.cc.u32 %6, %14, %22;\n\t"
      "subc.u32 %7, %15, %23;"
      : "=&r"(nb[0]), "=&r"(nb[1]), "=&r"(nb[2]), "=&r"(nb[3]), "=&r"(nb[4]), "=&r"(nb[5]), "=&r"(nb[6]),
        "=&r"(nb[7])
      : "r"(FR_W0), "r"(FR_W1), "r"(FR_W2), "r"(FR_W3), "r"(FR_W4), "r"(FR_W5), "r"(FR_W6), "r"(FR_W7),
        "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]), "r"(b.w[7]));
#pragma unroll
  for (int j = 0; j < 8; j++) nb[j] = neg ? nb[j] : b.w[j];
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=&r"(t[0]), "=&r"(t[1]), "=&r"(t[2]), "=&r"(t[3]), "=&r"(t[4]), "=&r"(t[5]), "=&r"(t[6]), "=&r"(t[7])
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]),
        "r"(nb[0]), "r"(nb[1]), "r"(nb[2]), "r"(nb[3]), "r"(nb[4]), "r"(nb[5]), "r"(nb[6]), "r"(nb[7]));
  fr_reduce(r, t);
}

// --- the layered adds ---------------------------------------------------------------
//
// A pair's formula is a list of layers over slots: elements of 8 packed
// words. Slots below NS lie in the pair's area of shared memory; slot NS
// and up are read-only elements outside it (the add: the curve's d, one copy
// a warp; the fold: the staged table entry's X2, Y2, X2 + Y2, d X2 Y2).
// A product layer's rows are (out, a, b): out = a b. A linear layer's rows
// are (out, x, s, y, z): out = x + s (y + z), s = +-1, z = NONE for none.
// Thread t of the group takes rows t, t + GROUP, ... of each layer; the rows
// of a layer are independent (none reads a slot that the layer writes), and a
// __syncwarp separates the layers. kernels/jubjub.py holds the same tables
// (a test checks that they agree, and runs them on host ints against the
// host curve and the plain version).
constexpr int NONE = 31;

// the complete add, add-2008-bbjlp with a = -1 (jubjub_jax.py:109-119):
// slots X1 0, Y1 1, Z1 2, X2 3, Y2 4, Z2 5, 6-11 free, d 12. Depth 4:
// E = d C D needs three products in a row, Z3 = F G one more; X3 = (A H) F
// and Y3 = (A S) G take A H and A S from the second layer.
constexpr int ADD_NS = 12;
__constant__ int ADD_LIN0[2][5] = {
    {6, 0, 1, 1, NONE},   // X1 + Y1
    {7, 3, 1, 4, NONE}};  // X2 + Y2
__constant__ int ADD_L1[4][3] = {
    {8, 2, 5},    // A = Z1 Z2
    {9, 0, 3},    // C = X1 X2
    {10, 1, 4},   // D = Y1 Y2
    {11, 6, 7}};  // H' = (X1 + Y1)(X2 + Y2)
__constant__ int ADD_LIN1[2][5] = {
    {0, 9, 1, 10, NONE},  // S = C + D
    {1, 11, -1, 9, 10}};  // H = H' - (C + D)
__constant__ int ADD_L2[4][3] = {
    {2, 8, 8},   // B = A^2
    {3, 9, 10},  // C D
    {4, 8, 1},   // A H
    {5, 8, 0}};  // A S
__constant__ int ADD_L3[1][3] = {
    {6, 12, 3}};  // E = d (C D)
__constant__ int ADD_LIN2[2][5] = {
    {7, 2, -1, 6, NONE},  // F = B - E
    {8, 2, 1, 6, NONE}};  // G = B + E
__constant__ int ADD_L4[3][3] = {
    {9, 4, 7},    // X3 = (A H) F
    {10, 5, 8},   // Y3 = (A S) G
    {11, 7, 8}};  // Z3 = F G
constexpr int ADD_OUT = 9;  // X3 | Y3 | Z3 in slots 9, 10, 11

// the fold's step, the mixed add (Z2 = 1): slots X1 0, Y1 1, Z1 2 (the
// accumulator), 3-12 free; the entry's X2 13, Y2 14, X2 + Y2 15, d X2 Y2 16.
// A = Z1 Z2 = Z1 exactly, and E = (X1 Y1)(d X2 Y2): 11 products, depth 3.
constexpr int FOLD_NS = 13;
__constant__ int FOLD_LIN0[1][5] = {
    {3, 0, 1, 1, NONE}};  // X1 + Y1
__constant__ int FOLD_L1[4][3] = {
    {4, 0, 13},  // C = X1 X2
    {5, 1, 14},  // D = Y1 Y2
    {6, 3, 15},  // H' = (X1 + Y1)(X2 + Y2)
    {7, 0, 1}};  // P = X1 Y1
__constant__ int FOLD_LIN1[2][5] = {
    {3, 4, 1, 5, NONE},  // S = C + D
    {8, 6, -1, 4, 5}};   // H = H' - (C + D)
__constant__ int FOLD_L2[4][3] = {
    {9, 2, 2},    // B = Z1^2
    {10, 7, 16},  // E = P (d X2 Y2)
    {11, 2, 8},   // Z1 H
    {12, 2, 3}};  // Z1 S
__constant__ int FOLD_LIN2[2][5] = {
    {4, 9, -1, 10, NONE},  // F = B - E
    {5, 9, 1, 10, NONE}};  // G = B + E
__constant__ int FOLD_L3[3][3] = {
    {0, 11, 4},  // X3 = (Z1 H) F
    {1, 12, 5},  // Y3 = (Z1 S) G
    {2, 4, 5}};  // Z3 = F G

// an element at a 16-byte aligned address, as two 16-byte accesses
__device__ __forceinline__ void lds8(FrE& r, const uint32_t* s) {
  const uint4 lo = reinterpret_cast<const uint4*>(s)[0], hi = reinterpret_cast<const uint4*>(s)[1];
  r.w[0] = lo.x, r.w[1] = lo.y, r.w[2] = lo.z, r.w[3] = lo.w;
  r.w[4] = hi.x, r.w[5] = hi.y, r.w[6] = hi.z, r.w[7] = hi.w;
}

__device__ __forceinline__ void sts8(uint32_t* s, const FrE& a) {
  reinterpret_cast<uint4*>(s)[0] = make_uint4(a.w[0], a.w[1], a.w[2], a.w[3]);
  reinterpret_cast<uint4*>(s)[1] = make_uint4(a.w[4], a.w[5], a.w[6], a.w[7]);
}

template <int NS>
__device__ __forceinline__ const uint32_t* slot(const uint32_t* area, const uint32_t* ext, int k) {
  return k < NS ? area + 8 * k : ext + 8 * (k - NS);
}

// thread t's rows of a layer of ROWS rows of W entries (rows t, t + GROUP,
// ...), read from the table once, before the work, so that no layer waits
// on a constant-memory load
template <int ROWS, int W>
struct Rows {
  static constexpr int R = (ROWS + GROUP - 1) / GROUP;
  int v[R][W];
  bool on[R];
  __device__ __forceinline__ Rows(const int (*table)[W], int t) {
#pragma unroll
    for (int r = 0; r < R; r++) {
      const int i = r * GROUP + t;
      on[r] = ROWS % GROUP == 0 || i < ROWS;
#pragma unroll
      for (int k = 0; k < W; k++) v[r][k] = on[r] ? table[i][k] : 0;
    }
  }
};

template <int NS, int ROWS>
__device__ __forceinline__ void mul_layer(const Rows<ROWS, 3>& rows, uint32_t* area, const uint32_t* ext) {
#pragma unroll
  for (int r = 0; r < Rows<ROWS, 3>::R; r++) {
    if (rows.on[r]) {
      FrE x, y, z;
      lds8(x, slot<NS>(area, ext, rows.v[r][1]));
      lds8(y, slot<NS>(area, ext, rows.v[r][2]));
      fr_mul(z, x, y);
      sts8(area + 8 * rows.v[r][0], z);
    }
  }
}

template <int NS, int ROWS>
__device__ __forceinline__ void lin_layer(const Rows<ROWS, 5>& rows, uint32_t* area, const uint32_t* ext) {
#pragma unroll
  for (int r = 0; r < Rows<ROWS, 5>::R; r++) {
    if (rows.on[r]) {
      FrE x, y, z;
      lds8(y, slot<NS>(area, ext, rows.v[r][3]));
      if (rows.v[r][4] != NONE) {
        lds8(z, slot<NS>(area, ext, rows.v[r][4]));
        fr_add_signed(y, y, z, false);
      }
      lds8(x, slot<NS>(area, ext, rows.v[r][1]));
      fr_add_signed(z, x, y, rows.v[r][2] < 0);
      sts8(area + 8 * rows.v[r][0], z);
    }
  }
}

// 16-bit limbs (4 of a 16-byte chunk) <-> 2 packed words
__device__ __forceinline__ void pack_chunk(uint32_t* d, int4 v) {
  d[0] = (uint32_t)v.x | ((uint32_t)v.y << 16);
  d[1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
}

__device__ __forceinline__ int4 unpack_chunk(const uint32_t* s) {
  return make_int4((int)(s[0] & 0xffffu), (int)(s[0] >> 16), (int)(s[1] & 0xffffu), (int)(s[1] >> 16));
}

constexpr int ROW_CHUNKS = PT / 4;  // 16-byte chunks a point row: 12
constexpr int PAIRS_PER_WARP = 32 / GROUP;
constexpr int WARPS = BLOCK / 32;
// words a pair: 16-byte slots, and 4 words more so that neighbouring pairs'
// slots start 4 banks apart
constexpr int ADD_AREA = 8 * ADD_NS + 4;
constexpr int ADD_WARP_WORDS = PAIRS_PER_WARP * ADD_AREA + 8;  // the warp's pairs and its copy of d
constexpr int STAGED = PAIRS_PER_WARP * 2 * ROW_CHUNKS / 32;  // 16-byte loads a lane
static_assert(PAIRS_PER_WARP * 2 * ROW_CHUNKS % 32 == 0, "a warp's operand rows split evenly over its lanes");

// the 16-byte chunk j of a lane's share of its warp's operand rows: chunk c
// = lane + 32 j is chunk c % 12 of pair c / 24's first (p) or second (q) row
__device__ __forceinline__ const int32_t* stage_src(const int32_t* p, long long sp, const int32_t* q, long long sq,
                                                    long long n, long long first, int lane, int j) {
  const int c = lane + 32 * j, pr = c / (2 * ROW_CHUNKS), which = (c / ROW_CHUNKS) & 1, k = c % ROW_CHUNKS;
  const long long row = min(first + pr, n - 1);
  return (which ? q + row * sq : p + row * sp) + 4 * k;
}

// out[i] = p[i] + q[i]; row i of p starts at p + i * sp (int32), of q at
// q + i * sq; out is contiguous. Each warp stages, adds and writes back its
// own PAIRS_PER_WARP pairs; vec: both operands' rows are 16-byte aligned.
__global__ void __launch_bounds__(BLOCK)
jubjub_add_kernel(const int32_t* __restrict__ p, long long sp, const int32_t* __restrict__ q, long long sq,
                  int32_t* __restrict__ out, long long n, const int32_t* __restrict__ dconst, int vec) {
  __shared__ __align__(16) uint32_t smem[WARPS * ADD_WARP_WORDS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % GROUP;
  const Rows<2, 5> lin0(ADD_LIN0, t), lin1(ADD_LIN1, t), lin2(ADD_LIN2, t);
  const Rows<4, 3> l1(ADD_L1, t), l2(ADD_L2, t);
  const Rows<1, 3> l3(ADD_L3, t);
  const Rows<3, 3> l4(ADD_L4, t);
  const long long first = ((long long)blockIdx.x * WARPS + warp) * PAIRS_PER_WARP;
  if (first >= n) return;  // the whole warp
  uint32_t* W = smem + warp * ADD_WARP_WORDS;
  uint32_t* dsm = W + PAIRS_PER_WARP * ADD_AREA;
  const int d_lo = lane < 8 ? __ldg(dconst + 2 * lane) : 0, d_hi = lane < 8 ? __ldg(dconst + 2 * lane + 1) : 0;
  // the curve's d, and both operand rows of every pair into slots 0-2 and
  // 3-5: every load of a lane in one straight run (rows past n read the last
  // row; those pairs are not written back), the 16-byte or the 4-byte form
  // chosen once for the warp
  int4 v[STAGED];
  if (vec) {
#pragma unroll
    for (int j = 0; j < STAGED; j++)
      v[j] = __ldg(reinterpret_cast<const int4*>(stage_src(p, sp, q, sq, n, first, lane, j)));
  } else {
#pragma unroll
    for (int j = 0; j < STAGED; j++) {
      const int32_t* src = stage_src(p, sp, q, sq, n, first, lane, j);
      v[j] = make_int4(__ldg(src), __ldg(src + 1), __ldg(src + 2), __ldg(src + 3));
    }
  }
  if (lane < 8) dsm[lane] = (uint32_t)d_lo | ((uint32_t)d_hi << 16);
#pragma unroll
  for (int j = 0; j < STAGED; j++) {
    const int c = lane + 32 * j, pr = c / (2 * ROW_CHUNKS), which = (c / ROW_CHUNKS) & 1, k = c % ROW_CHUNKS;
    pack_chunk(W + pr * ADD_AREA + which * 24 + 2 * k, v[j]);
  }
  __syncwarp();
  uint32_t* area = W + (lane / GROUP) * ADD_AREA;
  lin_layer<ADD_NS>(lin0, area, dsm);
  __syncwarp();
  mul_layer<ADD_NS>(l1, area, dsm);
  __syncwarp();
  lin_layer<ADD_NS>(lin1, area, dsm);
  __syncwarp();
  mul_layer<ADD_NS>(l2, area, dsm);
  __syncwarp();
  mul_layer<ADD_NS>(l3, area, dsm);
  __syncwarp();
  lin_layer<ADD_NS>(lin2, area, dsm);
  __syncwarp();
  mul_layer<ADD_NS>(l4, area, dsm);
  __syncwarp();
  for (int c = lane; c < PAIRS_PER_WARP * ROW_CHUNKS; c += 32) {
    const int pr = c / ROW_CHUNKS, k = c % ROW_CHUNKS;
    const long long row = first + pr;
    if (row < n)
      *reinterpret_cast<int4*>(out + row * PT + 4 * k) = unpack_chunk(W + pr * ADD_AREA + 8 * ADD_OUT + 2 * k);
  }
}

// --- the fold ---------------------------------------------------------------------------

constexpr int ENTRY = 32;               // words of a fold-table entry: X2 | Y2 | X2 + Y2 | d X2 Y2
constexpr int CHUNK_WORDS = 9 * ENTRY;  // a chunk's nine entries: 1,152 bytes
constexpr int HASHES = BLOCK / GROUP;   // hashes a block
constexpr int FOLD_AREA = 8 * FOLD_NS + 4;  // as ADD_AREA

__device__ __forceinline__ void cp_async16(uint32_t* smem, const uint32_t* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

// chunk c's nine entries into buf, one 16-byte copy a thread, one group
__device__ __forceinline__ void stage_chunk(uint32_t* buf, const uint32_t* __restrict__ table, long long c) {
  for (int i = threadIdx.x; i < CHUNK_WORDS / 4; i += BLOCK) cp_async16(buf + 4 * i, table + c * CHUNK_WORDS + 4 * i);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// out[n] = sum over c = 0 .. C-1, in that order, of the point of entry
// idx[c][n] of chunk c, from the identity (0 : 1 : 1): the serial fold of
// pedersen_jax.py:96-100, so the projective limbs are the JAX fori_loop's.
// table: (C, 9, 32) words, kernels/jubjub.fold_table's layout of the
// (C, 9, 48) affine table; idx: (C, N) digit + 4, in 0 .. 8.
__global__ void __launch_bounds__(BLOCK)
pedersen_fold_kernel(const uint32_t* __restrict__ table, const int32_t* __restrict__ idx,
                     int32_t* __restrict__ out, long long C, long long N) {
  __shared__ __align__(16) uint32_t smem[HASHES * FOLD_AREA];
  __shared__ __align__(16) uint32_t tab[2][CHUNK_WORDS];
  const int mine = threadIdx.x / GROUP, t = threadIdx.x % GROUP;
  const Rows<1, 5> lin0(FOLD_LIN0, t);
  const Rows<2, 5> lin1(FOLD_LIN1, t), lin2(FOLD_LIN2, t);
  const Rows<4, 3> l1(FOLD_L1, t), l2(FOLD_L2, t);
  const Rows<3, 3> l3(FOLD_L3, t);
  const long long h = (long long)blockIdx.x * HASHES + mine;
  const bool live = h < N;
  uint32_t* area = smem + mine * FOLD_AREA;
  for (int w = t; w < 24; w += GROUP) area[w] = w < 8 ? 0u : Fr::one(w % 8);
  // each hash's digits two chunks ahead (4, the identity entry, past N)
  int next = 4, after = 4;
  if (C > 0) stage_chunk(tab[0], table, 0);
  if (live && C > 0) next = __ldg(idx + h);
  if (live && C > 1) after = __ldg(idx + N + h);
  for (long long c = 0; c < C; c++) {
    const int k = next;
    next = after;
    if (live && c + 2 < C) after = __ldg(idx + (c + 2) * N + h);
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();  // chunk c is in; every thread is past step c - 1, so its buffer is free
    if (c + 1 < C) stage_chunk(tab[(c + 1) & 1], table, c + 1);
    const uint32_t* entry = tab[c & 1] + k * ENTRY;
    lin_layer<FOLD_NS>(lin0, area, entry);
    __syncwarp();
    mul_layer<FOLD_NS>(l1, area, entry);
    __syncwarp();
    lin_layer<FOLD_NS>(lin1, area, entry);
    __syncwarp();
    mul_layer<FOLD_NS>(l2, area, entry);
    __syncwarp();
    lin_layer<FOLD_NS>(lin2, area, entry);
    __syncwarp();
    mul_layer<FOLD_NS>(l3, area, entry);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < HASHES * ROW_CHUNKS; c += BLOCK) {
    const int pr = c / ROW_CHUNKS, k = c % ROW_CHUNKS;
    const long long row = (long long)blockIdx.x * HASHES + pr;
    if (row < N) *reinterpret_cast<int4*>(out + row * PT + 4 * k) = unpack_chunk(smem + pr * FOLD_AREA + 2 * k);
  }
}

// --- the square root ----------------------------------------------------------------------

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

// w = a^((t - 1) / 2) by fixed 4-bit windows, most significant first: w
// starts as a^d0, then each digit d takes four squarings and, where d != 0, a
// product by a^d from a table of a^1 .. a^15 (kernels/jubjub.py's
// SQRT_DIGITS; a test holds the two equal). The exponent is a constant, so
// skipping the zero digits leaks nothing. 14 products for the table, 220
// squarings and 50 products: 284, against 354 bit by bit.
constexpr int SQRT_WINDOW = 4;
constexpr int SQRT_NDIGITS = 56;
constexpr int SQRT_TABLE = (1 << SQRT_WINDOW) - 1;
__constant__ int SQRT_DIGITS[SQRT_NDIGITS] = {
    3, 9, 15, 6, 13, 3, 10, 9, 9, 4, 12, 14, 11, 14, 10, 4, 1, 9, 9, 12, 14, 12, 0, 4, 0, 4, 13, 0,
    14, 12, 0, 2, 10, 9, 13, 14, 13, 2, 0, 1, 7, 15, 15, 15, 2, 13, 15, 15, 7, 15, 15, 15, 15, 15,
    15, 15};

// Threads a block, one a row: 32 and 64 measured the same as 128 (PERF.md).
// A group of 2 or 4 threads a row that shared each product by shuffles
// (CGBN's threads per instance) was 4-7x slower and is gone.
constexpr int SQRT_BLOCK = 128;
// the table in shared memory, word j of a^k at (8 (k - 1) + j) SQRT_BLOCK + thread:
// neighbouring threads on neighbouring banks
constexpr int SQRT_SMEM = SQRT_TABLE * 8 * 4 * SQRT_BLOCK;

__device__ __forceinline__ void tab_put(uint32_t* tab, int k, const FrE& v) {
#pragma unroll
  for (int j = 0; j < 8; j++) tab[(8 * (k - 1) + j) * SQRT_BLOCK] = v.w[j];
}

__device__ __forceinline__ void tab_get(FrE& v, const uint32_t* tab, int k) {
#pragma unroll
  for (int j = 0; j < 8; j++) v.w[j] = tab[(8 * (k - 1) + j) * SQRT_BLOCK];
}

// The ff crate's constant-time Tonelli-Shanks (sqrt_tonelli_shanks) over
// Fr, with 2^S | r - 1: w = a^((t - 1) / 2) (the window walk above; the JAX
// program and the plain version walk the exponent's bits to the same w), x =
// a w, b = x w, z = the 2^S-th root of unity, then for max_v = S .. 1 the
// inner steps j = 2 .. max_v - 1 and one boundary step: the step stream of
// jubjub_jax.py:203-217, every branch a select. ok = (x^2 == a); the root
// is some square root of a where one exists, 0 for 0. One thread a row, its
// state in registers, the window's table in shared memory. Of its 881
// dependent products 752 are squarings (fr_sqr), the rest fr_mul: the
// kernel is paced by the latency of one row's chain of products (PERF.md),
// which both shorten against fe_mul.
__global__ void __launch_bounds__(SQRT_BLOCK)
fr_sqrt_kernel(const int32_t* __restrict__ a_in, int32_t* __restrict__ root, int32_t* __restrict__ ok,
               long long n, const int32_t* __restrict__ zconst, int S) {
  extern __shared__ uint32_t sqrt_table[];
  const long long i = (long long)blockIdx.x * SQRT_BLOCK + threadIdx.x;
  if (i >= n) return;
  uint32_t* tab = sqrt_table + threadIdx.x;
  FrE a, one, w, x, b, z, tmp, sq, t;
  load(a, a_in + i * 16);
  fr_one(one);
  tab_put(tab, 1, a);
  fr_sqr(t, a);
  tab_put(tab, 2, t);
#pragma unroll 1
  for (int k = 3; k <= SQRT_TABLE; k++) {
    fr_mul(t, t, a);
    tab_put(tab, k, t);
  }
  tab_get(w, tab, SQRT_DIGITS[0]);
#pragma unroll 1
  for (int d = 1; d < SQRT_NDIGITS; d++) {
#pragma unroll
    for (int s = 0; s < SQRT_WINDOW; s++) fr_sqr(w, w);
    const int k = SQRT_DIGITS[d];
    if (k) {
      tab_get(t, tab, k);
      fr_mul(w, w, t);
    }
  }
  fr_mul(x, a, w);
  fr_mul(b, x, w);
  load(z, zconst);
  int v = S, k = 1;
  bool jltv = true;
  fr_sqr(tmp, b);
  for (int max_v = S; max_v >= 1; max_v--) {
    for (int j = 2; j < max_v; j++) {
      // inner step
      const bool tmp_is_one = fr_eq(tmp, one);
      fr_sel(t, tmp_is_one, z, tmp);
      fr_sqr(sq, t);
      const bool jltv_i = jltv && j != v;
      k = tmp_is_one ? k : j;
      // new_z = tmp_is_one ? sq : z, kept where jltv_i
      fr_sel(z, jltv_i && tmp_is_one, sq, z);
      fr_sel(tmp, tmp_is_one, tmp, sq);
      jltv = jltv_i;
    }
    // boundary step: x, z, b, v, then the next run's k, tmp, jltv
    const bool b_is_one = fr_eq(b, one);
    fr_mul(t, x, z);
    fr_sel(x, b_is_one, x, t);
    fr_sqr(z, z);
    fr_mul(b, b, z);
    v = k;
    k = 1;
    fr_sqr(tmp, b);
    jltv = true;
  }
  fr_sqr(sq, x);
  store(root + i * 16, x);
  ok[i] = fr_eq(sq, a) ? 1 : 0;
}

#ifdef MASP_JUBJUB_PROBE
// A measurement build's kernels (chip_smoke.py counts their SASS): one Fr
// product a thread, the carry-chain fr_mul and fr_sqr and field.cuh's
// fe_mul<Fr>, each between the same loads and stores. Never launched.
__global__ void probe_fr_mul(const uint32_t* __restrict__ in, uint32_t* __restrict__ out) {
  FrE a, b, r;
  lds8(a, in + 16 * threadIdx.x);
  lds8(b, in + 16 * threadIdx.x + 8);
  fr_mul(r, a, b);
  sts8(out + 8 * threadIdx.x, r);
}

__global__ void probe_fr_sqr(const uint32_t* __restrict__ in, uint32_t* __restrict__ out) {
  FrE a, r;
  lds8(a, in + 16 * threadIdx.x);
  fr_sqr(r, a);
  sts8(out + 8 * threadIdx.x, r);
}

__global__ void probe_fe_mul(const uint32_t* __restrict__ in, uint32_t* __restrict__ out) {
  FrE a, b, r;
  lds8(a, in + 16 * threadIdx.x);
  lds8(b, in + 16 * threadIdx.x + 8);
  fe_mul(r, a, b);
  sts8(out + 8 * threadIdx.x, r);
}
#endif

static int check_launch(long long n) {
  return n <= 0 || n >= (1ll << 31) ? (int)cudaErrorInvalidValue : 0;
}

// p, q: n packed rows at row strides sp, sq (int32); out: n contiguous rows;
// d: the Montgomery limbs of the curve's d
extern "C" int masp_jubjub_add(const int32_t* p, long long sp, const int32_t* q, long long sq, int32_t* out,
                               long long n, const int32_t* d, void* stream) {
  if (int err = check_launch(n)) return err;
  // 16-byte loads need 16-byte aligned rows
  const int vec = ((uintptr_t)p % 16 == 0) && ((uintptr_t)q % 16 == 0) && (sp % 4 == 0) && (sq % 4 == 0);
  const long long pairs = BLOCK / GROUP;
  jubjub_add_kernel<<<(unsigned)((n + pairs - 1) / pairs), BLOCK, 0, (cudaStream_t)stream>>>(p, sp, q, sq, out, n,
                                                                                            d, vec);
  return (int)cudaGetLastError();
}

// table: (C, 9, 32) words in kernels/jubjub.fold_table's layout, 16-byte
// aligned; idx: (C, N) contiguous; out: (N, 48)
extern "C" int masp_pedersen_fold(const int32_t* table, const int32_t* idx, int32_t* out, long long C, long long N,
                                  void* stream) {
  if (int err = check_launch(N)) return err;
  if (C < 0 || (uintptr_t)table % 16 != 0) return (int)cudaErrorInvalidValue;
  pedersen_fold_kernel<<<(unsigned)((N + HASHES - 1) / HASHES), BLOCK, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const uint32_t*>(table), idx, out, C, N);
  return (int)cudaGetLastError();
}

// a, root: n contiguous rows of 16 limbs; ok: n int32; z: the root of
// unity's 16 limbs; S: the 2-adicity of r - 1
extern "C" int masp_fr_sqrt(const int32_t* a, int32_t* root, int32_t* ok, long long n, const int32_t* z, int S,
                            void* stream) {
  static bool smem_set = false;  // set on the first launch, before any graph capture
  if (int err = check_launch(n)) return err;
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(fr_sqrt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SQRT_SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const unsigned blocks = (unsigned)((n + SQRT_BLOCK - 1) / SQRT_BLOCK);
  fr_sqrt_kernel<<<blocks, SQRT_BLOCK, SQRT_SMEM, (cudaStream_t)stream>>>(a, root, ok, n, z, S);
  return (int)cudaGetLastError();
}

// Batched Fq Montgomery product a * b * R^-1 mod q (R = 2^384) with both
// reductions on the tensor cores.
//
// Replaces the Pallas kernel _mont_mxu_kernel (tools/exp_mxu_mont.py:191) and
// its row function rows_mont_mul_mxu (:99): the schoolbook T = a b stays on
// the integer units (both operands vary), while the two products by fixed
// constants, m = T_lo N' mod 2^384 and m N, are linear maps over bytes, i.e.
// constant-matrix products over the batch:
//   m_lazy (48 x B) = A1 (48 x 48) . t8 (48 x B),  A1[k][i] = N'_8[k - i], i <= k
//   mn_lazy (96 x B) = A2 (96 x 48) . m8 (48 x B), A2[k][i] = N_8[k - i], 0 <= k - i < 48
// with t8 and m8 the 48 bytes of T_lo and m. The TPU's matrix unit took only
// signed int8, so the reference recentres the bytes and corrects with a band
// matrix and a constant; Hopper's IMMA takes u8 x u8 -> s32, so this kernel
// multiplies the plain bytes: the lazy columns are the same integers (each
// < 48 * 255^2 < 2^22). The fragment tables of A1 and A2 come from the wrapper
// (kernels/mont_mul_mxu.py), built from the reference's own matrices. Rows
// are (n, 24) int32 16-bit limbs as in mont_mul.cu; the plain PyTorch version
// is mont_mul_mxu_plain.
//
// Exactness: as in the reference, the carry out of the top chain is dropped,
// so the limbs equal mont_mul's for inputs below q (then (T + m q) / R < 2q).
//
// Bound: 3 x 96 B per element of int32 rows against 2 W^2 = 288 integer
// multiply-adds of the product phase (W = 12 words): bytes. Measured
// (PERF.md), the first form ran at 24% of it, each lane loading and storing
// its own row limb by limb at a 96-byte stride. So a warp owns 32 elements,
// one a lane:
// 1. it stages its 32 rows of a and b in shared memory with 16-byte loads on
//    consecutive chunks (field.cuh's load_chunks, as mont_mul_kernel<F>);
// 2. each lane forms T = a b (24 words) with PTX carry chains, a's even and
//    odd words in two accumulators as jubjub.cu's fr_mul, and writes T_lo as
//    column `lane` of a 48 x 32 byte matrix;
// 3. the warp runs the constant-matrix products with mma.sync m16n8k32 u8,
//    the A fragments from shared memory (copied once a block), the B
//    fragments straight from the staged words, the 48-byte depth zero-padded
//    to 64 and the all-zero 16 x 32 blocks of the band skipped (4 of A1's 6,
//    9 of A2's 12 are left), the int32 lazy columns into shared memory, 48
//    rows a pass (A1 one pass, A2 two);
// 4. each lane normalises its own column a 32-bit word at a time, v0 + (v1
//    << 8) + (v2 << 16) + (v3 << 24) and the carry in 64 bits: m's 12 words
//    as the B operand of A2, then (T + m N) >> 384 with the subtraction in
//    registers;
// 5. the results go back through the staging area with 16-byte stores.
// The staging area lies inside the lazy columns' area, which it is done with
// before the first product: 8 KB a warp, and the block's fragment tables.
// Measured (PERF.md): 47% of the byte bound at 2^17 rows, 2x the first form;
// one 32-row tile takes about 6 us in a CUDA graph (mont_mul_fq's 3.7), and
// that latency, not the loads' overlap, sets the pace: persistent warps that
// prefetched their next tile with cp.async measured the same.

#include "field.cuh"

namespace {

// Warps a block, each of 32 rows: 8 was the fastest of 1, 2, 4, 8 and 16
// (PERF.md).
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TW = 12;   // 32-bit words of a 48-byte operand column
constexpr int LZ = 52;   // int32 stride of a lane's lazy column: 48 rows a pass; 52 = 4 mod 16, conflict-free
using SQ = Staging<Fq>;

// the Toeplitz band's non-zero 16 x 32 blocks (m-tile mt, k step ks) of the
// 48-byte depth padded to 64: rows 16 mt .. 16 mt + 15 against columns 32 ks
// .. min(32 ks + 31, 47), where A[k][i] != 0 needs 0 <= k - i <= 47 (A1's
// i <= k is the same band over its 48 rows)
__host__ __device__ constexpr bool band(int mt, int ks) {
  return 32 * ks <= 16 * mt + 15 && 16 * mt <= (32 * ks + 31 < 47 ? 32 * ks + 31 : 47) + 47;
}

// block (mt, ks)'s place among the non-zero blocks in (mt, ks) order: the
// wrapper's fragment tables hold those alone (kernels/mont_mul_mxu.fragments)
__host__ __device__ constexpr int block_index(int mt, int ks) {
  int k = 0;
  for (int i = 0; i < 2 * mt + ks; i++) k += band(i / 2, i % 2) ? 1 : 0;
  return k;
}

constexpr int NB1 = block_index(3, 0);  // A1: 48 rows
constexpr int NB2 = block_index(6, 0);  // A2: 96 rows
static_assert(NB1 == 4 && NB2 == 9, "the band's blocks");
constexpr int FRAG_WORDS = (NB1 + NB2) * 32 * 4;  // one uint4 a lane a block
constexpr int WARP_WORDS = 32 * TW + 32 * LZ;     // the B operand's columns, then the lazy columns
constexpr int SMEM_BYTES = 4 * (FRAG_WORDS + WARPS * WARP_WORDS);
static_assert(2 * SQ::AREA <= 32 * LZ, "the staged rows fit in the lazy columns' area");
static_assert(SMEM_BYTES <= 227 * 1024, "a block's shared memory");

__device__ __forceinline__ void mma_u8(int (&d)[4], uint4 a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// lazy[e][k - 16 MT0] = sum_i A[k][i] * byte i of column e, for the warp's 32
// columns e and the rows k of m-tiles MT0 .. MT0 + 2 of A. frag[block_index(mt,
// ks) * 32 + lane] holds the lane's A fragment of block (mt, ks). B fragment
// of k step ks: the column's words 8 ks + t and 8 ks + 4 + t (bytes 48 .. 63,
// words 12 .. 15, are the padding: 0).
template <int MT0>
__device__ __forceinline__ void const_dot(const uint4* frag, const uint32_t* words, int32_t* lazy, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = MT0; mt < MT0 + 3; mt++) {
    uint4 a[2];
#pragma unroll
    for (int ks = 0; ks < 2; ks++) a[ks] = band(mt, ks) ? frag[block_index(mt, ks) * 32 + lane] : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int nt = 0; nt < 4; nt++) {
      const uint32_t* col = words + (8 * nt + g) * TW;
      int d[4] = {0, 0, 0, 0};
      if (band(mt, 0)) mma_u8(d, a[0], col[t], col[4 + t]);
      if (band(mt, 1)) mma_u8(d, a[1], col[8 + t], 0u);
      // D fragment: rows k = 16 mt + g (+ 8), columns e = 8 nt + 2t (+ 1)
      const int e = 8 * nt + 2 * t, k = 16 * (mt - MT0) + g;
      lazy[e * LZ + k] = d[0];
      lazy[(e + 1) * LZ + k] = d[1];
      lazy[e * LZ + k + 8] = d[2];
      lazy[(e + 1) * LZ + k + 8] = d[3];
    }
  }
}

// word j of a lane's lazy column: its four bytes' sums at 0, 8, 16 and 24 bits
// (each below 2^22, so the word below 2^47)
__device__ __forceinline__ uint64_t lazy_word(const int4* col, int j) {
  const int4 v = col[j];
  return (uint64_t)(uint32_t)v.x + ((uint64_t)(uint32_t)v.y << 8) + ((uint64_t)(uint32_t)v.z << 16) +
         ((uint64_t)(uint32_t)v.w << 24);
}

// T = x y over W = 12 words, operand scanning with x's even words in E and
// its odd words in O (one word higher), as fr_mul without the reduction: row
// i adds x y_i, and word i of T is then E0, final. The regrouping that shifts
// the window by a word (E0' = O0 + E1, its carry into O's chain) rides at
// the head of the odd chain. Each asm block is one chain that starts
// without a carry in.
__device__ __forceinline__ void wide_mul(uint32_t (&T)[2 * TW], const uint32_t (&a)[TW], const uint32_t (&y)[TW]) {
  uint32_t e[TW + 1], o[TW + 1];
#pragma unroll
  for (int k = 0; k < TW / 2; k++) {
    e[2 * k] = a[2 * k] * y[0];
    e[2 * k + 1] = __umulhi(a[2 * k], y[0]);
    o[2 * k] = a[2 * k + 1] * y[0];
    o[2 * k + 1] = __umulhi(a[2 * k + 1], y[0]);
  }
  e[TW] = 0;
  o[TW] = 0;
  T[0] = e[0];
#pragma unroll
  for (int i = 1; i < TW; i++) {
    const uint32_t b = y[i];
    // E0 = O0 + E1; O' = [E2 .. E12, O12] + a_odd b, the carry of E0 in
    uint32_t E0, O[TW + 1];
#pragma unroll
    for (int k = 0; k < TW - 1; k++) O[k] = e[k + 2];
    O[TW - 1] = o[TW];
    asm("add.cc.u32 %0, %14, %15;\n\t"
        "madc.lo.cc.u32 %1, %16, %22, %1;\n\t"
        "madc.hi.cc.u32 %2, %16, %22, %2;\n\t"
        "madc.lo.cc.u32 %3, %17, %22, %3;\n\t"
        "madc.hi.cc.u32 %4, %17, %22, %4;\n\t"
        "madc.lo.cc.u32 %5, %18, %22, %5;\n\t"
        "madc.hi.cc.u32 %6, %18, %22, %6;\n\t"
        "madc.lo.cc.u32 %7, %19, %22, %7;\n\t"
        "madc.hi.cc.u32 %8, %19, %22, %8;\n\t"
        "madc.lo.cc.u32 %9, %20, %22, %9;\n\t"
        "madc.hi.cc.u32 %10, %20, %22, %10;\n\t"
        "madc.lo.cc.u32 %11, %21, %22, %11;\n\t"
        "madc.hi.cc.u32 %12, %21, %22, %12;\n\t"
        "addc.u32 %13, 0, 0;"
        : "=&r"(E0), "+r"(O[0]), "+r"(O[1]), "+r"(O[2]), "+r"(O[3]), "+r"(O[4]), "+r"(O[5]), "+r"(O[6]),
          "+r"(O[7]), "+r"(O[8]), "+r"(O[9]), "+r"(O[10]), "+r"(O[11]), "=&r"(O[12])
        : "r"(o[0]), "r"(e[1]), "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(a[9]), "r"(a[11]), "r"(b));
    // E' = [E0, O1 .. O11] + a_even b
    uint32_t E[TW + 1];
    E[0] = E0;
#pragma unroll
    for (int k = 1; k < TW; k++) E[k] = o[k];
    asm("mad.lo.cc.u32 %0, %13, %19, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %19, %1;\n\t"
        "madc.lo.cc.u32 %2, %14, %19, %2;\n\t"
        "madc.hi.cc.u32 %3, %14, %19, %3;\n\t"
        "madc.lo.cc.u32 %4, %15, %19, %4;\n\t"
        "madc.hi.cc.u32 %5, %15, %19, %5;\n\t"
        "madc.lo.cc.u32 %6, %16, %19, %6;\n\t"
        "madc.hi.cc.u32 %7, %16, %19, %7;\n\t"
        "madc.lo.cc.u32 %8, %17, %19, %8;\n\t"
        "madc.hi.cc.u32 %9, %17, %19, %9;\n\t"
        "madc.lo.cc.u32 %10, %18, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %18, %19, %11;\n\t"
        "addc.u32 %12, 0, 0;"
        : "+r"(E[0]), "+r"(E[1]), "+r"(E[2]), "+r"(E[3]), "+r"(E[4]), "+r"(E[5]), "+r"(E[6]), "+r"(E[7]),
          "+r"(E[8]), "+r"(E[9]), "+r"(E[10]), "+r"(E[11]), "=&r"(E[12])
        : "r"(a[0]), "r"(a[2]), "r"(a[4]), "r"(a[6]), "r"(a[8]), "r"(a[10]), "r"(b));
    T[i] = E[0];
#pragma unroll
    for (int k = 0; k <= TW; k++) {
      e[k] = E[k];
      o[k] = O[k];
    }
  }
  // T's top words: E / 2^32 + O (O12 is 0 and there is no carry out: T < 2^768)
  asm("add.cc.u32 %0, %0, %12;\n\t"
      "addc.cc.u32 %1, %1, %13;\n\t"
      "addc.cc.u32 %2, %2, %14;\n\t"
      "addc.cc.u32 %3, %3, %15;\n\t"
      "addc.cc.u32 %4, %4, %16;\n\t"
      "addc.cc.u32 %5, %5, %17;\n\t"
      "addc.cc.u32 %6, %6, %18;\n\t"
      "addc.cc.u32 %7, %7, %19;\n\t"
      "addc.cc.u32 %8, %8, %20;\n\t"
      "addc.cc.u32 %9, %9, %21;\n\t"
      "addc.cc.u32 %10, %10, %22;\n\t"
      "addc.u32 %11, %11, %23;"
      : "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]), "+r"(e[7]), "+r"(e[8]),
        "+r"(e[9]), "+r"(e[10]), "+r"(e[11]), "+r"(e[12])
      : "r"(o[0]), "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]), "r"(o[6]), "r"(o[7]), "r"(o[8]),
        "r"(o[9]), "r"(o[10]), "r"(o[11]));
#pragma unroll
  for (int k = 0; k < TW; k++) T[TW + k] = e[k + 1];
}

// the lane's 12 words into its column of the B operand (48 bytes: three
// 16-byte stores, conflict-free within each quarter warp)
__device__ __forceinline__ void put_column(uint32_t* words, const uint32_t* w, int lane) {
  uint4* col = reinterpret_cast<uint4*>(words + lane * TW);
#pragma unroll
  for (int q = 0; q < TW / 4; q++) col[q] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
}

// vec: bit 0 (a) and bit 1 (b) set where that operand's rows are 16-byte
// aligned, so that its chunks load as int4
__global__ void __launch_bounds__(THREADS)
mont_mul_mxu_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b, int32_t* __restrict__ out,
                    long long n, const uint4* __restrict__ frag1, const uint4* __restrict__ frag2, int vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint4* frag = reinterpret_cast<uint4*>(smem);
  for (int k = threadIdx.x; k < (NB1 + NB2) * 32; k += THREADS)
    frag[k] = k < NB1 * 32 ? __ldg(frag1 + k) : __ldg(frag2 + (k - NB1 * 32));
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long first = ((long long)blockIdx.x * WARPS + warp) * 32;  // the warp's first row
  const long long live = n - first;  // rows of the warp below n (may exceed 32)
  if (live <= 0) return;  // the whole warp
  uint32_t* words = smem + FRAG_WORDS + warp * WARP_WORDS;
  int32_t* lazy = reinterpret_cast<int32_t*>(words + 32 * TW);
  uint32_t* A = reinterpret_cast<uint32_t*>(lazy);  // the staged rows, in the lazy columns' area
  uint32_t* B = A + SQ::AREA;

  // 1. both operands' 32 rows into shared memory; rows past n read row 0 and stage as 0
  {
    const long long off = (lane < live ? first + lane : 0) * SQ::L;
    int4 va[SQ::CHUNKS], vb[SQ::CHUNKS];
    if (vec & 1) load_chunks<Fq, true>(va, a, off, lane);
    else load_chunks<Fq, false>(va, a, off, lane);
    if (vec & 2) load_chunks<Fq, true>(vb, b, off, lane);
    else load_chunks<Fq, false>(vb, b, off, lane);
    stage_chunks<Fq>(A, va, live, lane);
    stage_chunks<Fq>(B, vb, live, lane);
  }
  __syncwarp();

  // 2. T = a b on the integer units; T_lo's 48 bytes as column `lane`
  uint32_t T[2 * TW];
  {
    uint32_t x[TW], y[TW];
#pragma unroll
    for (int j = 0; j < TW; j++) {
      x[j] = A[lane * SQ::STRIDE + j];
      y[j] = B[lane * SQ::STRIDE + j];
    }
    wide_mul(T, x, y);
  }
  put_column(words, T, lane);
  __syncwarp();  // every lane has its operands: the lazy columns may overwrite them

  // 3. m_lazy = A1 . t8 on the tensor cores
  const_dot<0>(frag, words, lazy, lane);
  __syncwarp();

  // 4. m = m_lazy mod 2^384, a word at a time, as the lane's column
  const int4* col = reinterpret_cast<const int4*>(lazy + lane * LZ);
  {
    uint32_t m[TW];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < TW; j++) {
      const uint64_t s = lazy_word(col, j) + c;
      m[j] = (uint32_t)s;
      c = s >> 32;
    }
    put_column(words, m, lane);  // every lane read its t8 column in step 3, before the sync
  }
  __syncwarp();

  // 5. mn_lazy = A2 . m8 in two passes of 48 rows; (T + m N) >> 384, of
  // whose low 48 bytes only the carry is kept
  const uint4* frag2s = frag + NB1 * 32;
  const_dot<0>(frag2s, words, lazy, lane);
  __syncwarp();
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < TW; j++) c = (lazy_word(col, j) + T[j] + c) >> 32;
  __syncwarp();  // every lane has read its column of the first pass
  const_dot<3>(frag2s, words, lazy, lane);
  __syncwarp();
  uint32_t hi[TW];
#pragma unroll
  for (int j = 0; j < TW; j++) {
    const uint64_t s = lazy_word(col, j) + T[TW + j] + c;
    hi[j] = (uint32_t)s;
    c = s >> 32;
  }
  // the carry out of the top word is dropped, as in the reference
  Fe<Fq> r;
  reduce_once<Fq>(r, hi, 0u);
  __syncwarp();  // every lane has read its lazy column: the area takes the results

  // 6. the results back through the staging area, 16 bytes a lane
#pragma unroll
  for (int j = 0; j < TW; j++) A[lane * SQ::STRIDE + j] = r.w[j];
  __syncwarp();
  store_chunks<Fq>(out + first * SQ::L, A, live, lane);
}

}  // namespace

// a, b: n contiguous rows of 24 limbs; out: n contiguous rows, 16-byte
// aligned; frag1, frag2: the A1 and A2 fragment tables
extern "C" int masp_mont_mul_mxu(const int32_t* a, const int32_t* b, int32_t* out, long long n,
                                 const void* frag1, const void* frag2, void* stream) {
  static bool smem_set = false;  // set on the first launch, before any graph capture
  if (n <= 0 || n >= (1ll << 31) || (uintptr_t)out % 16 != 0 || (uintptr_t)frag1 % 16 != 0 ||
      (uintptr_t)frag2 % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (SMEM_BYTES > 48 * 1024 && !smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(mont_mul_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int vec = ((uintptr_t)a % 16 == 0) | (((uintptr_t)b % 16 == 0) << 1);
  const long long blocks = (n + THREADS - 1) / THREADS;
  mont_mul_mxu_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      a, b, out, n, static_cast<const uint4*>(frag1), static_cast<const uint4*>(frag2), vec);
  return (int)cudaGetLastError();
}

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
// multiply-adds of the product phase (W = 12 words): bytes. Design (first
// form): a warp owns 32 elements, one per lane. Each lane computes T in
// registers and writes T_lo's 12 words as one column of a 48 x 32 byte matrix
// in its warp's slice of shared memory; the warp runs the constant-matrix MMAs
// (mma.sync m16n8k16 u8, A fragments from global memory, B fragments straight
// from the staged words, all-zero blocks of the band skipped: 6 of 9 for A1,
// 12 of 18 for A2) and writes the int32 columns back to shared memory; each
// lane then normalises its own column of m, and after the second product
// finishes (T + m N) >> 384 and the subtraction in registers. Strides (12 words
// per staged column, 100 words per lazy column) keep fragment loads and stores
// conflict-free. 4 warps x 14 KB = 56 KB of dynamic shared memory per block,
// above the 48 KB default, so the launch raises the limit once.

#include "field.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int TW = 12;   // 32-bit words of a 48-byte operand column
constexpr int LZ = 100;  // int32 stride of a lane's lazy columns (>= 96)
constexpr int SMEM_BYTES = WARPS * 32 * (TW + LZ) * 4;

__device__ __forceinline__ void mma_u8(int (&d)[4], uint2 a, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(b));
}

// lazy[e][k] = sum_i A[k][i] * byte i of column e, for the warp's 32 columns e
// and the 16 MT rows k of A. frag[(mt * 3 + s) * 32 + lane] holds the lane's A
// fragment of m-tile mt and k step s; block (mt, s) is zero unless
// s <= mt <= s + 3.
template <int MT>
__device__ __forceinline__ void const_dot(const uint2* __restrict__ frag,
                                          const uint32_t* words, int32_t* lazy, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; mt++) {
    uint2 a[3];
#pragma unroll
    for (int s = 0; s < 3; s++)
      a[s] = (s <= mt && mt <= s + 3) ? __ldg(frag + (mt * 3 + s) * 32 + lane) : make_uint2(0, 0);
#pragma unroll
    for (int nt = 0; nt < 4; nt++) {
      int d[4] = {0, 0, 0, 0};
#pragma unroll
      for (int s = 0; s < 3; s++)
        if (s <= mt && mt <= s + 3) mma_u8(d, a[s], words[(nt * 8 + g) * TW + s * 4 + t]);
      // D fragment: rows k = 16 mt + g (+ 8), columns e = 8 nt + 2t (+ 1)
      const int e = nt * 8 + 2 * t, k = mt * 16 + g;
      lazy[e * LZ + k] = d[0];
      lazy[(e + 1) * LZ + k] = d[1];
      lazy[e * LZ + k + 8] = d[2];
      lazy[(e + 1) * LZ + k + 8] = d[3];
    }
  }
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t* w, int k) {
  return (w[k >> 2] >> (8 * (k & 3))) & 0xffu;
}

__global__ void __launch_bounds__(WARPS * 32)
mont_mul_mxu_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                    int32_t* __restrict__ out, long long n, const uint2* __restrict__ frag1,
                    const uint2* __restrict__ frag2) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* words = smem + warp * 32 * TW;
  int32_t* lazy = reinterpret_cast<int32_t*>(smem + WARPS * 32 * TW) + warp * 32 * LZ;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // every lane takes part in the warp's MMAs; lanes past n run on zeros
  const bool live = i < n;

  // 1. T = a b on the integer units, 24 words
  Fe<Fq> x, y;
  if (live) {
    load(x, a + i * 24);
    load(y, b + i * 24);
  } else {
#pragma unroll
    for (int j = 0; j < TW; j++) x.w[j] = y.w[j] = 0;
  }
  uint32_t T[2 * TW];
#pragma unroll
  for (int j = 0; j < 2 * TW; j++) T[j] = 0;
#pragma unroll
  for (int r = 0; r < TW; r++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < TW; j++) {
      const uint64_t p = (uint64_t)x.w[j] * y.w[r] + T[r + j] + c;
      T[r + j] = (uint32_t)p;
      c = p >> 32;
    }
    T[r + TW] = (uint32_t)c;
  }

  // 2. T_lo's 48 bytes as column `lane` of the warp's staged matrix
#pragma unroll
  for (int j = 0; j < TW; j++) words[lane * TW + j] = T[j];
  __syncwarp();

  // 3. m_lazy = A1 . t8 on the tensor cores
  const_dot<3>(frag1, words, lazy, lane);
  __syncwarp();

  // 4. normalise the lane's column to the 48 bytes of m (mod 2^384)
  const int4* col = reinterpret_cast<const int4*>(lazy + lane * LZ);
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < TW; j++) {
    const int4 v4 = col[j];
    const uint32_t v[4] = {(uint32_t)v4.x, (uint32_t)v4.y, (uint32_t)v4.z, (uint32_t)v4.w};
    uint32_t wd = 0;
#pragma unroll
    for (int q = 0; q < 4; q++) {
      const uint32_t s = v[q] + carry;
      wd |= (s & 0xffu) << (8 * q);
      carry = s >> 8;
    }
    words[lane * TW + j] = wd;  // every lane read its column of step 3 before the sync
  }
  __syncwarp();

  // 5. mn_lazy = A2 . m8 on the tensor cores
  const_dot<6>(frag2, words, lazy, lane);
  __syncwarp();

  // 6. (T + m N) >> 384: the low 48 byte positions give only their carry
  carry = 0;
#pragma unroll
  for (int j = 0; j < TW; j++) {
    const int4 v4 = col[j];
    const uint32_t v[4] = {(uint32_t)v4.x, (uint32_t)v4.y, (uint32_t)v4.z, (uint32_t)v4.w};
#pragma unroll
    for (int q = 0; q < 4; q++) carry = (v[q] + byte_of(T, 4 * j + q) + carry) >> 8;
  }
  uint32_t hi[TW];
#pragma unroll
  for (int j = 0; j < TW; j++) {
    const int4 v4 = col[TW + j];
    const uint32_t v[4] = {(uint32_t)v4.x, (uint32_t)v4.y, (uint32_t)v4.z, (uint32_t)v4.w};
    uint32_t wd = 0;
#pragma unroll
    for (int q = 0; q < 4; q++) {
      const uint32_t s = v[q] + byte_of(T, 48 + 4 * j + q) + carry;
      wd |= (s & 0xffu) << (8 * q);
      carry = s >> 8;
    }
    hi[j] = wd;
  }
  // the carry out of the top byte is dropped, as in the reference
  Fe<Fq> r;
  reduce_once<Fq>(r, hi, 0u);
  if (live) store(out + i * 24, r);
}

}  // namespace

extern "C" int masp_mont_mul_mxu(const int32_t* a, const int32_t* b, int32_t* out, long long n,
                                 const void* frag1, const void* frag2, void* stream) {
  static bool smem_set = false;  // set on the first launch, before any graph capture
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        mont_mul_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int threads = WARPS * 32;
  const long long blocks = (n + threads - 1) / threads;
  mont_mul_mxu_kernel<<<(unsigned)blocks, threads, SMEM_BYTES, (cudaStream_t)stream>>>(
      a, b, out, n, static_cast<const uint2*>(frag1), static_cast<const uint2*>(frag2));
  return (int)cudaGetLastError();
}

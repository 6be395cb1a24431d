// Int8 x int8 -> int32 matrix product on Hopper's tensor cores (IMMA), once
// (int8_dot) or summed over `reps` identical products inside one launch
// (int8_dot_loop).
//
// Replaces the Pallas kernels dot_kernel (tools/bench_kernel_micro.py:129, an
// int8 dot on the TPU's matrix unit) and mm_loop_kernel (:154, the same dot
// accumulated K times in one kernel as a throughput probe). x is (M, K) and w
// (K, N), both row-major int8; out is (M, N) int32. K <= 64 (the probe's
// shape is (1024, 48) @ (48, 96)); M and N are free, ragged edges masked.
// The plain PyTorch versions are int8_dot_plain / int8_dot_loop_plain in
// kernels/int8_dot.py.
//
// Bound: at the probe's shape one product is 4.7 M multiply-adds on 446 KB
// (the int32 output dominates), so the single dot is bound by its bytes and
// the loop, past a few reps, by the tensor cores' int8 rate. Design: warp-level
// mma.sync m16n8k16 (s8 x s8 -> s32). A block of four warps stages a 64-row
// slice of x and a 32-column slice of w, transposed, in shared memory (the B
// fragment holds four consecutive k of one column, i.e. a column-major
// operand), with a row stride of 20 words so that the fragment loads hit 32
// distinct banks. Each warp then keeps its 16 x K fragment of x and the
// 4 n-tiles of w in registers and issues K/16 MMAs per n-tile; the loop form
// repeats them `reps` times on the same registers. The MMAs are `asm volatile`
// and chain through the accumulator, so the compiler can neither hoist nor
// merge the repetitions: every rep is issued.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;    // rows of x per block: 16 per warp
constexpr int BN = 32;    // columns of w per block: 4 n-tiles of 8
constexpr int KMAX = 64;  // depth: at most 4 k16 steps
constexpr int SW = 20;    // shared row stride in 32-bit words (16 + 4)

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

template <bool LOOP>
__global__ void __launch_bounds__(128)
int8_dot_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                int32_t* __restrict__ out, int M, int K, int N, int reps) {
  __shared__ __align__(16) uint32_t xs[BM * SW];
  __shared__ __align__(16) uint32_t wt[BN * SW];
  int8_t* xb = reinterpret_cast<int8_t*>(xs);
  int8_t* wb = reinterpret_cast<int8_t*>(wt);
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  // stage x[row0 : row0 + 64, :K] and w[:K, col0 : col0 + 32]^T, zero-padded
  for (int idx = threadIdx.x; idx < BM * KMAX; idx += blockDim.x) {
    const int r = idx / KMAX, k = idx % KMAX, gr = row0 + r;
    xb[r * SW * 4 + k] = (gr < M && k < K) ? x[(long long)gr * K + k] : (int8_t)0;
  }
  for (int idx = threadIdx.x; idx < KMAX * BN; idx += blockDim.x) {
    const int k = idx / BN, c = idx % BN, gc = col0 + c;
    wb[c * SW * 4 + k] = (k < K && gc < N) ? w[(long long)k * N + gc] : (int8_t)0;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // PTX's groupID and threadID_in_group
  const int ksteps = (K + 15) / 16;
  // A fragment: rows g and g + 8 of the warp's 16, bytes 4t..4t+3 of k step s;
  // B fragment: column g of n-tile nt, the same four k
  uint32_t a[4][2], b[4][4];
#pragma unroll
  for (int s = 0; s < 4; s++) {
    a[s][0] = xs[(warp * 16 + g) * SW + s * 4 + t];
    a[s][1] = xs[(warp * 16 + g + 8) * SW + s * 4 + t];
#pragma unroll
    for (int nt = 0; nt < 4; nt++) b[nt][s] = wt[(nt * 8 + g) * SW + s * 4 + t];
  }
  int acc[4][4] = {};
  const int nrep = LOOP ? reps : 1;
  for (int r = 0; r < nrep; r++) {
#pragma unroll
    for (int nt = 0; nt < 4; nt++) {
#pragma unroll
      for (int s = 0; s < 4; s++)
        if (s < ksteps) mma_s8(acc[nt], a[s][0], a[s][1], b[nt][s]);
    }
  }
  // D fragment: (row g, columns 2t, 2t + 1) and (row g + 8, the same)
  const int r0 = row0 + warp * 16 + g;
#pragma unroll
  for (int nt = 0; nt < 4; nt++) {
    const int c = col0 + nt * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; h++) {
      const int r = r0 + 8 * h;
      if (r >= M) continue;
      if (c < N) out[(long long)r * N + c] = acc[nt][2 * h];
      if (c + 1 < N) out[(long long)r * N + c + 1] = acc[nt][2 * h + 1];
    }
  }
}

template <bool LOOP>
int launch(const int8_t* x, const int8_t* w, int32_t* out, int M, int K, int N, int reps,
           void* stream) {
  if (K < 1 || K > KMAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  int8_dot_kernel<LOOP><<<grid, 128, 0, (cudaStream_t)stream>>>(x, w, out, M, K, N, reps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int masp_int8_dot(const int8_t* x, const int8_t* w, int32_t* out, int M, int K, int N,
                             void* stream) {
  return launch<false>(x, w, out, M, K, N, 1, stream);
}

extern "C" int masp_int8_dot_loop(const int8_t* x, const int8_t* w, int32_t* out, int M, int K,
                                  int N, int reps, void* stream) {
  return launch<true>(x, w, out, M, K, N, reps, stream);
}

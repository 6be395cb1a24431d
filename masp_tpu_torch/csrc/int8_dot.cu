// Int8 x int8 -> int32 matrix product on Hopper's tensor cores (IMMA), once
// (int8_dot) or summed over `reps` identical products inside one launch
// (int8_dot_loop).
//
// Replaces the Pallas kernels dot_kernel (tools/bench_kernel_micro.py:129, an
// int8 dot on the TPU's matrix unit) and mm_loop_kernel (:154, the same dot
// accumulated K times in one kernel as a throughput probe). x is (M, K) and w
// (K, N), both row-major int8; out is (M, N) int32. K <= 64 (the probe's
// shape is (1024, 48) @ (48, 96)); M, N and K are free below that, ragged
// edges masked. The plain PyTorch versions are int8_dot_plain /
// int8_dot_loop_plain in kernels/int8_dot.py. Both kernels use warp-level
// mma.sync m16n8k16 (s8 x s8 -> s32).
//
// int8_dot. Bound: at the probe's shape one product is 4.7 M multiply-adds
// on 446 KB, 88% of it the int32 output, so by its bytes: 0.13 us, far below
// the launch itself. What a launch costs beyond that is latency: how many
// dependent trips to device memory a thread makes, and how much of the card
// the grid fills. Design: one warp per block computes a 16 x 32 output tile
// (192 blocks at the probe's shape, for 132 SMs). Every load of a thread is
// issued before the first is used, so the block waits for one trip: the A
// fragments come straight from global memory as 32-bit words (4 consecutive
// k of one row; byte by byte, masked, when K % 4 != 0), and w's 32-column
// slice comes in 16-byte loads, four rows of 16 columns a lane, transposed
// in registers (byte permutes) into the column-major words the B fragments
// take and stored to shared memory once. The tile goes back through shared
// memory as coalesced 16-byte stores (4-byte when N % 4 != 0).
//
// int8_dot_loop. A block of four warps stages a 64-row slice of x and a
// 32-column slice of w, transposed, in shared memory, byte by byte, with a
// row stride of 20 words so that the fragment loads hit 32 distinct banks.
// Each warp then keeps its 16 x K fragment of x and the 4 n-tiles of w in
// registers and issues K/16 MMAs per n-tile, `reps` times on the same
// registers. The MMAs are `asm volatile` and chain through the accumulator,
// so the compiler can neither hoist nor merge the repetitions: every rep is
// issued.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int KMAX = 64;  // depth: at most 4 k16 steps
constexpr int SW = 20;    // shared row stride of a transposed w slice, in 32-bit words (16 + 4)

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// --- int8_dot: one product ------------------------------------------------------

constexpr int TM = 16;  // rows of the output tile (one m16 tile)
constexpr int TN = 32;  // columns of the output tile (4 n-tiles of 8)
constexpr int OS = 40;  // shared row stride of the output tile, in words

// bytes k .. k + 3 of one row of x (zero past K) as a little-endian word
__device__ __forceinline__ uint32_t x_word(const int8_t* __restrict__ row, int k, int K,
                                           bool words) {
  if (k >= K) return 0u;
  if (words) return __ldg(reinterpret_cast<const uint32_t*>(row + k));
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; i++)
    if (k + i < K) v |= (uint32_t)(uint8_t)__ldg(row + k + i) << (8 * i);
  return v;
}

// 16 bytes of w's row k from column c (zero past K and N)
__device__ __forceinline__ uint4 w_chunk(const int8_t* __restrict__ w, int k, int c, int K,
                                         int N, bool vec) {
  if (k >= K) return make_uint4(0, 0, 0, 0);
  const int8_t* src = w + (long long)k * N + c;
  if (vec) return c < N ? __ldg(reinterpret_cast<const uint4*>(src)) : make_uint4(0, 0, 0, 0);
  uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; i++)
    if (c + i < N) v[i >> 2] |= (uint32_t)(uint8_t)__ldg(src + i) << (8 * (i & 3));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(32)
int8_dot_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                int32_t* __restrict__ out, int M, int K, int N, int x_words, int w_vec,
                int out_vec) {
  __shared__ __align__(16) uint32_t wt[TN * SW];  // w[:, col0 : col0 + 32]^T, 4 k a word
  __shared__ __align__(16) int32_t ot[TM * OS];   // the output tile
  const int lane = threadIdx.x;
  const int g = lane >> 2, t = lane & 3;  // PTX's groupID and threadID_in_group
  const int row0 = blockIdx.x * TM, col0 = blockIdx.y * TN;

  // every global load first. A fragment: rows g and g + 8 of the tile, bytes
  // 4t .. 4t + 3 of k step s
  uint32_t a[4][2];
#pragma unroll
  for (int s = 0; s < 4; s++)
#pragma unroll
    for (int h = 0; h < 2; h++) {
      const int r = row0 + g + 8 * h;
      a[s][h] = r < M ? x_word(x + (long long)r * K, 16 * s + 4 * t, K, x_words) : 0u;
    }
  // w: lane (kg, half) takes rows 4 kg .. 4 kg + 3, columns 16 half .. + 15
  const int kg = lane >> 1, half = lane & 1;
  uint4 r[4];
#pragma unroll
  for (int i = 0; i < 4; i++) r[i] = w_chunk(w, 4 * kg + i, col0 + 16 * half, K, N, w_vec);

  // 4 x 4 byte transposes: column word c holds k = 4 kg .. 4 kg + 3 of one column
#pragma unroll
  for (int cg = 0; cg < 4; cg++) {
    const uint32_t r0 = word(r[0], cg), r1 = word(r[1], cg), r2 = word(r[2], cg),
                   r3 = word(r[3], cg);
    const uint32_t lo01 = __byte_perm(r0, r1, 0x5140), lo23 = __byte_perm(r2, r3, 0x5140);
    const uint32_t hi01 = __byte_perm(r0, r1, 0x7362), hi23 = __byte_perm(r2, r3, 0x7362);
    uint32_t* col = wt + (16 * half + 4 * cg) * SW + kg;
    col[0] = __byte_perm(lo01, lo23, 0x5410);
    col[SW] = __byte_perm(lo01, lo23, 0x7632);
    col[2 * SW] = __byte_perm(hi01, hi23, 0x5410);
    col[3 * SW] = __byte_perm(hi01, hi23, 0x7632);
  }
  __syncthreads();

  // B fragment: column g of n-tile nt, the same four k
  const int ksteps = (K + 15) / 16;
  int acc[4][4] = {};
#pragma unroll
  for (int nt = 0; nt < 4; nt++)
#pragma unroll
    for (int s = 0; s < 4; s++)
      if (s < ksteps) mma_s8(acc[nt], a[s][0], a[s][1], wt[(nt * 8 + g) * SW + s * 4 + t]);

  // D fragment: (row g, columns 2t, 2t + 1) and (row g + 8, the same)
#pragma unroll
  for (int nt = 0; nt < 4; nt++)
#pragma unroll
    for (int h = 0; h < 2; h++)
      *reinterpret_cast<int2*>(ot + (g + 8 * h) * OS + nt * 8 + 2 * t) =
          make_int2(acc[nt][2 * h], acc[nt][2 * h + 1]);
  __syncthreads();

  if (out_vec) {  // 16 rows x 8 chunks of 16 bytes
#pragma unroll
    for (int i = 0; i < TM * TN / 4 / 32; i++) {
      const int c = lane + 32 * i, row = c >> 3, col = 4 * (c & 7);
      if (row0 + row < M && col0 + col < N)
        *reinterpret_cast<int4*>(out + (long long)(row0 + row) * N + col0 + col) =
            *reinterpret_cast<const int4*>(ot + row * OS + col);
    }
  } else {
#pragma unroll
    for (int i = 0; i < TM * TN / 32; i++) {
      const int row = i, col = lane;
      if (row0 + row < M && col0 + col < N)
        out[(long long)(row0 + row) * N + col0 + col] = ot[row * OS + col];
    }
  }
}

// --- int8_dot_loop: reps products summed in one launch ----------------------------

constexpr int BM = 64;  // rows of x per block: 16 per warp
constexpr int BN = 32;  // columns of w per block: 4 n-tiles of 8

__global__ void __launch_bounds__(128)
int8_dot_loop_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
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
  for (int r = 0; r < reps; r++) {
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

}  // namespace

extern "C" int masp_int8_dot(const int8_t* x, const int8_t* w, int32_t* out, int M, int K, int N,
                             void* stream) {
  if (K < 1 || K > KMAX) return (int)cudaErrorInvalidValue;
  const int x_words = K % 4 == 0 && (uintptr_t)x % 4 == 0;
  const int w_vec = N % 16 == 0 && (uintptr_t)w % 16 == 0;
  const int out_vec = N % 4 == 0 && (uintptr_t)out % 16 == 0;
  const dim3 grid((M + TM - 1) / TM, (N + TN - 1) / TN);
  int8_dot_kernel<<<grid, 32, 0, (cudaStream_t)stream>>>(x, w, out, M, K, N, x_words, w_vec,
                                                         out_vec);
  return (int)cudaGetLastError();
}

extern "C" int masp_int8_dot_loop(const int8_t* x, const int8_t* w, int32_t* out, int M, int K,
                                  int N, int reps, void* stream) {
  if (K < 1 || K > KMAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  int8_dot_loop_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(x, w, out, M, K, N, reps);
  return (int)cudaGetLastError();
}

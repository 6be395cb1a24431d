// Int8 x int8 -> int32 matrix product on Hopper's tensor cores, once
// (int8_dot, warp-level mma.sync) or summed over `reps` identical products
// inside one launch (int8_dot_loop, warpgroup-level wgmma).
//
// Replaces the Pallas kernels dot_kernel (tools/bench_kernel_micro.py:129, an
// int8 dot on the TPU's matrix unit) and mm_loop_kernel (:154, the same dot
// accumulated K times in one kernel as a throughput probe). x is (M, K) and w
// (K, N), both row-major int8; out is (M, N) int32. K <= 64 (the probe's
// shape is (1024, 48) @ (48, 96)); M, N and K are free below that, ragged
// edges masked. The plain PyTorch versions are int8_dot_plain /
// int8_dot_loop_plain in kernels/int8_dot.py.
//
// int8_dot. mma.sync m16n8k16 (s8 x s8 -> s32). Bound: at the probe's shape
// one product is 4.7 M multiply-adds on 446 KB, 88% of it the int32 output,
// so by its bytes: 0.13 us, far below the launch itself. What a launch costs
// beyond that is latency: how many dependent trips to device memory a thread
// makes, and how much of the card the grid fills. Design: one warp per block
// computes a 16 x 32 output tile (192 blocks at the probe's shape, for 132
// SMs). Every load of a thread is issued before the first is used, so the
// block waits for one trip: the A fragments come straight from global memory
// as 32-bit words (4 consecutive k of one row; byte by byte, masked, when
// K % 4 != 0), and w's 32-column slice comes in 16-byte loads, four rows of
// 16 columns a lane, transposed in registers (byte permutes) into the
// column-major words the B fragments take and stored to shared memory once.
// The tile goes back through shared memory as coalesced 16-byte stores
// (4-byte when N % 4 != 0).
//
// int8_dot_loop. Bound: reps x M x K x N multiply-adds at the card's int8
// tensor rate (4.77 ns a product at the probe's shape); the operands and the
// output (446 KB) once. Design:
// - wgmma.mma_async m64n24k32 s32.s8.s8: one warpgroup owns a 64 x 24 output
//   tile (LOOP_TILE_M x LOOP_TILE_N; a ragged N is padded with zero columns).
//   K is padded with zero bytes to K_PAD = 64, two k32 steps (one when
//   K <= 32), so at K = 48 a quarter of the tensor work multiplies zeros.
//   Both operands are K-major, as 8-bit wgmma requires: A's fragments are
//   loaded from shared memory into registers once and reused every rep
//   (a wgmma that reads A through a descriptor too is bound by shared-memory
//   reads at n24); B is w's 24 columns, transposed (N x K), in shared memory.
// - Shared-memory layout, no swizzle (layout type 0): the canonical K-major
//   layout of core matrices, 8 rows x 16 bytes stored as 128 contiguous
//   bytes; byte (row, k) at (row / 8) SBO + (k / 16) LBO + (row % 8) 16 +
//   k % 16, LBO = 128 (the next core matrix along K), SBO = 512 (the next 8
//   rows). A k32 step is two core matrices along K: the next step's
//   descriptor starts 2 LBO further. A core matrix's 128 contiguous bytes
//   hit every bank once, so no swizzle is needed.
// - Every SM busy: the reps are split too. grid = (m-tiles, n-tiles,
//   CLUSTER); the CLUSTER CTAs of one tile form a thread-block cluster, and
//   rank q, one warpgroup, runs rep slice q (rep_slices in
//   kernels/int8_dot.py): reps / CLUSTER, one more for the first
//   reps % CLUSTER ranks. At the probe's shape 16 x 4 x 2 = 128 CTAs.
//   Clusters of 2: the H100 holds 66 clusters of 2 such CTAs at once but
//   only 30 of 4 and 15 of 8 (120 SMs), so 64 x 96 tiles in clusters of 8
//   ran a 16th cluster in a second wave.
// - One CTA an SM when the grid is one wave: where the launch has no more
//   CTAs than the card has SMs, a CTA asks for LOOP_SMEM, more than half an
//   SM's shared memory, so no two share one SM's tensor cores while another
//   SM idles. A wider grid asks for the TILE_SMEM its tiles use, so that
//   several CTAs an SM hide each other's latency.
// - The warpgroup issues all its reps' wgmmas into one accumulator after
//   one wgmma.fence, then one commit_group and one wait_group 0: it waits on
//   no product before the last. The rep count comes from the cluster rank,
//   uniform across the warpgroup, so that ptxas does not serialize the
//   wgmmas. The s32 accumulator wraps modulo 2^32 (no .satfinite), as the
//   plain version and the JAX fori_loop do.
// - One trip to stage: each CTA issues every global load of its x tile (16-
//   byte chunks when K % 16 == 0 and x is aligned, else masked bytes) and of
//   w's 24 columns (four rows of 8 columns a task, 8-byte loads when
//   N % 8 == 0: a tile starts 24 bytes after the last) before it stores the
//   first, transposes w in registers into 4-k words, then fences the stores
//   to the tensor cores' (async) proxy.
// - The slices are summed on chip: each CTA leaves its partial tile in its
//   own shared memory; after a cluster barrier rank q sums its band of
//   LOOP_TILE_M / CLUSTER rows over the cluster's tiles through distributed
//   shared memory with int32 wrap and writes it with 16-byte stores (4-byte
//   ones when N % 4 != 0), masked at the edges; a second cluster barrier
//   keeps every tile alive until read. No atomics, no zeroed output, one launch, a deterministic result.
// Built with -DMASP_INT8_PROBE, the kernel also records each CTA's SM
// (masp_int8_dot_loop_smids), which chip_smoke.py reads to show that each
// CTA of a one-wave launch has an SM of its own.

#include <cooperative_groups.h>
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

// columns 4 cg .. 4 cg + 3 of four 16-byte rows r[0..3] (consecutive k) as
// words: c[j] holds the four k of column 4 cg + j, the first in its low byte
__device__ __forceinline__ void column_words(const uint4 (&r)[4], int cg, uint32_t (&c)[4]) {
  const uint32_t r0 = word(r[0], cg), r1 = word(r[1], cg), r2 = word(r[2], cg), r3 = word(r[3], cg);
  const uint32_t lo01 = __byte_perm(r0, r1, 0x5140), lo23 = __byte_perm(r2, r3, 0x5140);
  const uint32_t hi01 = __byte_perm(r0, r1, 0x7362), hi23 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(lo01, lo23, 0x5410);
  c[1] = __byte_perm(lo01, lo23, 0x7632);
  c[2] = __byte_perm(hi01, hi23, 0x5410);
  c[3] = __byte_perm(hi01, hi23, 0x7632);
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
    uint32_t c[4];
    column_words(r, cg, c);
    uint32_t* col = wt + (16 * half + 4 * cg) * SW + kg;
#pragma unroll
    for (int j = 0; j < 4; j++) col[j * SW] = c[j];
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

namespace cg = cooperative_groups;

constexpr int LOOP_TILE_M = 64;   // rows of x a CTA: wgmma's m64
constexpr int LOOP_TILE_N = 24;   // columns of w a CTA: wgmma's n24
constexpr int K_PAD = 64;         // depth staged, zero past K: two k32 steps
constexpr int K_STEP = 32;        // wgmma's depth for 8-bit operands
constexpr int CLUSTER = 2;        // CTAs of one output tile, one rep slice each (R)
constexpr int LBO = 128;          // bytes from a core matrix to the next along K
constexpr int SBO = 512;          // bytes from 8 rows to the next 8: K_PAD / 16 core matrices
constexpr int SWIZZLE = 0;        // the descriptor's layout type: no swizzle
constexpr int PART_STRIDE = 40;   // words a row of the partial tile: 24 + 16, so a warp's
                                  // 8-byte fragment stores hit distinct banks
constexpr int LOOP_THREADS = 128;  // one warpgroup
constexpr int XS_BYTES = LOOP_TILE_M * K_PAD, WTS_BYTES = LOOP_TILE_N * K_PAD;
// shared memory a CTA's tiles take (15,872 bytes), and what it asks for in a
// one-wave launch: more than half of an SM's 228 KB, so an SM of its own
constexpr int TILE_SMEM = XS_BYTES + WTS_BYTES + 4 * LOOP_TILE_M * PART_STRIDE;
constexpr int LOOP_SMEM = 116 * 1024;
static_assert(TILE_SMEM <= LOOP_SMEM && 2 * LOOP_SMEM > 228 * 1024, "one CTA an SM");
constexpr int ACC = LOOP_TILE_N / 2;  // s32 accumulator registers a thread
static_assert(LOOP_TILE_M % CLUSTER == 0 && CLUSTER <= 8, "a rank sums a band of whole rows");

// byte (row, k) of a staged K-major operand: core matrices of 8 rows x 16 bytes
__device__ __forceinline__ int staged(int row, int k) {
  return (row >> 3) * SBO + (k >> 4) * LBO + (row & 7) * 16 + (k & 15);
}

// wgmma's shared-memory matrix descriptor: start address, leading and stride
// byte offsets (each >> 4), layout type
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | (uint64_t)(LBO >> 4) << 16 | (uint64_t)(SBO >> 4) << 32 |
         (uint64_t)SWIZZLE << 62;
}
// the next k32 step: two core matrices further along K
constexpr uint64_t DESC_K_STEP = (K_STEP / 16) * LBO >> 4;

#define WGMMA_N24 \
  "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
#define ACC_OPS                                                                                 \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
      "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11])

// d += A B over one k32 step: A's fragment in registers (rows 16 warp + g
// and + 8, bytes 4t .. 4t + 3 and + 16 of the step), B^T (24 x 32) from
// shared memory
__device__ __forceinline__ void wgmma(int (&d)[ACC], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n" WGMMA_N24 "{%12, %13, %14, %15}, %16, p;\n}\n"
      : ACC_OPS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the accumulator as the compiler sees it: defined here, so that no use
// moves above a wait and no definition below a fence
__device__ __forceinline__ void fence_acc(int (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; i++) asm volatile("" : "+r"(d[i])::"memory");
}

// n reps of KSTEPS k32 steps into d, each issued without waiting
template <int KSTEPS>
__device__ __forceinline__ void products(int (&d)[ACC], int n, uint64_t db, const uint32_t (&a)[2][4]) {
  for (int r = 0; r < n; r++) {
#pragma unroll
    for (int s = 0; s < KSTEPS; s++) wgmma(d, a[s], db + s * DESC_K_STEP);
  }
}

// 8 bytes of w's row k from column c (zero past K and N)
__device__ __forceinline__ uint2 w_chunk8(const int8_t* __restrict__ w, int k, int c, int K, int N,
                                          bool vec) {
  if (k >= K) return make_uint2(0, 0);
  const int8_t* src = w + (long long)k * N + c;
  if (vec) return c < N ? __ldg(reinterpret_cast<const uint2*>(src)) : make_uint2(0, 0);
  uint32_t v[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 8; i++)
    if (c + i < N) v[i >> 2] |= (uint32_t)(uint8_t)__ldg(src + i) << (8 * (i & 3));
  return make_uint2(v[0], v[1]);
}

// 16 bytes of row r of x from depth 16 kc (zero past M and K)
__device__ __forceinline__ uint4 x_chunk(const int8_t* __restrict__ x, int r, int kc, int M, int K,
                                         bool vec) {
  const int k = 16 * kc;
  if (r >= M || k >= K) return make_uint4(0, 0, 0, 0);
  const int8_t* src = x + (long long)r * K + k;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(src));
  uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; i++)
    if (k + i < K) v[i >> 2] |= (uint32_t)(uint8_t)__ldg(src + i) << (8 * (i & 3));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

#ifdef MASP_INT8_PROBE
constexpr int PROBE_CTAS = 1 << 12;
__device__ int probe_smid[PROBE_CTAS];
#endif

__global__ void __launch_bounds__(LOOP_THREADS)
int8_dot_loop_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     int32_t* __restrict__ out, int M, int K, int N, int reps, int x_vec,
                     int w_vec, int out_vec) {
  extern __shared__ __align__(128) int8_t smem[];
  int8_t* xs = smem;                                                  // x's tile, staged
  int8_t* wts = smem + XS_BYTES;                                      // w's columns, transposed, staged
  int32_t* part = reinterpret_cast<int32_t*>(smem + XS_BYTES + WTS_BYTES);  // this CTA's partial tile
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * LOOP_TILE_M, col0 = blockIdx.y * LOOP_TILE_N;
#ifdef MASP_INT8_PROBE
  if (tid == 0) {
    const int cta = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    uint32_t sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    if (cta < PROBE_CTAS) probe_smid[cta] = (int)sm;
  }
#endif

  // stage in one trip: every global load first. x: 64 rows x 4 chunks of 16
  // bytes; w: task q = (kg, cc) takes rows 4 kg .. 4 kg + 3, columns 8 cc ..
  // 8 cc + 7 (8-byte chunks: a tile's columns start at multiples of 8)
  constexpr int KC = K_PAD / 16, XC = LOOP_TILE_M * KC / LOOP_THREADS;
  constexpr int WCC = LOOP_TILE_N / 8, WT = (K_PAD / 4) * WCC, WQ = (WT + LOOP_THREADS - 1) / LOOP_THREADS;
  static_assert(XC * LOOP_THREADS == LOOP_TILE_M * KC, "staging tasks");
  uint4 xv[XC];
  uint2 wv[WQ][4];
#pragma unroll
  for (int i = 0; i < XC; i++) {
    const int c = tid + i * LOOP_THREADS;
    xv[i] = x_chunk(x, row0 + c / KC, c % KC, M, K, x_vec);
  }
#pragma unroll
  for (int i = 0; i < WQ; i++) {
    const int q = tid + i * LOOP_THREADS, cc = q % WCC, kg = q / WCC;
#pragma unroll
    for (int r = 0; r < 4; r++)
      wv[i][r] = q < WT ? w_chunk8(w, 4 * kg + r, col0 + 8 * cc, K, N, w_vec) : make_uint2(0, 0);
  }
#pragma unroll
  for (int i = 0; i < XC; i++) {
    const int c = tid + i * LOOP_THREADS;
    *reinterpret_cast<uint4*>(xs + staged(c / KC, 16 * (c % KC))) = xv[i];
  }
#pragma unroll
  for (int i = 0; i < WQ; i++) {
    const int q = tid + i * LOOP_THREADS, cc = q % WCC, kg = q / WCC;
    if (q >= WT) continue;
    const uint4 rows[4] = {make_uint4(wv[i][0].x, wv[i][0].y, 0, 0), make_uint4(wv[i][1].x, wv[i][1].y, 0, 0),
                           make_uint4(wv[i][2].x, wv[i][2].y, 0, 0), make_uint4(wv[i][3].x, wv[i][3].y, 0, 0)};
#pragma unroll
    for (int g4 = 0; g4 < 2; g4++) {
      uint32_t c[4];
      column_words(rows, g4, c);
#pragma unroll
      for (int j = 0; j < 4; j++)
        *reinterpret_cast<uint32_t*>(wts + staged(8 * cc + 4 * g4 + j, 4 * kg)) = c[j];
    }
  }
  // the tensor cores read shared memory through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // this rank's rep slice; the rank is uniform across the warpgroup, so
  // ptxas sees the wgmma loop as uniform (an index from threadIdx made it
  // serialize the wgmmas)
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // PTX's groupID and threadID_in_group
  const int n = reps / CLUSTER + (rank < reps % CLUSTER ? 1 : 0);
  uint32_t a[2][4];
#pragma unroll
  for (int s = 0; s < 2; s++)
#pragma unroll
    for (int i = 0; i < 4; i++)
      a[s][i] = *reinterpret_cast<const uint32_t*>(
          xs + staged(16 * warp + g + 8 * (i & 1), K_STEP * s + 16 * (i >> 1) + 4 * t));
  int d[ACC];
#pragma unroll
  for (int i = 0; i < ACC; i++) d[i] = 0;
  fence_acc(d);
  wgmma_fence();
  const uint64_t db = smem_desc(wts);
  if (K > K_STEP)
    products<2>(d, n, db, a);
  else
    products<1>(d, n, db, a);
  wgmma_commit();
  wgmma_wait_all();
  fence_acc(d);

  // the accumulator: register 4 j + 2 h + e is (row 16 warp + g + 8 h,
  // column 8 j + 2 t + e)
#pragma unroll
  for (int p = 0; p < ACC / 2; p++)
    *reinterpret_cast<int2*>(part + (16 * warp + g + 8 * (p & 1)) * PART_STRIDE + 8 * (p >> 1) + 2 * t) =
        make_int2(d[2 * p], d[2 * p + 1]);
  cluster.sync();

  // rank q sums its band of rows over the cluster's tiles and writes it
  constexpr int BAND = LOOP_TILE_M / CLUSTER, RC = LOOP_TILE_N / 4;  // rows, 16-byte chunks a row
  const int32_t* parts[CLUSTER];
#pragma unroll
  for (int q = 0; q < CLUSTER; q++) parts[q] = cluster.map_shared_rank(part, q);
  for (int c = tid; c < BAND * RC; c += LOOP_THREADS) {
    const int r = rank * BAND + c / RC, col = 4 * (c % RC);
    int4 v[CLUSTER];
#pragma unroll
    for (int q = 0; q < CLUSTER; q++)
      v[q] = *reinterpret_cast<const int4*>(parts[q] + r * PART_STRIDE + col);
    uint32_t s[4] = {0, 0, 0, 0};
#pragma unroll
    for (int q = 0; q < CLUSTER; q++) {
      s[0] += (uint32_t)v[q].x;
      s[1] += (uint32_t)v[q].y;
      s[2] += (uint32_t)v[q].z;
      s[3] += (uint32_t)v[q].w;
    }
    const int gr = row0 + r, gc = col0 + col;
    if (gr >= M || gc >= N) continue;
    int32_t* dst = out + (long long)gr * N + gc;
    if (out_vec) {
      *reinterpret_cast<int4*>(dst) = make_int4((int)s[0], (int)s[1], (int)s[2], (int)s[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; e++)
        if (gc + e < N) dst[e] = (int)s[e];
    }
  }
  cluster.sync();  // every tile stays until the cluster has read it
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

// the launch: the CLUSTER CTAs of a tile form a cluster, each with LOOP_SMEM
// bytes of shared memory (so an SM of its own) when the grid is one wave,
// else with TILE_SMEM
extern "C" int masp_int8_dot_loop(const int8_t* x, const int8_t* w, int32_t* out, int M, int K,
                                  int N, int reps, void* stream) {
  if (K < 1 || K > K_PAD || reps < 0) return (int)cudaErrorInvalidValue;
  static const cudaError_t set = cudaFuncSetAttribute(
      int8_dot_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, LOOP_SMEM);
  if (set != cudaSuccess) return (int)set;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int x_vec = K % 16 == 0 && (uintptr_t)x % 16 == 0;
  const int w_vec = N % 8 == 0 && (uintptr_t)w % 8 == 0;
  const int out_vec = N % 4 == 0 && (uintptr_t)out % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + LOOP_TILE_M - 1) / LOOP_TILE_M, (N + LOOP_TILE_N - 1) / LOOP_TILE_N, CLUSTER);
  cfg.blockDim = dim3(LOOP_THREADS);
  const long long ctas = (long long)cfg.gridDim.x * cfg.gridDim.y * CLUSTER;
  cfg.dynamicSmemBytes = ctas <= sms ? LOOP_SMEM : TILE_SMEM;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = CLUSTER;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, int8_dot_loop_kernel, x, w, out, M, K, N, reps, x_vec, w_vec, out_vec);
  return (int)cudaGetLastError();
}

#ifdef MASP_INT8_PROBE
// the SM of each CTA of the last launch, by linear CTA index (x fastest)
extern "C" int masp_int8_dot_loop_smids(int* host, int n) {
  if (n < 0 || n > PROBE_CTAS) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(host, probe_smid, sizeof(int) * n);
}
#endif

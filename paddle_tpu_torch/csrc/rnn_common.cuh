// Shared pieces of the persistent recurrent kernels for Hopper (sm_90a):
// the grid-wide barrier (whole, or split into arrive and wait), the
// staged SIMT product against a weight slice resident in shared memory,
// and the element conversions. Included by lstm_fwd_sm90.cu,
// lstm_bwd_sm90.cu, gru_fwd.cu (the staged SIMT product), gru_fwd_sm90.cu
// (which takes only the conversions: it has no grid barrier) and, through
// lstm_bf16x3.cuh, lstm_fwd_bf16x3_sm90.cu and lstm_bwd_bf16x3_sm90.cu.
//
// The design every recurrent kernel shares (a persistent RNN): one
// cooperative launch covers the whole sequence, with at most one block
// per SM. Block x owns the hidden units j in [x*U, x*U + U) and keeps
// the weight it needs for them in shared memory for the whole launch;
// every step it reads the state all blocks wrote at the previous step
// from global memory (L2-resident), computes its own units, writes them
// back, and meets the other blocks at a grid-wide barrier. Nothing
// crosses a launch: the time loop lives inside the kernel.
//
// Layouts (the layer's, read in place): sequences [B, T, width] row
// major, state [B, H] float32, lens [B] int32.
//
// The product: a tile of kRows = 128 rows of the left operand A [rows,
// K] (global) is staged in chunks of kKC = 32 columns into shared memory,
// transposed to [kKC][kLds] so a thread reads its 8 rows as two float4;
// the right operand Bs [Kpad, N] is the resident weight slice
// (Kpad = K rounded up to kKC, zero rows below K). 256 threads form a
// 16 x 16 grid (ty, tx): a thread owns rows 8*ty .. 8*ty+7 and columns
// tx + 16*n (n < TN) and accumulates in float32 registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rnn {

constexpr int kThreads = 256;
constexpr int kTM = 8;                 // rows per thread in a product
constexpr int kRows = 16 * kTM;        // rows per tile
constexpr int kKC = 32;                // columns of A per staged chunk
constexpr int kLds = kRows + 4;        // pitch of the staged chunk
constexpr int kMaxUnits = 16;          // hidden units per block
constexpr size_t kMaxSmem = 232448;    // what a block may opt in to on sm_90

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Floats of dynamic shared memory for a resident slice [round_up(K), n_w]
// plus the staging area, which after a product also holds the [kRows,
// n_tile] result tile.
__host__ __device__ inline size_t smem_floats(int K, int n_w, int n_tile) {
  const size_t w = (size_t)round_up(K, kKC) * n_w;
  const size_t stage = (size_t)kKC * kLds;
  const size_t tile = (size_t)kRows * n_tile;
  return w + (stage > tile ? stage : tile);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);          // round to nearest even
}

// x as the product dtype T would hold it (the TPU kernels' .astype)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Grid-wide barrier over a cooperative launch: a monotonic arrival
// counter (zeroed by the caller before the launch). Barrier number e
// (1, 2, ...) waits until e * gridDim.x blocks have arrived. Each
// block's writes are ordered before its arrival by __syncthreads and a
// device-scope fence, and the acquiring load orders the reads after.
// In two halves, for a block that has work no other block waits for
// (stores read only after the launch, loads of the next step's inputs):
// grid_arrive(bar) once the writes the others need are made, that work,
// then grid_wait(bar, epoch); grid_sync has nothing between them.
__device__ __forceinline__ void grid_arrive(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
  }
}

__device__ __forceinline__ void grid_wait(unsigned int* bar,
                                          unsigned int epoch) {
  if (threadIdx.x == 0) {
    const unsigned int target = epoch * gridDim.x;
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(bar)
                   : "memory");
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void grid_sync(unsigned int* bar,
                                          unsigned int epoch) {
  grid_arrive(bar);
  grid_wait(bar, epoch);
}

// Ring stages of stage_bytes that fit in a block's shared memory beside
// fixed_bytes, at most max_stages and at most cap when cap > 0; 0 when
// fewer than 2 remain or cap is 1 (a consumer holds one stage while it
// waits for the next). The plan of the bf16 LSTM kernels.
__host__ __device__ inline int ring_stages_fit(long long fixed_bytes,
                                               long long stage_bytes,
                                               int max_stages, int cap) {
  long long s = ((long long)kMaxSmem - fixed_bytes) / stage_bytes;
  if (s > max_stages) s = max_stages;
  if (cap > 0 && cap < s) s = cap;
  return s < 2 ? 0 : (int)s;
}

// Four consecutive elements of A in their stored form (a float4, or
// four bf16 in a uint2), and as float32. Loads of data other blocks
// wrote during this launch go through L2 (__ldcg), never through a
// possibly stale L1 line. The prefetch keeps
// the stored form: converting at once would wait on the load.
__device__ __forceinline__ float4 raw4_load(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ uint2 raw4_load(const __nv_bfloat16* p) {
  return __ldcg(reinterpret_cast<const uint2*>(p));
}
// the first n (1..4) elements, one load each (rows not 4-aligned)
__device__ __forceinline__ float4 raw4_load(const float* p, int n) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  x.x = __ldcg(p);
  if (n > 1) x.y = __ldcg(p + 1);
  if (n > 2) x.z = __ldcg(p + 2);
  if (n > 3) x.w = __ldcg(p + 3);
  return x;
}
__device__ __forceinline__ uint2 raw4_load(const __nv_bfloat16* p, int n) {
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  unsigned int e[4] = {__ldcg(q), 0u, 0u, 0u};
  if (n > 1) e[1] = __ldcg(q + 1);
  if (n > 2) e[2] = __ldcg(q + 2);
  if (n > 3) e[3] = __ldcg(q + 3);
  return make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
}
__device__ __forceinline__ float4 raw4_float(float4 x) { return x; }
__device__ __forceinline__ float4 raw4_float(uint2 x) {
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Where A[rr, k0 + kk] of a staged chunk lies: row groups of 4 are
// XOR-swizzled by kk / 8, so the 4-value column writes of a warp (8
// column groups x 4 rows) hit 32 distinct banks, and a group of 4 rows
// of one column still reads as one aligned float4.
__device__ __forceinline__ int stage_at(int kk, int rr) {
  return kk * kLds + 4 * ((rr >> 2) ^ (kk >> 3)) + (rr & 3);
}

// Rows 4*g .. 4*g+3 of column kk of a staged chunk.
__device__ __forceinline__ float4 stage_rows4(const float* stage, int kk,
                                              int g) {
  return *reinterpret_cast<const float4*>(stage + kk * kLds +
                                          4 * (g ^ (kk >> 3)));
}

// Stages one tile of `rows` rows of A (row pitch lda, rows past `rows`
// read as zero) chunk by chunk, rounded through TR, and calls
// multiply(k0) on each staged chunk. Each thread fetches kVec groups of
// 4 consecutive elements of the NEXT chunk (one 16- or 8-byte load each
// where A's rows allow it) into registers while the block multiplies the
// current one out of shared memory, so the L2 latency of the loads hides
// behind the products. Starts on a free staging area and ends with
// __syncthreads(), so the staging area is free again.
template <typename TA, typename TR, typename F>
__device__ __forceinline__ void staged_chunks(const TA* A, size_t lda,
                                              int rows, int K, float* stage,
                                              F&& multiply) {
  constexpr int kGroups = kKC / 4;                   // groups of 4 a row
  constexpr int kVec = kRows * kGroups / kThreads;   // groups a thread
  const int tid = threadIdx.x;
  const bool vec = K % 4 == 0 && lda % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(A) % (4 * sizeof(TA)) == 0;
  decltype(raw4_load(A)) pre[kVec];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int idx = tid + v * kThreads;
      const int rr = idx / kGroups;
      const int k = k0 + 4 * (idx - rr * kGroups);
      const TA* src = A + rr * lda + k;
      pre[v] = {};
      if (rr < rows && k < K)
        pre[v] = vec ? raw4_load(src) : raw4_load(src, min(4, K - k));
    }
  };
  const int kpad = round_up(K, kKC);
  fetch(0);
  for (int k0 = 0; k0 < kpad; k0 += kKC) {
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int idx = tid + v * kThreads;
      const int rr = idx / kGroups;
      const int kk = 4 * (idx - rr * kGroups);
      const float4 x = raw4_float(pre[v]);
      stage[stage_at(kk, rr)] = round_to<TR>(x.x);
      stage[stage_at(kk + 1, rr)] = round_to<TR>(x.y);
      stage[stage_at(kk + 2, rr)] = round_to<TR>(x.z);
      stage[stage_at(kk + 3, rr)] = round_to<TR>(x.w);
    }
    __syncthreads();
    if (k0 + kKC < kpad) fetch(k0 + kKC);
    multiply(k0);
    __syncthreads();
  }
}

// acc[i][n] = sum_k round_to<TR>(A[8*ty + i, k]) * Bs[k, tx + 16*n] over
// one tile of A (see staged_chunks): per column of a chunk a thread
// reads its 8 rows as two float4 and TN weights, and does 8*TN FMAs.
template <typename TA, typename TR, int TN>
__device__ __forceinline__ void tile_product(const TA* A, size_t lda,
                                             int rows, int K,
                                             const float* Bs, int N,
                                             float* stage,
                                             float (&acc)[kTM][TN]) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[i][n] = 0.f;
  bool col_ok[TN];
#pragma unroll
  for (int n = 0; n < TN; ++n) col_ok[n] = tx + 16 * n < N;
  staged_chunks<TA, TR>(A, lda, rows, K, stage, [&](int k0) {
#pragma unroll 8
    for (int kk = 0; kk < kKC; ++kk) {
      const float4 a0 = stage_rows4(stage, kk, 2 * ty);
      const float4 a1 = stage_rows4(stage, kk, 2 * ty + 1);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float* brow = Bs + (size_t)(k0 + kk) * N;
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const float bv = col_ok[n] ? brow[tx + 16 * n] : 0.f;
#pragma unroll
        for (int i = 0; i < kTM; ++i) acc[i][n] = fmaf(a[i], bv, acc[i][n]);
      }
    }
  });
}

// The product tile into shared memory as [kRows][N] (aliases the
// staging area, free after tile_product).
template <int TN>
__device__ __forceinline__ void spill_tile(float* tile, int N,
                                           const float (&acc)[kTM][TN]) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int col = tx + 16 * n;
      if (col < N) tile[(ty * kTM + i) * N + col] = acc[i][n];
    }
  __syncthreads();
}

// The longest row, min'd with T: steps at or past it change nothing.
__device__ __forceinline__ int steps_to_run(const int* lens, int B, int Tn) {
  __shared__ int s_max;
  if (threadIdx.x == 0) s_max = 0;
  __syncthreads();
  int m = 0;
  for (int r = threadIdx.x; r < B; r += blockDim.x) m = max(m, lens[r]);
  atomicMax(&s_max, m);
  __syncthreads();
  return min(s_max, Tn);
}

// One cooperative launch of `kernel` over `grid` blocks: all blocks are
// resident at once or the launch is refused (never a deadlocked
// barrier). The shared-memory limit is raised once per instantiation.
inline cudaError_t coop_launch(const void* kernel, int grid, size_t smem,
                               size_t& configured, void** args,
                               cudaStream_t stream, int threads = kThreads) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(grid),
                                              dim3(threads), args, smem,
                                              stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

inline bool dims_ok(int B, int Tn, int H, int U) {
  return B > 0 && Tn > 0 && H > 0 && U > 0 && U <= kMaxUnits;
}

}  // namespace rnn

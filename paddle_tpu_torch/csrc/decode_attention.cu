// Dense-cache decode attention for Hopper (sm_90a): one query per row
// over a [b, g, dh, T] cache.
//
// Replaces: paddle_tpu/ops/pallas_decode.py:_decode_kernel (launched by
// decode_attention; the decode path reaches it through
// paged_attention(use_kernel=True), which gathers the paged view and
// transposes it to this layout). Same function: for row b and query
// head h = g*rep + r, float32 scores sum_d q[b,h,d] k[b,g,d,t] scaled by
// scale*log2(e), positions t >= kv_len masked to NEG_INF (kv_len one
// length shared by every row, or per row), an exp2 softmax and the
// float32 sum over t of p_t v[b,g,d,t], divided by the sum of p, written
// in q's dtype. A row with kv_len 0 returns what the TPU kernel returns
// for it: every score is NEG_INF, so every weight is exp2(0) = 1 and the
// row is the mean of V over T.
//
// Rethought for the GPU: the TPU kernel runs a grid over kv groups with
// the whole batch's [b, dh, T] blocks of one group in VMEM. Here one
// block owns one (row b, kv group g) and serves the group's rep query
// heads:
//   1. scores — threads stride over T; the cache keeps T contiguous, so
//      the reads of k[b,g,d,t] coalesce across a warp; each thread
//      keeps its rep partial sums in registers and reads the q rows
//      (float32, in shared memory) as broadcasts;
//   2. softmax — a warp per query head takes the max and the sum of
//      exp2 over its T scores in shared memory, in place;
//   3. output — a warp per d row sums p_t v[b,g,d,t] over contiguous T
//      for all rep heads at once (one read of each V row), then a
//      warp-shuffle reduction.
//
// A row with kv_len > 0 walks only its first kv_len columns: every
// later column's weight is exp2(NEG_INF - m) = 0 exactly, so leaving it
// out changes no sum. A kv_len-0 row walks all T (the mean of V).
//
// What bounds it on an H100: bytes. A call must read each row's live
// columns of K and V once, 2 * g * dh * kv_len elements a row, against
// 4 * h * dh * kv_len flops — under one flop a byte. A simple kernel
// with b * g <= 64 blocks of three dependent phases pays latency above
// that; splitting T across blocks is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared
// -Xcompiler -fPIC (paddle_tpu_torch/ops/_build.py); bound with ctypes
// through the plain C function at the bottom.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kMaxRep = 32;
constexpr int kMaxHeadDim = 256;
constexpr size_t kMaxSmem = 227u * 1024u;  // per block, sm_90
constexpr float kNegInf = -1e30f;          // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// grid (B, G); block kThreads; dynamic shared (rep*DH + rep*T + rep)
// floats. MAXR >= rep is a power of two: the per-thread partial sums
// kept in registers. Layouts (all contiguous): q, out [B, H, DH];
// k, v [B, G, DH, T]; lens [n_lens] int32, n_lens 1 (shared) or B.
template <typename T, int MAXR>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ lens,
    T* __restrict__ out, int H, int G, int DH, int TL, int n_lens,
    float scale_log2) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int rep = H / G;
  float* qs = smem;                   // [rep][DH]
  float* sc = qs + rep * DH;          // [rep][TL]
  float* lsum = sc + rep * TL;        // [rep]
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int n_warps = blockDim.x / kWarp;
  const int len = lens[n_lens == 1 ? 0 : b];
  const int n = len > 0 ? min(len, TL) : TL;  // columns this row walks
  const size_t kv0 = ((size_t)b * G + g) * DH * (size_t)TL;

  for (int i = threadIdx.x; i < rep * DH; i += blockDim.x)
    qs[i] = to_f32(q[((size_t)b * H + g * rep) * DH + i]);
  __syncthreads();

  // 1. scores over T, threads striding over contiguous t
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    float acc[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;
    for (int d = 0; d < DH; ++d) {
      const float kk = to_f32(k[kv0 + (size_t)d * TL + t]);
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
        if (r < rep) acc[r] += qs[r * DH + d] * kk;
    }
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < rep) sc[r * TL + t] = t < len ? acc[r] * scale_log2 : kNegInf;
  }
  __syncthreads();

  // 2. exp2 softmax numerators in place, and their sums
  for (int r = warp; r < rep; r += n_warps) {
    float* row = sc + r * TL;
    float m = kNegInf;
    for (int t = lane; t < n; t += kWarp) m = fmaxf(m, row[t]);
    m = warp_max(m);
    float l = 0.f;
    for (int t = lane; t < n; t += kWarp) {
      const float p = exp2f(row[t] - m);
      row[t] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) lsum[r] = l;
  }
  __syncthreads();

  // 3. p . v over contiguous T, a warp per d row, every head at once
  for (int d = warp; d < DH; d += n_warps) {
    const T* vrow = v + kv0 + (size_t)d * TL;
    float acc[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;
    for (int t = lane; t < n; t += kWarp) {
      const float vv = to_f32(vrow[t]);
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
        if (r < rep) acc[r] += sc[r * TL + t] * vv;
    }
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r < rep) {
        const float a = warp_sum(acc[r]);
        if (lane == 0)
          out[((size_t)b * H + g * rep + r) * DH + d] =
              from_f32<T>(a / lsum[r]);
      }
    }
  }
}

template <typename T, int MAXR>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lens, void* out, int B, int H, int G, int DH,
                   int TL, int n_lens, float scale, cudaStream_t stream) {
  const int rep = H / G;
  const size_t smem = ((size_t)rep * DH + (size_t)rep * TL + rep) *
                      sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48u * 1024u) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T, MAXR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(B, G);
  decode_kernel<T, MAXR><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, static_cast<T*>(out), H, G, DH, TL,
      n_lens, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* lens, void* out, int B, int H, int G, int DH,
                     int TL, int n_lens, float scale, cudaStream_t stream) {
  const int rep = H / G;
  if (rep <= 1)
    return launch<T, 1>(q, k, v, lens, out, B, H, G, DH, TL, n_lens, scale,
                        stream);
  if (rep <= 2)
    return launch<T, 2>(q, k, v, lens, out, B, H, G, DH, TL, n_lens, scale,
                        stream);
  if (rep <= 4)
    return launch<T, 4>(q, k, v, lens, out, B, H, G, DH, TL, n_lens, scale,
                        stream);
  if (rep <= 8)
    return launch<T, 8>(q, k, v, lens, out, B, H, G, DH, TL, n_lens, scale,
                        stream);
  if (rep <= 16)
    return launch<T, 16>(q, k, v, lens, out, B, H, G, DH, TL, n_lens, scale,
                         stream);
  return launch<T, kMaxRep>(q, k, v, lens, out, B, H, G, DH, TL, n_lens,
                            scale, stream);
}

}  // namespace

// dtype (q, k, v and out): 0 float32, 1 bfloat16. n_lens: 1 (one length
// for every row) or B. Returns cudaGetLastError() after the launch (0 on
// success); the wrapper raises on anything else.
extern "C" int pt_decode_attention(const void* q, const void* k,
                                   const void* v, const void* lens,
                                   void* out, int B, int H, int G, int DH,
                                   int TL, int n_lens, float scale,
                                   int dtype, void* stream) {
  if (B <= 0 || G <= 0 || H % G != 0 || H / G > kMaxRep || DH <= 0 ||
      DH % 8 || DH > kMaxHeadDim || TL <= 0 ||
      (n_lens != 1 && n_lens != B))
    return (int)cudaErrorInvalidValue;
  const int* ln = static_cast<const int*>(lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch<float>(q, k, v, ln, out, B, H, G, DH, TL, n_lens, scale, st);
  else if (dtype == 1)
    e = dispatch<__nv_bfloat16>(q, k, v, ln, out, B, H, G, DH, TL, n_lens,
                                scale, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

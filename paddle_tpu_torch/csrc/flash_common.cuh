// Shared pieces of the flash-attention kernels for Hopper (sm_90a):
// tile loads into float32 shared memory and the two register-tiled
// SIMT products the SIMT forward (flash_attention_fwd.cu) is built
// from; the wgmma kernels (flash_{fwd,dq,dkv}_sm90.cu and
// flash_{dq,dkv}_tf32_sm90.cu) take only the constants, set_smem and
// shapes_ok.
//
// Layouts: q, out, dq [B, Tq, H, D]; k, v, dk, dv [B, Tk, H, D] (the
// layer's [b, T, h, d] order, read in place: head h of row t lies at
// ((b*T + t)*H + h)*D); lens [B, 2] int32 (q_len, kv_len); lse and
// the backward's D = rowsum(dO*O) [B, H, Tq] float32.
//
// A block holds kBlock = 64 rows of each operand in shared memory as
// float32 (bf16 is converted on load), rows padded to D + 4 floats so
// 16-byte row reads of 8 neighbouring threads fall on distinct banks.
// 256 threads form a 16 x 16 grid (ty, tx): in a score tile a thread
// owns rows 4*ty .. 4*ty+3 and columns tx + 16*j (j < 4); in an
// output tile it owns the same rows and the float4 column groups
// 4*tx + 64*jj (jj < NC, NC = ceil(D / 64)).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kBlock = 64;
constexpr int kThreads = 256;
constexpr int kPad = 4;
constexpr int kMaxHeadDim = 128;
constexpr size_t kMaxSmem = 227u * 1024u;
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
__device__ __forceinline__ void load16(float* dst, const T* src);

template <>
__device__ __forceinline__ void load16<float>(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

template <>
__device__ __forceinline__ void load16<__nv_bfloat16>(
    float* dst, const __nv_bfloat16* src) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h2[0]);
  const float2 b = __bfloat1622float2(h2[1]);
  const float2 c = __bfloat1622float2(h2[2]);
  const float2 d = __bfloat1622float2(h2[3]);
  *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(c.x, c.y, d.x, d.y);
}

__device__ __forceinline__ void store4(float* dst, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float a, float b,
                                       float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = raw;
}

// kBlock rows of D elements (global row stride gstride elements) into
// shared [kBlock][ld] float32; rows >= valid are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ s,
                                          const T* __restrict__ g,
                                          size_t gstride, int valid, int D,
                                          int ld) {
  constexpr int E = 16 / (int)sizeof(T);     // elements per 16 bytes
  const int per_row = D / E;
  for (int idx = threadIdx.x; idx < kBlock * per_row; idx += blockDim.x) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * E;
    float* dst = s + r * ld + c;
    if (r < valid) {
      load16<T>(dst, g + (size_t)r * gstride + c);
    } else {
#pragma unroll
      for (int e = 0; e < E; e += 4) store4(dst + e, 0.f, 0.f, 0.f, 0.f);
    }
  }
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[i][j] += sum_k A[4ty+i][k] * B[tx+16j][k], k < D (D % 4 == 0):
// a [64 x 64] tile of A * B^T from two [kBlock][ld] operands.
__device__ __forceinline__ void tile_abt(const float* __restrict__ A,
                                         const float* __restrict__ B, int ld,
                                         int D, int ty, int tx,
                                         float acc[4][4]) {
  const float* a = A + 4 * ty * ld;
  const float* b = B + tx * ld;
#pragma unroll 2
  for (int k = 0; k < D; k += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + i * ld + k);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + j * 16 * ld + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = acc[i][j];
        t = fmaf(av[i].x, bv[j].x, t);
        t = fmaf(av[i].y, bv[j].y, t);
        t = fmaf(av[i].z, bv[j].z, t);
        t = fmaf(av[i].w, bv[j].w, t);
        acc[i][j] = t;
      }
  }
}

// acc[i][4jj+e] += sum_n P[4ty+i][n] * V[n][4tx+64jj+e], n < kBlock:
// a [64 x D] tile of P * V from P [kBlock][ldp] and V [kBlock][ld].
template <int NC>
__device__ __forceinline__ void tile_pv(const float* __restrict__ P, int ldp,
                                        const float* __restrict__ V, int ld,
                                        int D, int ty, int tx,
                                        float acc[4][4 * NC]) {
  const float* p = P + 4 * ty * ldp;
#pragma unroll 2
  for (int n = 0; n < kBlock; n += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(p + i * ldp + n);
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) {
        const int c = 4 * tx + 64 * jj;
        if (c < D) {
          const float4 vv =
              *reinterpret_cast<const float4*>(V + (n + nn) * ld + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pn = comp(pv[i], nn);
            acc[i][4 * jj + 0] = fmaf(pn, vv.x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(pn, vv.y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(pn, vv.z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(pn, vv.w, acc[i][4 * jj + 3]);
          }
        }
      }
    }
  }
}

// max / sum over the 16 threads (tx) that share a row group
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// write a thread's [4 rows][4*NC] output tile (rows >= valid skipped)
template <typename T, int NC>
__device__ __forceinline__ void store_rows(T* __restrict__ g, size_t gstride,
                                           int valid, int D, int ty, int tx,
                                           const float acc[4][4 * NC],
                                           const float scale[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= valid) continue;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      const int c = 4 * tx + 64 * jj;
      if (c < D)
        store4(g + (size_t)r * gstride + c, acc[i][4 * jj] * scale[i],
               acc[i][4 * jj + 1] * scale[i], acc[i][4 * jj + 2] * scale[i],
               acc[i][4 * jj + 3] * scale[i]);
    }
  }
}

// Raise the kernel's dynamic shared-memory limit once, to the largest
// size asked for so far (`configured` is the caller's per-kernel
// static), so repeated launches — and launches captured into a CUDA
// graph — make no further attribute call.
inline cudaError_t set_smem(const void* kernel, size_t bytes,
                            size_t& configured) {
  if (bytes <= 48u * 1024u || bytes <= configured) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) configured = bytes;
  return e;
}

inline bool shapes_ok(int B, int H, int Tq, int Tk, int D) {
  return B > 0 && H > 0 && Tq > 0 && Tk > 0 && D > 0 && D % 8 == 0 &&
         D <= kMaxHeadDim && (long long)B * H <= 65535;
}

}  // namespace flash

// Shared pieces of the flash-attention kernels for Hopper (sm_90a),
// flash_{fwd,dq,dkv}_sm90.cu and flash_{fwd,dq,dkv}_tf32_sm90.cu: the
// constants, set_smem, shapes_ok, and the forward kernels' online
// softmax on accumulator fragments.
//
// Layouts: q, out, dq [B, Tq, H, D]; k, v, dk, dv [B, Tk, H, D] (the
// layer's [b, T, h, d] order, read in place: head h of row t lies at
// ((b*T + t)*H + h)*D); lens [B, 2] int32 (q_len, kv_len); lse and
// the backward's D = rowsum(dO*O) [B, H, Tq] float32.

#pragma once

#include "sm90_pipeline.cuh"

namespace flash {

constexpr int kMaxHeadDim = 128;
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// One score tile, the f32 accumulator of an m64nN product (S = N / 2
// floats a thread, the fragment map of sm90_pipeline.cuh), masked
// (Masked) or not, folded into the running (m, l, O) of the thread's two
// rows: s comes back as p = exp2(s scale_log2 - m), 0 on masked
// entries, and O and l are rescaled. A row sits in the 4 threads of a
// quad: two shfl_xor for its max; l is kept per thread and reduced over
// the quad once, at the end.
template <bool Masked, int S, int NP>
__device__ __forceinline__ void online_softmax(
    float (&s)[S], float (&o)[NP][32], float (&m)[2], float (&l)[2],
    float scale_log2, int row0, int k0, int q_len, int kv_len, int causal,
    int lane) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < S; ++i) {
    float x = s[i] * scale_log2;
    if (Masked) {
      const int row = row0 + 8 * ((i >> 1) & 1);
      const int col = k0 + sm90::frag_col(i, lane);
      if (!(row < q_len && col < kv_len && (!causal || col <= row)))
        x = kNegInf;
    }
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  float alpha[2], mnew[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    mnew[h] = fmaxf(m[h], mx[h]);
    alpha[h] = exp2f(m[h] - mnew[h]);
    m[h] = mnew[h];
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int h = (i >> 1) & 1;
    // explicit zero on masked entries: a row masked in every tile so
    // far has mnew == NEG_INF and would see exp2(0) == 1
    const float p = (Masked && s[i] == kNegInf) ? 0.f : exp2f(s[i] - mnew[h]);
    s[i] = p;
    l[h] += p;
  }
#pragma unroll
  for (int pnl = 0; pnl < NP; ++pnl)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[pnl][i] *= alpha[(i >> 1) & 1];
}

inline bool shapes_ok(int B, int H, int Tq, int Tk, int D) {
  return B > 0 && H > 0 && Tq > 0 && Tk > 0 && D > 0 && D % 8 == 0 &&
         D <= kMaxHeadDim && (long long)B * H <= 65535;
}

}  // namespace flash

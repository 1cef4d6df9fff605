// Fused LSTM sequence backward for Hopper (sm_90a), float32.
//
// Replaces: paddle_tpu/ops/pallas_rnn.py:_lstm_bwd_kernel (launched by
// _lstm_bwd) for float32 weights: bfloat16 takes lstm_bwd_sm90.cu, the
// same plan with its product on the tensor cores. Same function: in
// reverse time, from the forward's activated gates and c sequence, the
// output cotangent dh_seq and the final-state cotangents dhT / dcT, it
// carries (dh, dc) and emits dz, the cotangent of the gate
// pre-activations:
//   dh_t = dh + [valid] dh_seq[t]
//   dzo = dh_t*tanh(c_t)*o*(1-o)
//   dc_t = dc + dh_t*o*(1-tanh(c_t)^2) + dzo*po
//   dzi = dc_t*c~*i*(1-i), dzf = dc_t*c_{t-1}*f*(1-f), dzc = dc_t*i*(1-c~^2)
//   dz_t = [valid] [dzi, dzf, dzc, dzo]
//   dh <- [valid] dz_t W^T,   dc <- [valid] dc_t*f + dzi*pi + dzf*pf
// (c_{t-1} is 0 at t = 0; an invalid step zeroes dz and passes dh and
// dc through unchanged). dz is stored in the product dtype T and enters
// dz W^T rounded to it; everything else is float32. The weight, bias and
// peephole gradients are large contractions over dz outside the kernel,
// as in the JAX package (ops/fused_rnn.py).
//
// Rethought for the GPU: the TPU kernel walks grid=(T,) backwards with
// dh/dc in VMEM. Here one cooperative launch runs the whole reverse
// sequence (rnn_common.cuh): block x owns the hidden units
// [x*U, x*U+U) and keeps the weight ROWS W[j, :] of those units in
// shared memory ([4H, U] float32: 200 KB at H 1280, U 10). Each step it
// (a) computes dz_t for its units from its own dh/dc carries and writes
// it into the dz output, (b) meets the other blocks at a grid barrier,
// (c) reads all of dz_t back (L2) and forms dh_{t-1} of its units as
// dz_t W[j, :]^T. The carries never leave their owner, so one barrier a
// step suffices; dz_{t-1} goes to another slot of the output, so a block
// may run ahead into the next step. Steps past the longest row are not
// run: dz is 0 there and the carries pass through.
//
// What bounds it on an H100: dz W^T at B 128, H 1280 over 100 valid
// steps is 167.8 GFLOP (0.17 ms at the bf16 tensor-core peak), the
// streams about 0.4 GB in bf16 (0.12 ms at 3.35 TB/s): operation-bound,
// plus a barrier per step. This version multiplies on the SIMT float32
// units (>= 2.5 ms at 67 TFLOP/s).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler
// -fPIC (paddle_tpu_torch/ops/_build.py); bound with ctypes through the
// plain C function at the bottom.

#include "rnn_common.cuh"

namespace {

using namespace rnn;

// acc[i][c] = sum_k A[8*ty + i, k] * Bs[k, c] (c < pitch, pitch even)
// over one tile of A, the depth split across the 16 lanes tx of a row
// group: in each staged chunk lane tx takes columns tx and tx + 16 of
// the chunk, reads its 8 rows as two float4 and the weights of all the
// block's units as pitch/2 float2 (conflict-free for any even pitch),
// and does 8*pitch FMAs; a butterfly over the 16 lanes sums the partial
// products at the end, so every lane holds the whole tile row.
template <typename T, int NB>
__device__ __forceinline__ void tile_product_split_k(
    const T* A, size_t lda, int rows, int K, const float* Bs, int pitch,
    float* stage, float (&acc)[kTM][NB]) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int c = 0; c < NB; ++c) acc[i][c] = 0.f;
  staged_chunks<T, float>(A, lda, rows, K, stage, [&](int k0) {
#pragma unroll
    for (int half = 0; half < kKC / 16; ++half) {
      const int kk = tx + 16 * half;
      const float4 a0 = stage_rows4(stage, kk, 2 * ty);
      const float4 a1 = stage_rows4(stage, kk, 2 * ty + 1);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float* brow = Bs + (size_t)(k0 + kk) * pitch;
#pragma unroll
      for (int c = 0; c < NB; c += 2) {
        if (c < pitch) {
          const float2 bv = *reinterpret_cast<const float2*>(brow + c);
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            acc[i][c] = fmaf(a[i], bv.x, acc[i][c]);
            acc[i][c + 1] = fmaf(a[i], bv.y, acc[i][c + 1]);
          }
        }
      }
    }
  });
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int c = 0; c < NB; ++c)
      if (c < pitch) {
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], off);
      }
}

template <typename T, int NB>
__global__ void __launch_bounds__(kThreads, 1) lstm_bwd_kernel(
    const T* __restrict__ w, const float* __restrict__ peep,
    const int* __restrict__ lens, const T* __restrict__ gates,
    const T* __restrict__ cseq, const T* __restrict__ dhseq,
    const float* __restrict__ dhT, const float* __restrict__ dcT, T* dz,
    float* __restrict__ dh, float* __restrict__ dc, unsigned int* bar, int B,
    int Tn, int H, int U) {
  extern __shared__ __align__(16) float smem[];
  const int K = 4 * H;
  const int kpad = round_up(K, kKC);
  const int pitch = U + (U & 1);              // even, for float2 reads
  float* ws = smem;                           // [kpad][pitch]
  float* stage = smem + (size_t)kpad * pitch;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int j0 = blockIdx.x * U;
  const int uu = min(U, H - j0);
  const size_t H4 = (size_t)K;

  // the block's weight rows: ws[k][jj] = W[j0 + jj][k]
  for (int idx = tid; idx < kpad * pitch; idx += kThreads) {
    const int jj = idx / kpad;
    const int k = idx - jj * kpad;
    ws[k * pitch + jj] =
        (k < K && jj < uu) ? to_f(w[(j0 + jj) * H4 + k]) : 0.f;
  }
  const int t_end = steps_to_run(lens, B, Tn);
  const T zero = from_f<T>(0.f);
  for (int p = tid; p < B * uu; p += kThreads) {
    const int r = p / uu;
    const int j = j0 + (p - r * uu);
    const size_t s = (size_t)r * H + j;
    dh[s] = dhT[s];
    dc[s] = dcT[s];
    for (int t = t_end; t < Tn; ++t) {
      T* dr = dz + ((size_t)r * Tn + t) * H4;
      for (int g = 0; g < 4; ++g) dr[g * H + j] = zero;
    }
  }
  __syncthreads();

  unsigned int epoch = 0;
  for (int t = t_end - 1; t >= 0; --t) {
    // (a) dz_t of the owned units
    for (int p = tid; p < B * uu; p += kThreads) {
      const int r = p / uu;
      const int j = j0 + (p - r * uu);
      const size_t s = (size_t)r * H + j;
      const size_t row = (size_t)r * Tn + t;
      const bool valid = t < lens[r];
      const T* g4 = gates + row * H4;
      const float ig = to_f(g4[j]);
      const float fg = to_f(g4[H + j]);
      const float cand = to_f(g4[2 * H + j]);
      const float og = to_f(g4[3 * H + j]);
      const float ct = to_f(cseq[row * H + j]);
      const float cp = t > 0 ? to_f(cseq[(row - 1) * H + j]) : 0.f;
      const float dht = dh[s] + (valid ? to_f(dhseq[row * H + j]) : 0.f);
      const float tc = tanhf(ct);
      const float dov = dht * tc;
      const float dzo = dov * og * (1.f - og);
      const float dct = dc[s] + dht * og * (1.f - tc * tc) + dzo * peep[2 * H + j];
      const float di = dct * cand;
      const float dzi = di * ig * (1.f - ig);
      const float df = dct * cp;
      const float dzf = df * fg * (1.f - fg);
      const float dg = dct * ig;
      const float dzc = dg * (1.f - cand * cand);
      T* dr = dz + row * H4;
      dr[j] = from_f<T>(valid ? dzi : 0.f);
      dr[H + j] = from_f<T>(valid ? dzf : 0.f);
      dr[2 * H + j] = from_f<T>(valid ? dzc : 0.f);
      dr[3 * H + j] = from_f<T>(valid ? dzo : 0.f);
      if (valid) dc[s] = dct * fg + dzi * peep[j] + dzf * peep[H + j];
    }
    grid_sync(bar, ++epoch);
    // (c) dh_{t-1} = dz_t W[j, :]^T for the owned units
    for (int r0 = 0; r0 < B; r0 += kRows) {
      const int rows = min(kRows, B - r0);
      float acc[kTM][NB];
      // dz is stored in T already: no second rounding on the way in
      tile_product_split_k<T, NB>(dz + ((size_t)r0 * Tn + t) * H4,
                                  (size_t)Tn * H4, rows, K, ws, pitch, stage,
                                  acc);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int r = r0 + ty * kTM + i;
        float v = 0.f;
#pragma unroll
        for (int c = 0; c < NB; ++c) v = c == tx ? acc[i][c] : v;
        if (r < B && tx < uu && t < lens[r]) dh[(size_t)r * H + j0 + tx] = v;
      }
    }
    __syncthreads();                   // dh is read by other threads in (a)
  }
}

template <typename T, int NB>
cudaError_t launch(const void* w, const float* peep, const int* lens,
                   const void* gates, const void* cseq, const void* dhseq,
                   const float* dhT, const float* dcT, void* dz, float* dh,
                   float* dc, unsigned int* bar, int B, int Tn, int H, int U,
                   cudaStream_t stream) {
  const T* w_ = static_cast<const T*>(w);
  const T* gates_ = static_cast<const T*>(gates);
  const T* cseq_ = static_cast<const T*>(cseq);
  const T* dhseq_ = static_cast<const T*>(dhseq);
  T* dz_ = static_cast<T*>(dz);
  void* args[] = {&w_, &peep, &lens, &gates_, &cseq_, &dhseq_, &dhT, &dcT,
                  &dz_, &dh, &dc, &bar, &B, &Tn, &H, &U};
  const size_t smem = smem_floats(4 * H, U + (U & 1), 0) * sizeof(float);
  static size_t configured = 0;
  return coop_launch((const void*)lstm_bwd_kernel<T, NB>, (H + U - 1) / U,
                     smem, configured, args, stream);
}

template <typename T>
cudaError_t dispatch(const void* w, const float* peep, const int* lens,
                     const void* gates, const void* cseq, const void* dhseq,
                     const float* dhT, const float* dcT, void* dz, float* dh,
                     float* dc, unsigned int* bar, int B, int Tn, int H, int U,
                     cudaStream_t st) {
  if (U <= 4)
    return launch<T, 4>(w, peep, lens, gates, cseq, dhseq, dhT, dcT, dz, dh,
                        dc, bar, B, Tn, H, U, st);
  if (U <= 8)
    return launch<T, 8>(w, peep, lens, gates, cseq, dhseq, dhT, dcT, dz, dh,
                        dc, bar, B, Tn, H, U, st);
  if (U <= 12)
    return launch<T, 12>(w, peep, lens, gates, cseq, dhseq, dhT, dcT, dz, dh,
                         dc, bar, B, Tn, H, U, st);
  return launch<T, 16>(w, peep, lens, gates, cseq, dhseq, dhT, dcT, dz, dh,
                       dc, bar, B, Tn, H, U, st);
}

}  // namespace

// w [H, 4H], gates [B, T, 4H], cseq and dhseq [B, T, H] and dz [B, T, 4H]
// in the product dtype, which must be 0 (float32: bfloat16 takes
// lstm_bwd_sm90.cu); peep [3H], dhT, dcT and the scratch carries dh, dc
// [B, H] float32; lens [B] int32; bar one zeroed uint32. Returns the CUDA
// error of the launch (0 on success).
extern "C" int pt_lstm_bwd(const void* w, const void* peep, const void* lens,
                           const void* gates, const void* cseq,
                           const void* dhseq, const void* dhT,
                           const void* dcT, void* dz, void* dh, void* dc,
                           void* bar, int B, int Tn, int H, int U, int dtype,
                           void* stream) {
  if (!dims_ok(B, Tn, H, U)) return (int)cudaErrorInvalidValue;
  const float* p = static_cast<const float*>(peep);
  const int* ln = static_cast<const int*>(lens);
  const float* dht = static_cast<const float*>(dhT);
  const float* dct = static_cast<const float*>(dcT);
  float* dh_ = static_cast<float*>(dh);
  float* dc_ = static_cast<float*>(dc);
  unsigned int* br = static_cast<unsigned int*>(bar);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch<float>(w, p, ln, gates, cseq, dhseq, dht, dct, dz,
                              dh_, dc_, br, B, Tn, H, U, st);
}

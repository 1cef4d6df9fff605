// Fused LSTM sequence forward for Hopper (sm_90a), float32.
//
// Replaces: paddle_tpu/ops/pallas_rnn.py:_lstm_kernel (launched by
// _lstm_fwd_call, public lstm_sequence) for float32 weights: bfloat16
// takes lstm_fwd_sm90.cu, the same plan with its product on the tensor
// cores. Same function: for each step t
//   z = x4[:, t] + round(h) @ W + bias          (gates [i, f, c~, o])
//   i = sig(zi + pi*c), f = sig(zf + pf*c), c~ = tanh(zc)
//   c' = f*c + i*c~,    o = sig(zo + po*c'),  h' = o*tanh(c')
// with the ragged rule valid = t < lens[r]: an invalid step freezes h
// and c, writes 0 to the output and the final state is the last valid
// step's. With residuals (the training call) it also writes the frozen
// c sequence and the activated gates. Rounding points are the TPU
// kernel's: x4, W and h enter the product in the product dtype T
// (float32 or bfloat16), the h stream, c sequence and gates are stored
// in T; hT, cT, bias, peepholes and all gate math are float32, and
// products accumulate in float32.
//
// Rethought for the GPU: the TPU kernel runs grid=(T,) in order on one
// core and carries h/c in VMEM with W resident there. Here one
// cooperative launch runs the whole sequence (rnn_common.cuh): block x
// owns the hidden units [x*U, x*U+U) for all four gates, keeps the
// weight columns W[:, g*H + j] of those units in shared memory ([H, 4U]
// float32: 200 KB at H 1280, U 10 over 128 blocks), computes its
// [B, 4U] slice of z each step from h_{t-1} read out of a double-buffered
// float32 global h (L2-resident), does the gate math for its units (so
// the c carry never leaves its owner), writes h_t, and meets the other
// blocks at a grid barrier: one barrier per step. Steps past the longest
// row are not run; their outputs are written as 0 (c sequence: the
// frozen c, gates: 0), which is what the backward reads for them.
//
// What bounds it on an H100: at B 128, H 1280 and 100 valid steps the
// products are 2*B*H*4H*100 = 167.8 GFLOP (0.17 ms at the 989 TFLOP/s of
// the bf16 tensor cores) against about 0.43 GB of streams in bf16
// (0.13 ms at 3.35 TB/s): operation-bound, and the chain of dependent
// steps adds a barrier per step. This kernel multiplies on the SIMT
// float32 units (67 TFLOP/s peak: >= 2.5 ms in float32).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler
// -fPIC (paddle_tpu_torch/ops/_build.py); bound with ctypes through the
// plain C function at the bottom.

#include "rnn_common.cuh"

namespace {

using namespace rnn;

template <typename T, int TN>
__global__ void __launch_bounds__(kThreads, 1) lstm_fwd_kernel(
    const T* __restrict__ x4, const T* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ peep,
    const int* __restrict__ lens, T* __restrict__ out, T* __restrict__ cseq,
    T* __restrict__ gates, float* __restrict__ hT, float* __restrict__ cT,
    float* hbuf, unsigned int* bar, int B, int Tn, int H, int U) {
  extern __shared__ __align__(16) float smem[];
  const int N = 4 * U;
  const int kpad = round_up(H, kKC);
  float* ws = smem;                           // [kpad][4U]
  float* stage = smem + (size_t)kpad * N;     // staging / [kRows][4U] tile
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * U;
  const int uu = min(U, H - j0);
  const size_t H4 = 4 * (size_t)H;
  const size_t BH = (size_t)B * H;

  // the block's weight columns: ws[k][g*U + jj] = W[k][g*H + j0 + jj]
  for (int idx = tid; idx < kpad * N; idx += kThreads) {
    const int k = idx / N;
    const int c = idx - k * N;
    const int g = c / U;
    const int jj = c - g * U;
    ws[idx] = (k < H && jj < uu) ? to_f(w[k * H4 + g * H + j0 + jj]) : 0.f;
  }
  // the c carry lives in cT, touched by its owner only
  for (int p = tid; p < B * uu; p += kThreads) {
    const int r = p / uu;
    cT[(size_t)r * H + j0 + (p - r * uu)] = 0.f;
  }
  const int t_end = steps_to_run(lens, B, Tn);   // also syncs the block

  unsigned int epoch = 0;
  for (int t = 0; t < t_end; ++t) {
    const float* hin = hbuf + (size_t)(t & 1) * BH;
    float* hout = hbuf + (size_t)((t + 1) & 1) * BH;
    for (int r0 = 0; r0 < B; r0 += kRows) {
      const int rows = min(kRows, B - r0);
      float acc[kTM][TN];
      tile_product<float, T, TN>(hin + (size_t)r0 * H, H, rows, H, ws, N,
                                 stage, acc);
      spill_tile<TN>(stage, N, acc);
      for (int p = tid; p < rows * uu; p += kThreads) {
        const int rr = p / uu;
        const int jj = p - rr * uu;
        const int r = r0 + rr;
        const int j = j0 + jj;
        const size_t row = (size_t)r * Tn + t;
        const T* xr = x4 + row * H4;
        const float* zr = stage + rr * N;
        const float zi = to_f(xr[j]) + zr[jj] + bias[j];
        const float zf = to_f(xr[H + j]) + zr[U + jj] + bias[H + j];
        const float zc = to_f(xr[2 * H + j]) + zr[2 * U + jj] + bias[2 * H + j];
        const float zo = to_f(xr[3 * H + j]) + zr[3 * U + jj] + bias[3 * H + j];
        const size_t s = (size_t)r * H + j;
        const float c = cT[s];
        const float hp = __ldcg(hin + s);
        const float ig = sigmoid(zi + peep[j] * c);
        const float fg = sigmoid(zf + peep[H + j] * c);
        const float cand = tanhf(zc);
        const float cn = fg * c + ig * cand;
        const float og = sigmoid(zo + peep[2 * H + j] * cn);
        const float hn = og * tanhf(cn);
        const bool valid = t < lens[r];
        const float ck = valid ? cn : c;
        hout[s] = valid ? hn : hp;
        cT[s] = ck;
        out[row * H + j] = from_f<T>(valid ? hn : 0.f);
        if (cseq != nullptr) {
          cseq[row * H + j] = from_f<T>(ck);
          T* gr = gates + row * H4;
          gr[j] = from_f<T>(ig);
          gr[H + j] = from_f<T>(fg);
          gr[2 * H + j] = from_f<T>(cand);
          gr[3 * H + j] = from_f<T>(og);
        }
      }
      __syncthreads();                 // the tile area is staged into next
    }
    grid_sync(bar, ++epoch);
  }

  // final state, and the steps past the longest row
  const float* hfin = hbuf + (size_t)(t_end & 1) * BH;
  for (int p = tid; p < B * uu; p += kThreads) {
    const int r = p / uu;
    const int j = j0 + (p - r * uu);
    const size_t s = (size_t)r * H + j;
    hT[s] = __ldcg(hfin + s);
    const T c = from_f<T>(cT[s]);
    const T zero = from_f<T>(0.f);
    for (int t = t_end; t < Tn; ++t) {
      const size_t row = (size_t)r * Tn + t;
      out[row * H + j] = zero;
      if (cseq != nullptr) {
        cseq[row * H + j] = c;
        T* gr = gates + row * H4;
        for (int g = 0; g < 4; ++g) gr[g * H + j] = zero;
      }
    }
  }
}

template <typename T, int TN>
cudaError_t launch(const void* x4, const void* w, const float* bias,
                   const float* peep, const int* lens, void* out, void* cseq,
                   void* gates, float* hT, float* cT, float* hbuf,
                   unsigned int* bar, int B, int Tn, int H, int U,
                   cudaStream_t stream) {
  const T* x4_ = static_cast<const T*>(x4);
  const T* w_ = static_cast<const T*>(w);
  T* out_ = static_cast<T*>(out);
  T* cseq_ = static_cast<T*>(cseq);
  T* gates_ = static_cast<T*>(gates);
  void* args[] = {&x4_, &w_, &bias, &peep, &lens, &out_, &cseq_, &gates_,
                  &hT, &cT, &hbuf, &bar, &B, &Tn, &H, &U};
  const size_t smem = smem_floats(H, 4 * U, 4 * U) * sizeof(float);
  static size_t configured = 0;
  return coop_launch((const void*)lstm_fwd_kernel<T, TN>, (H + U - 1) / U,
                     smem, configured, args, stream);
}

template <typename T>
cudaError_t dispatch(const void* x4, const void* w, const float* bias,
                     const float* peep, const int* lens, void* out,
                     void* cseq, void* gates, float* hT, float* cT,
                     float* hbuf, unsigned int* bar, int B, int Tn, int H,
                     int U, cudaStream_t st) {
  switch ((4 * U + 15) / 16) {
    case 1:
      return launch<T, 1>(x4, w, bias, peep, lens, out, cseq, gates, hT, cT,
                          hbuf, bar, B, Tn, H, U, st);
    case 2:
      return launch<T, 2>(x4, w, bias, peep, lens, out, cseq, gates, hT, cT,
                          hbuf, bar, B, Tn, H, U, st);
    case 3:
      return launch<T, 3>(x4, w, bias, peep, lens, out, cseq, gates, hT, cT,
                          hbuf, bar, B, Tn, H, U, st);
    default:
      return launch<T, 4>(x4, w, bias, peep, lens, out, cseq, gates, hT, cT,
                          hbuf, bar, B, Tn, H, U, st);
  }
}

}  // namespace

// x4 [B, T, 4H] and w [H, 4H] in the product dtype, which must be 0
// (float32: bfloat16 takes lstm_fwd_sm90.cu), like out / cseq / gates;
// bias [4H], peep [3H], hT, cT [B, H] and hbuf [2, B, H] (zeroed)
// float32; lens [B] int32; bar one zeroed uint32. cseq and gates null:
// no residuals. U hidden units per block (<= 16). Returns the CUDA error
// of the launch (0 on success).
extern "C" int pt_lstm_fwd(const void* x4, const void* w, const void* bias,
                           const void* peep, const void* lens, void* out,
                           void* cseq, void* gates, void* hT, void* cT,
                           void* hbuf, void* bar, int B, int Tn, int H, int U,
                           int dtype, void* stream) {
  if (!dims_ok(B, Tn, H, U) || (cseq == nullptr) != (gates == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  const float* p = static_cast<const float*>(peep);
  const int* ln = static_cast<const int*>(lens);
  float* ht = static_cast<float*>(hT);
  float* ct = static_cast<float*>(cT);
  float* hb = static_cast<float*>(hbuf);
  unsigned int* br = static_cast<unsigned int*>(bar);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch<float>(x4, w, b, p, ln, out, cseq, gates, ht, ct, hb,
                              br, B, Tn, H, U, st);
}

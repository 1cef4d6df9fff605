// Fused GRU sequence forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_rnn.py:_gru_kernel (launched by
// _gru_call, public gru_sequence when no gradient is taken). Same
// function, gates [z, r, c~]: for each step t
//   [zz, zr] = x3[:, t, :2H] + round(h) @ W[:, :2H] + b[:2H]
//   z = sig(zz), r = sig(zr)
//   c~ = x3[:, t, 2H:] + round(r*h) @ W[:, 2H:] + b[2H:]
//   h' = (1-z)*h + z*tanh(c~)
// with the ragged rule valid = t < lens[r] (an invalid step freezes h
// and writes 0; the final state is the last valid step's). x3, W and
// the two product inputs are in the product dtype T; the output, hT,
// the bias and all gate math are float32.
//
// Serves only the wide-h shapes: where no cluster of at most 8 blocks
// holds W in shared memory (ops/fused_rnn.py gru_fwd_plan; on an H100
// float32 past h 384, bfloat16 past h 544), up to kernel_ok's limit.
// Narrower h takes gru_fwd_sm90.cu, which needs no grid barrier.
//
// Design: one cooperative launch runs the whole sequence
// (rnn_common.cuh). Block x owns the hidden units [x*U, x*U+U) and
// keeps their z, r and candidate columns of W in shared memory. The
// candidate needs r*h of EVERY unit, so a step is (1) z, r of the owned
// units from h_{t-1}, r*h to a global buffer, grid barrier, (2) the
// candidate from all of r*h, h_t to a double-buffered global h, grid
// barrier. Steps past the longest row are not run. Two dependent grid
// barriers a step and every block re-reading all of h and r*h from L2
// bound it, not its flops or bytes.
//
// Build: as lstm_bwd_bf16x3_sm90.cu.

#include "rnn_common.cuh"

namespace {

using namespace rnn;

template <typename T, int TN>
__global__ void __launch_bounds__(kThreads, 1) gru_fwd_kernel(
    const T* __restrict__ x3, const T* __restrict__ w,
    const float* __restrict__ bias, const int* __restrict__ lens,
    float* __restrict__ out, float* __restrict__ hT, float* hbuf,
    float* __restrict__ zbuf, float* rhbuf, unsigned int* bar, int B, int Tn,
    int H, int U) {
  extern __shared__ __align__(16) float smem[];
  const int N1 = 2 * U;
  const int kpad = round_up(H, kKC);
  float* wg = smem;                             // [kpad][2U]
  float* wc = wg + (size_t)kpad * N1;           // [kpad][U]
  float* stage = wc + (size_t)kpad * U;
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * U;
  const int uu = min(U, H - j0);
  const size_t H3 = 3 * (size_t)H;
  const size_t BH = (size_t)B * H;

  for (int idx = tid; idx < kpad * N1; idx += kThreads) {
    const int k = idx / N1;
    const int c = idx - k * N1;
    const int g = c / U;
    const int jj = c - g * U;
    wg[idx] = (k < H && jj < uu) ? to_f(w[k * H3 + g * H + j0 + jj]) : 0.f;
  }
  for (int idx = tid; idx < kpad * U; idx += kThreads) {
    const int k = idx / U;
    const int jj = idx - k * U;
    wc[idx] = (k < H && jj < uu) ? to_f(w[k * H3 + 2 * H + j0 + jj]) : 0.f;
  }
  const int t_end = steps_to_run(lens, B, Tn);

  unsigned int epoch = 0;
  for (int t = 0; t < t_end; ++t) {
    const float* hin = hbuf + (size_t)(t & 1) * BH;
    float* hout = hbuf + (size_t)((t + 1) & 1) * BH;
    // (1) update and reset gates; r*h to the shared buffer
    for (int r0 = 0; r0 < B; r0 += kRows) {
      const int rows = min(kRows, B - r0);
      float acc[kTM][TN];
      tile_product<float, T, TN>(hin + (size_t)r0 * H, H, rows, H, wg, N1,
                                 stage, acc);
      spill_tile<TN>(stage, N1, acc);
      for (int p = tid; p < rows * uu; p += kThreads) {
        const int rr = p / uu;
        const int jj = p - rr * uu;
        const int r = r0 + rr;
        const int j = j0 + jj;
        const T* xr = x3 + ((size_t)r * Tn + t) * H3;
        const float* zr = stage + rr * N1;
        const float zg = sigmoid(to_f(xr[j]) + zr[jj] + bias[j]);
        const float rg = sigmoid(to_f(xr[H + j]) + zr[U + jj] + bias[H + j]);
        const size_t s = (size_t)r * H + j;
        zbuf[s] = zg;
        rhbuf[s] = rg * __ldcg(hin + s);
      }
      __syncthreads();
    }
    grid_sync(bar, ++epoch);
    // (2) candidate from all of r*h; the new h
    for (int r0 = 0; r0 < B; r0 += kRows) {
      const int rows = min(kRows, B - r0);
      float acc[kTM][1];
      tile_product<float, T, 1>(rhbuf + (size_t)r0 * H, H, rows, H, wc, U,
                                stage, acc);
      spill_tile<1>(stage, U, acc);
      for (int p = tid; p < rows * uu; p += kThreads) {
        const int rr = p / uu;
        const int jj = p - rr * uu;
        const int r = r0 + rr;
        const int j = j0 + jj;
        const size_t row = (size_t)r * Tn + t;
        const float cand =
            to_f(x3[row * H3 + 2 * H + j]) + stage[rr * U + jj] + bias[2 * H + j];
        const size_t s = (size_t)r * H + j;
        const float zg = zbuf[s];
        const float hp = __ldcg(hin + s);
        const float hn = (1.f - zg) * hp + zg * tanhf(cand);
        const bool valid = t < lens[r];
        hout[s] = valid ? hn : hp;
        out[row * H + j] = valid ? hn : 0.f;
      }
      __syncthreads();
    }
    grid_sync(bar, ++epoch);
  }

  const float* hfin = hbuf + (size_t)(t_end & 1) * BH;
  for (int p = tid; p < B * uu; p += kThreads) {
    const int r = p / uu;
    const int j = j0 + (p - r * uu);
    const size_t s = (size_t)r * H + j;
    hT[s] = __ldcg(hfin + s);
    for (int t = t_end; t < Tn; ++t) out[((size_t)r * Tn + t) * H + j] = 0.f;
  }
}

template <typename T, int TN>
cudaError_t launch(const void* x3, const void* w, const float* bias,
                   const int* lens, float* out, float* hT, float* hbuf,
                   float* zbuf, float* rhbuf, unsigned int* bar, int B, int Tn,
                   int H, int U, cudaStream_t stream) {
  const T* x3_ = static_cast<const T*>(x3);
  const T* w_ = static_cast<const T*>(w);
  void* args[] = {&x3_, &w_, &bias, &lens, &out, &hT, &hbuf, &zbuf, &rhbuf,
                  &bar, &B, &Tn, &H, &U};
  const size_t smem = smem_floats(H, 3 * U, 2 * U) * sizeof(float);
  static size_t configured = 0;
  return coop_launch((const void*)gru_fwd_kernel<T, TN>, (H + U - 1) / U,
                     smem, configured, args, stream);
}

template <typename T>
cudaError_t dispatch(const void* x3, const void* w, const float* bias,
                     const int* lens, float* out, float* hT, float* hbuf,
                     float* zbuf, float* rhbuf, unsigned int* bar, int B,
                     int Tn, int H, int U, cudaStream_t st) {
  if (2 * U <= 16)
    return launch<T, 1>(x3, w, bias, lens, out, hT, hbuf, zbuf, rhbuf, bar, B,
                        Tn, H, U, st);
  return launch<T, 2>(x3, w, bias, lens, out, hT, hbuf, zbuf, rhbuf, bar, B,
                      Tn, H, U, st);
}

}  // namespace

// x3 [B, T, 3H] and w [H, 3H] in the product dtype (0 float32,
// 1 bfloat16); bias [3H], out [B, T, H], hT [B, H], hbuf [2, B, H]
// (zeroed) and the scratch zbuf, rhbuf [B, H] float32; lens [B] int32;
// bar one zeroed uint32. Returns the CUDA error of the launch.
extern "C" int pt_gru_fwd(const void* x3, const void* w, const void* bias,
                          const void* lens, void* out, void* hT, void* hbuf,
                          void* zbuf, void* rhbuf, void* bar, int B, int Tn,
                          int H, int U, int dtype, void* stream) {
  if (!dims_ok(B, Tn, H, U)) return (int)cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  const int* ln = static_cast<const int*>(lens);
  float* o = static_cast<float*>(out);
  float* ht = static_cast<float*>(hT);
  float* hb = static_cast<float*>(hbuf);
  float* zb = static_cast<float*>(zbuf);
  float* rb = static_cast<float*>(rhbuf);
  unsigned int* br = static_cast<unsigned int*>(bar);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch<float>(x3, w, b, ln, o, ht, hb, zb, rb, br, B, Tn, H, U, st);
  else if (dtype == 1)
    e = dispatch<__nv_bfloat16>(x3, w, b, ln, o, ht, hb, zb, rb, br, B, Tn, H,
                                U, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

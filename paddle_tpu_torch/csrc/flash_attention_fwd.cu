// Flash-attention forward for Hopper (sm_90a), float32 route.
//
// Replaces: paddle_tpu/ops/pallas_attention.py:_flash_kernel (launched
// by _flash_call, public flash_attention) for float32 q/k/v; bfloat16
// takes the wgmma kernel of flash_fwd_sm90.cu. Same function: softmax
// attention of each query row over the key rows with the per-row
// (q_len, kv_len) mask and, under causal, cols <= rows, computed as an
// online softmax in base 2 (scale*log2(e) folded into the scores, p
// zeroed explicitly on masked entries); rows with no valid column
// (rows >= q_len among them) write 0, and the row logsumexp is written
// in natural units (m*ln2 + ln l), NEG_INF where l == 0.
//
// Rethought for the GPU: the TPU kernel walks key blocks along a
// sequential grid axis and carries (m, l, acc) in VMEM scratch from
// step to step. Here one block of 256 threads owns one (batch*head,
// 64-row query block) and loops over the key blocks itself:
//   - it visits only key blocks k0 < kv_len and, under causal,
//     k0 <= q0 + 63 (the TPU kernel's block skip as a loop bound); a
//     query block wholly past q_len does no work;
//   - K and V blocks of 64 rows are staged in shared memory, then
//     S = Q K^T and O += P V are register-tiled SIMT products (4 x 4
//     scores and 4 rows x D/16 outputs a thread), P passing through
//     shared memory;
//   - interior tiles (all rows < q_len, all cols < kv_len, wholly at or
//     below the diagonal) skip the mask, as on the TPU;
//   - any T is handled by bounds checks on the loads and stores, not
//     by padding copies.
// Inputs are read in the layer's [b, T, h, d] layout, with no transposes.
//
// What bounds it on an H100: the JAX kernel runs float32 at
// Precision.HIGHEST, which the TF32 tensor cores (about 3 decimal
// digits) would not match, so the products stay on the float32 SIMT
// units (67 TFLOP/s): at the transformer's shapes (b 8, h 8, T 1024,
// d 64, causal) 8.6 GFLOP put a floor of 128 us under it. Splitting
// each operand into TF32 parts, as the float32 backward kernels
// (flash_{dq,dkv}_tf32_sm90.cu) do, is the next step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared
// -Xcompiler -fPIC (paddle_tpu_torch/ops/_build.py); bound with ctypes
// through the plain C function at the bottom.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ lens,
    T* __restrict__ out, float* __restrict__ lse, int H, int Tq, int Tk,
    int D, float scale_log2, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + kPad;
  const int ldp = kBlock + kPad;
  float* qs = smem;                  // [64][ld]
  float* ks = qs + kBlock * ld;      // [64][ld]
  float* vs = ks + kBlock * ld;      // [64][ld]
  float* ps = vs + kBlock * ld;      // [64][ldp]

  const int q0 = blockIdx.x * kBlock;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int q_len = min(lens[2 * b], Tq);
  const int kv_len = min(lens[2 * b + 1], Tk);
  const size_t rs = (size_t)H * D;   // elements between rows of a head
  const T* qg = q + ((size_t)b * Tq + q0) * rs + (size_t)h * D;
  const T* kg = k + (size_t)b * Tk * rs + (size_t)h * D;
  const T* vg = v + (size_t)b * Tk * rs + (size_t)h * D;
  const int q_rows = min(kBlock, Tq - q0);

  int kb_end = (kv_len + kBlock - 1) / kBlock;
  if (causal) kb_end = min(kb_end, (q0 + kBlock - 1) / kBlock + 1);
  if (q0 >= q_len) kb_end = 0;       // every row masked

  load_tile<T>(qs, qg, rs, q_rows, D, ld);

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kBlock;
    __syncthreads();                 // the previous tile is consumed
    load_tile<T>(ks, kg + (size_t)k0 * rs, rs, min(kBlock, Tk - k0), D, ld);
    load_tile<T>(vs, vg + (size_t)k0 * rs, rs, min(kBlock, Tk - k0), D, ld);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    tile_abt(qs, ks, ld, D, ty, tx, s);
    const bool interior = (q0 + kBlock <= q_len) &&
                          (k0 + kBlock <= kv_len) &&
                          (!causal || k0 + kBlock - 1 <= q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        valid[j] = interior || (row < q_len && col < kv_len &&
                                (!causal || col <= row));
        s[i][j] = valid[j] ? s[i][j] * scale_log2 : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // explicit zero on masked entries: a row masked in every block
        // would otherwise see exp2(NEG_INF - NEG_INF) == 1
        const float p = valid[j] ? exp2f(s[i][j] - m_new) : 0.f;
        sum += p;
        ps[(4 * ty + i) * ldp + tx + 16 * j] = p;
      }
      sum = row_sum16(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_pv<NC>(ps, ldp, vs, ld, D, ty, tx, acc);
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  store_rows<T, NC>(out + ((size_t)b * Tq + q0) * rs + (size_t)h * D, rs,
                    q_rows, D, ty, tx, acc, inv);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      if (r < q_rows)
        lse[(size_t)bh * Tq + q0 + r] =
            l[i] > 0.f ? m[i] * kLn2 + logf(l[i]) : kNegInf;
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lens, void* out, float* lse, int B, int H,
                   int Tq, int Tk, int D, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem =
      (3u * kBlock * (D + kPad) + kBlock * (kBlock + kPad)) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static size_t configured = 0;
  cudaError_t e =
      set_smem((const void*)flash_fwd_kernel<T, NC>, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((Tq + kBlock - 1) / kBlock, B * H);
  flash_fwd_kernel<T, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, static_cast<T*>(out), lse, H, Tq, Tk,
      D, scale * kLog2e, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* lens, void* out, float* lse, int B, int H,
                     int Tq, int Tk, int D, float scale, int causal,
                     cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 1>(q, k, v, lens, out, lse, B, H, Tq, Tk, D, scale,
                        causal, stream);
  return launch<T, 2>(q, k, v, lens, out, lse, B, H, Tq, Tk, D, scale, causal,
                      stream);
}

}  // namespace

// dtype must be 0 (float32): bfloat16 takes flash_fwd_sm90.cu. Returns
// cudaGetLastError() after the launch (0 on success); the wrapper
// raises on anything else.
extern "C" int pt_flash_fwd(const void* q, const void* k, const void* v,
                            const void* lens, void* out, void* lse, int B,
                            int H, int Tq, int Tk, int D, float scale,
                            int causal, int dtype, void* stream) {
  if (!shapes_ok(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  const int* ln = static_cast<const int*>(lens);
  float* ls = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch<float>(q, k, v, ln, out, ls, B, H, Tq, Tk, D, scale,
                              causal, st);
}

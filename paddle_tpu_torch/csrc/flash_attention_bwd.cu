// Flash-attention backward for Hopper (sm_90a): two SIMT kernels,
// float32.
//
// Replaces: paddle_tpu/ops/pallas_attention.py:_flash_bwd_dq_kernel
// (pt_flash_bwd_dq) and :_flash_bwd_dkv_kernel (pt_flash_bwd_dkv), both
// launched by _flash_grads, for float32 operands: bfloat16 takes the
// wgmma kernels of flash_dq_sm90.cu and flash_dkv_sm90.cu. Same functions:
// each tile's softmax is recomputed from the saved natural-units
// logsumexp as
// p = exp2(s*scale*log2e - lse*log2e) under the full (q_len, kv_len,
// causal) mask — the mask applied BEFORE the exponent can overflow on
// a fully-masked row, whose lse is NEG_INF — then with
// D = rowsum(dO*O) (computed by the wrapper, as the JAX package does
// outside its kernels):
//   dq  = sum_k  p (dO.V^T - D) scale . K          (per query block)
//   dv  = sum_q  p^T . dO,  dk = sum_q ds^T . Q    (per key block)
// accumulated in float32 and written in the input dtype.
//
// Rethought for the GPU: the TPU kernels carry dq (resp. dk/dv) in VMEM
// scratch along a sequential grid axis. Here one block of 256 threads
// owns one (batch*head, 64-row block) and loops over the other axis
// itself, so no sum crosses blocks and no atomics are needed:
//   - dq: the key blocks k0 < kv_len and, under causal,
//     k0 <= q0 + 63 — the forward's skip;
//   - dk/dv: the query blocks with j*64 < q_len and, under causal,
//     j*64 + 63 >= k0 (the TPU kernel's skip is on QUERY blocks); a key
//     block wholly past kv_len writes zeros;
//   - the operands are staged in shared memory as float32, the score
//     tiles are register-tiled SIMT products, and p (and ds) pass
//     through shared memory into the output products.
// Rows past a sequence's length that the mask still lets attend (the
// layer passes kv_lens only) are NOT zeroed: that would change the
// function.
//
// What bounds it on an H100: at the transformer's shapes (b 8, h 8,
// T 1024, d 64, causal) dq does 3 and dk/dv 4 products of the
// forward's 2 (12.9 and 17.2 GFLOP counting the valid pairs) against
// ~42 and ~50 MB in bf16 — operations-bound on the SIMT float32 units
// (>= 190 and 260 us at 67 TFLOP/s). float32 stays here because the
// JAX kernels run it at Precision.HIGHEST, beyond TF32.
//
// Build: see flash_attention_fwd.cu.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd,
    const int* __restrict__ lens, T* __restrict__ dq, int H, int Tq, int Tk,
    int D, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + kPad;
  const int ldp = kBlock + kPad;
  float* qs = smem;                  // [64][ld]
  float* dos = qs + kBlock * ld;     // [64][ld]
  float* ks = dos + kBlock * ld;     // [64][ld]
  float* vs = ks + kBlock * ld;      // [64][ld]
  float* dss = vs + kBlock * ld;     // [64][ldp]
  float* lse_s = dss + kBlock * ldp; // [64]
  float* dd_s = lse_s + kBlock;      // [64]

  const int q0 = blockIdx.x * kBlock;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int q_len = min(lens[2 * b], Tq);
  const int kv_len = min(lens[2 * b + 1], Tk);
  const size_t rs = (size_t)H * D;
  const size_t qoff = ((size_t)b * Tq + q0) * rs + (size_t)h * D;
  const T* kg = k + (size_t)b * Tk * rs + (size_t)h * D;
  const T* vg = v + (size_t)b * Tk * rs + (size_t)h * D;
  const int q_rows = min(kBlock, Tq - q0);
  const float scale_log2 = scale * kLog2e;

  int kb_end = (kv_len + kBlock - 1) / kBlock;
  if (causal) kb_end = min(kb_end, (q0 + kBlock - 1) / kBlock + 1);
  if (q0 >= q_len) kb_end = 0;       // every p is masked: dq = 0

  load_tile<T>(qs, q + qoff, rs, q_rows, D, ld);
  load_tile<T>(dos, dout + qoff, rs, q_rows, D, ld);
  for (int r = threadIdx.x; r < kBlock; r += blockDim.x) {
    const bool in = r < q_rows;
    lse_s[r] = in ? lse[(size_t)bh * Tq + q0 + r] * kLog2e : 0.f;
    dd_s[r] = in ? dd[(size_t)bh * Tq + q0 + r] : 0.f;
  }

  float acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;

  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kBlock;
    __syncthreads();
    load_tile<T>(ks, kg + (size_t)k0 * rs, rs, min(kBlock, Tk - k0), D, ld);
    load_tile<T>(vs, vg + (size_t)k0 * rs, rs, min(kBlock, Tk - k0), D, ld);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_abt(qs, ks, ld, D, ty, tx, s);
    tile_abt(dos, vs, ld, D, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const int row = q0 + r;
      const float lr = lse_s[r];
      const float dr = dd_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool valid =
            row < q_len && col < kv_len && (!causal || col <= row);
        const float p = valid ? exp2f(s[i][j] * scale_log2 - lr) : 0.f;
        dss[r * ldp + tx + 16 * j] = p * (dp[i][j] - dr) * scale;
      }
    }
    __syncthreads();
    tile_pv<NC>(dss, ldp, ks, ld, D, ty, tx, acc);
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<T, NC>(dq + qoff, rs, q_rows, D, ty, tx, acc, one);
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd,
    const int* __restrict__ lens, T* __restrict__ dk, T* __restrict__ dv,
    int H, int Tq, int Tk, int D, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + kPad;
  const int ldp = kBlock + kPad;
  float* ks = smem;                  // [64][ld]   key rows of this block
  float* vs = ks + kBlock * ld;      // [64][ld]
  float* qs = vs + kBlock * ld;      // [64][ld]   query rows of block j
  float* dos = qs + kBlock * ld;     // [64][ld]
  float* pts = dos + kBlock * ld;    // [64][ldp]  p^T  (key x query)
  float* dst = pts + kBlock * ldp;   // [64][ldp]  ds^T
  float* lse_s = dst + kBlock * ldp; // [64]
  float* dd_s = lse_s + kBlock;      // [64]

  const int k0 = blockIdx.x * kBlock;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int q_len = min(lens[2 * b], Tq);
  const int kv_len = min(lens[2 * b + 1], Tk);
  const size_t rs = (size_t)H * D;
  const size_t koff = ((size_t)b * Tk + k0) * rs + (size_t)h * D;
  const T* qg = q + (size_t)b * Tq * rs + (size_t)h * D;
  const T* dog = dout + (size_t)b * Tq * rs + (size_t)h * D;
  const int k_rows = min(kBlock, Tk - k0);
  const float scale_log2 = scale * kLog2e;

  // query blocks j with j*64 < q_len and (causal) j*64 + 63 >= k0
  const int j_begin = causal ? k0 / kBlock : 0;
  int j_end = (q_len + kBlock - 1) / kBlock;
  if (k0 >= kv_len) j_end = 0;       // every column masked: dk = dv = 0

  if (j_end > j_begin) {
    load_tile<T>(ks, k + koff, rs, k_rows, D, ld);
    load_tile<T>(vs, v + koff, rs, k_rows, D, ld);
  }

  float acc_k[4][4 * NC], acc_v[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int j = j_begin; j < j_end; ++j) {
    const int q0 = j * kBlock;
    const int q_rows = min(kBlock, Tq - q0);
    __syncthreads();
    load_tile<T>(qs, qg + (size_t)q0 * rs, rs, q_rows, D, ld);
    load_tile<T>(dos, dog + (size_t)q0 * rs, rs, q_rows, D, ld);
    for (int r = threadIdx.x; r < kBlock; r += blockDim.x) {
      const bool in = r < q_rows;
      lse_s[r] = in ? lse[(size_t)bh * Tq + q0 + r] * kLog2e : 0.f;
      dd_s[r] = in ? dd[(size_t)bh * Tq + q0 + r] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
    tile_abt(ks, qs, ld, D, ty, tx, s);     // s^T: key rows x query cols
    tile_abt(vs, dos, ld, D, ty, tx, dp);   // (dO V^T)^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const int col = k0 + r;               // key index
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qc = tx + 16 * c;
        const int row = q0 + qc;            // query index
        const bool valid =
            row < q_len && col < kv_len && (!causal || col <= row);
        const float p =
            valid ? exp2f(s[i][c] * scale_log2 - lse_s[qc]) : 0.f;
        pts[r * ldp + qc] = p;
        dst[r * ldp + qc] = p * (dp[i][c] - dd_s[qc]) * scale;
      }
    }
    __syncthreads();
    tile_pv<NC>(pts, ldp, dos, ld, D, ty, tx, acc_v);
    tile_pv<NC>(dst, ldp, qs, ld, D, ty, tx, acc_k);
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<T, NC>(dk + koff, rs, k_rows, D, ty, tx, acc_k, one);
  store_rows<T, NC>(dv + koff, rs, k_rows, D, ty, tx, acc_v, one);
}

inline size_t dq_smem(int D) {
  return (4u * kBlock * (D + kPad) + kBlock * (kBlock + kPad) + 2 * kBlock) *
         sizeof(float);
}

inline size_t dkv_smem(int D) {
  return (4u * kBlock * (D + kPad) + 2u * kBlock * (kBlock + kPad) +
          2 * kBlock) *
         sizeof(float);
}

template <typename T, int NC>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* dd,
                      const int* lens, void* dq, int B, int H, int Tq, int Tk,
                      int D, float scale, int causal, cudaStream_t stream) {
  const size_t smem = dq_smem(D);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static size_t configured = 0;
  cudaError_t e =
      set_smem((const void*)flash_dq_kernel<T, NC>, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((Tq + kBlock - 1) / kBlock, B * H);
  flash_dq_kernel<T, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dd, lens,
      static_cast<T*>(dq), H, Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* dd,
                       const int* lens, void* dk, void* dv, int B, int H,
                       int Tq, int Tk, int D, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem = dkv_smem(D);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static size_t configured = 0;
  cudaError_t e =
      set_smem((const void*)flash_dkv_kernel<T, NC>, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((Tk + kBlock - 1) / kBlock, B * H);
  flash_dkv_kernel<T, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dd, lens,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype must be 0 (float32): bfloat16 takes flash_dq_sm90.cu and
// flash_dkv_sm90.cu. Each returns cudaGetLastError() after its launch
// (0 on success); the wrapper raises on anything else.
extern "C" int pt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* dd, const void* lens, void* dq,
                               int B, int H, int Tq, int Tk, int D,
                               float scale, int causal, int dtype,
                               void* stream) {
  if (!shapes_ok(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(dd);
  const int* ln = static_cast<const int*>(lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return (int)(D <= 64 ? launch_dq<float, 1>(q, k, v, dout, ls, dl, ln, dq, B,
                                             H, Tq, Tk, D, scale, causal, st)
                       : launch_dq<float, 2>(q, k, v, dout, ls, dl, ln, dq, B,
                                             H, Tq, Tk, D, scale, causal, st));
}

extern "C" int pt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* dd, const void* lens, void* dk,
                                void* dv, int B, int H, int Tq, int Tk, int D,
                                float scale, int causal, int dtype,
                                void* stream) {
  if (!shapes_ok(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(dd);
  const int* ln = static_cast<const int*>(lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return (int)(D <= 64 ? launch_dkv<float, 1>(q, k, v, dout, ls, dl, ln, dk,
                                              dv, B, H, Tq, Tk, D, scale,
                                              causal, st)
                       : launch_dkv<float, 2>(q, k, v, dout, ls, dl, ln, dk,
                                              dv, B, H, Tq, Tk, D, scale,
                                              causal, st));
}

// Paged window attention for Hopper (sm_90a) — the serving engine's
// per-layer attention over the paged KV pool.
//
// Replaces: paddle_tpu/ops/pallas_decode.py:_paged_window_kernel (the
// allocated-pages Pallas kernel, launched by paged_window_attention).
// Same function: for slot s and window token w, attention of the query
// heads over the slot's pages, token w seeing absolute positions
// c < kv_lens[s, w] (the ragged-length mask and the in-window causal
// mask in one), grouped-query heads (query head g*rep + r reads kv
// group g), online softmax in base 2 with scale*log2(e), and the
// finalize division by max(l, 1e-30). A row with kv_len 0 returns
// what the TPU kernel returns for it: the mean of V over every column
// of the slot's used pages (its masked weights are exp2(0) = 1 there).
//
// Rethought for the GPU, not copied block by block: the TPU kernel
// walks pages along a sequential grid axis and carries (m, l, acc) in
// VMEM scratch from one grid step to the next. Blocks on Hopper run in
// parallel and in no order, so here
//   - one block owns one (slot s, kv group g) and loops over that
//     slot's pages itself;
//   - it reads each physical page id from page_tables[s, p] (the
//     TPU kernel's scalar prefetch);
//   - it walks only used = clamp(ceil(max_w kv_lens[s, w] / ps), 1, P)
//     pages — pages past a slot's allocation are never read (the
//     allocated-pages traffic contract; an idle slot reads only the
//     null page 0, as on the TPU);
//   - each query row (w, r) of the W*rep rows of the group gets
//     split = max(1, 8 / (W*rep)) warps (fewer if shared memory runs
//     short), and the slot's pages are walked in ROUNDS of split
//     pages: in a round, warp k of a row takes page k of the round,
//     whole. So a block keeps about 8 warps busy on different pages at
//     once, which is what hides the latency of each warp's dependent
//     chain (shared-memory load, fma, five shuffles, exp2) — one warp
//     per block, or warps sharing the columns of one page, left the
//     SM waiting on that chain most of the time;
//   - a round's pages ([ps, dh] K and V rows of group g each) are
//     copied into shared memory with cp.async, double-buffered by
//     round: round r+1 is in flight while round r is consumed;
//   - inside a warp, lanes stride over dh, the q row and the float32
//     accumulator live in registers, and key columns go eight at a
//     time: eight independent warp-shuffle score reductions, then one
//     online-softmax update of the warp-uniform (m, l);
//   - at the end the split warps of a row merge their (m, l, acc)
//     through shared memory (the copy buffers are free by then),
//     rescaling by exp2(m_k - max_k m_k) — the online-softmax algebra.
//
// What bounds it on an H100: bytes. Per call it must read the K and V
// of the used pages, 2 * sum_s ceil(len_s/ps) * ps * g * dh * esize
// bytes, against ~4 * sum_s len_s * h * dh flops — under one flop per
// byte, far below the card's ~20 flop/byte float32 ridge. At the
// serving shapes (8 slots, lengths of a few hundred, one layer's pool
// slice per call) that is a few MB, about a microsecond at 3.35 TB/s;
// what the kernel pays beyond that is latency: the page walk of one
// slot stays sequential inside its block, and only S * g blocks run.
// Splitting long slots across blocks, TMA and wgmma are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared
// -Xcompiler -fPIC (paddle_tpu_torch/ops/_build.py); bound with ctypes
// through the plain C function at the bottom.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxChunks = 8;       // dh <= kMaxChunks * 32 = 256
constexpr int kTargetWarps = 8;     // warps per block when rows are few
constexpr size_t kMaxSmem = 227u * 1024u;  // per block, sm_90
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF
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

// 16-byte asynchronous global -> shared copy (sm_80+), and its groups
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

constexpr int kCols = 8;            // key columns per softmax update

// grid (S, G); block 32 * W*rep * split threads (<= 1024); dynamic
// shared max(2 rounds x split pages x (K, V) x ps x dh elements of T,
// the merge scratch). NCH is ceil(dh / 32) rounded up to a power of
// two: the per-lane chunks of the q row and the accumulator, sized at
// compile time so registers fit a 1024-thread block.
// Layouts (all contiguous): q, out [S, W, H, DH]; k_pages, v_pages
// [N, PS, G, DH]; tables [S, P] int32; kv_lens [S, W] int32.
template <typename T, int NCH>
__global__ void __launch_bounds__(1024) paged_window_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ kv_lens, T* __restrict__ out, int W, int H,
    int G, int DH, int n_pages, int PS, int P, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rep = H / G;
  const int split = blockDim.x / kWarp / (W * rep);
  const int tile = PS * DH;
  T* kbuf = reinterpret_cast<T*>(smem_raw);   // [2][split][PS][DH]
  T* vbuf = kbuf + 2 * split * tile;          // [2][split][PS][DH]

  const int s = blockIdx.x;
  const int g = blockIdx.y;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  // this warp's query row (window token w, head r) and its page of
  // each round, k
  const int row = warp / split;
  const int k = warp - row * split;
  const int w = row / rep;
  const int hq = g * rep + row % rep;
  const int len = kv_lens[s * W + w];
  T* orow = out + ((size_t)(s * W + w) * H + hq) * DH;

  // pages holding live KV for the slot, >= 1 so an idle slot still
  // walks the null page (reference: pallas_decode.py:448)
  int max_len = 0;
  for (int i = 0; i < W; ++i) max_len = max(max_len, kv_lens[s * W + i]);
  const int used = min(max((max_len + PS - 1) / PS, 1), P);
  // a corrupt table entry is never dereferenced: the slot's rows are
  // poisoned with NaN instead (block-uniform, so the early exit is safe)
  bool bad = false;
  for (int p = 0; p < used; ++p) {
    const int page = tables[s * P + p];
    bad = bad || page < 0 || page >= n_pages;
  }
  if (bad) {
    if (k == 0)
      for (int d = lane; d < DH; d += kWarp)
        orow[d] = from_f32<T>(__int_as_float(0x7fc00000));
    return;
  }

  const int vec = 16 / (int)sizeof(T);        // elements per 16 bytes
  const int chunks_row = DH / vec;
  const int n_chunks = PS * chunks_row;       // per page and tensor
  const int n_rounds = (used + split - 1) / split;
  // copy the pages of round r into buffer half `half`
  auto issue = [&](int r, int half) {
    for (int j = threadIdx.x; j < split * n_chunks; j += blockDim.x) {
      const int pk = j / n_chunks;
      const int p = r * split + pk;
      if (p >= used) break;          // j only grows: the rest is past too
      const int jc = j - pk * n_chunks;
      const int c = jc / chunks_row;
      const int e = (jc - c * chunks_row) * vec;
      const size_t goff =
          ((size_t)tables[s * P + p] * PS * G + g) * (size_t)DH +
          (size_t)c * G * DH + e;
      const int soff = (half * split + pk) * tile + c * DH + e;
      cp_async16(kbuf + soff, k_pages + goff);
      cp_async16(vbuf + soff, v_pages + goff);
    }
  };

  const T* qrow = q + ((size_t)(s * W + w) * H + hq) * DH;
  float qv[NCH];
  float acc[NCH];
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int d = i * kWarp + lane;
    qv[i] = d < DH ? to_f32(qrow[d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  issue(0, 0);
  cp_async_commit();
  for (int r = 0; r < n_rounds; ++r) {
    // the other half was consumed last round (and synced)
    if (r + 1 < n_rounds) issue(r + 1, (r + 1) & 1);
    cp_async_commit();               // possibly empty: keeps the count
    cp_async_wait_all_but_one();     // round r has landed
    __syncthreads();
    const int p = r * split + k;
    const T* kt = kbuf + ((r & 1) * split + k) * tile;
    const T* vt = vbuf + ((r & 1) * split + k) * tile;
    // columns of page p this row may see: absolute c < len
    const int c_end = p < used ? min(PS, len - p * PS) : 0;
    if (len <= 0 && p < used) {
      // a row that sees no column (kv_len 0): the TPU kernel does not
      // zero its masked weights, and exp2(NEG_INF - NEG_INF) = 1 gives
      // every column of the used pages weight 1 — the row returns the
      // mean of V over them. m stays NEG_INF, so the split merge below
      // sums these partial states with factor 1.
      for (int c = 0; c < PS; ++c) {
#pragma unroll
        for (int i = 0; i < NCH; ++i) {
          const int d = i * kWarp + lane;
          if (d < DH) acc[i] += to_f32(vt[c * DH + d]);
        }
      }
      l += (float)PS;
    }
    for (int c0 = 0; c0 < c_end; c0 += kCols) {
      float sc[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float part = 0.f;
        if (c0 + j < c_end) {
#pragma unroll
          for (int i = 0; i < NCH; ++i) {
            const int d = i * kWarp + lane;
            if (d < DH) part += qv[i] * to_f32(kt[(c0 + j) * DH + d]);
          }
        }
        sc[j] = part;
      }
      float m_new = m;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        sc[j] = warp_sum(sc[j]) * scale_log2;
        if (c0 + j < c_end) m_new = fmaxf(m_new, sc[j]);
      }
      const float alpha = exp2f(m - m_new);
      float pw[kCols];
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        pw[j] = (c0 + j < c_end) ? exp2f(sc[j] - m_new) : 0.f;
        psum += pw[j];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int d = i * kWarp + lane;
        if (d < DH) {
          float a = acc[i] * alpha;
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            if (c0 + j < c_end) a += pw[j] * to_f32(vt[(c0 + j) * DH + d]);
          acc[i] = a;
        }
      }
      m = m_new;
    }
    __syncthreads();                 // this half free for round r + 2
  }

  if (split > 1) {
    // merge the split partial states of each row; every copy group has
    // been waited for, so the ring's shared memory is free
    float* red = reinterpret_cast<float*>(smem_raw);  // [warps][2 + DH]
    float* mine = red + warp * (2 + DH);
    if (lane == 0) {
      mine[0] = m;
      mine[1] = l;
    }
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int d = i * kWarp + lane;
      if (d < DH) mine[2 + d] = acc[i];
    }
    __syncthreads();
    if (k != 0) return;
    float m_all = m;
    for (int kk = 1; kk < split; ++kk)
      m_all = fmaxf(m_all, red[(warp + kk) * (2 + DH)]);
    l = 0.f;
#pragma unroll
    for (int i = 0; i < NCH; ++i) acc[i] = 0.f;
    for (int kk = 0; kk < split; ++kk) {
      const float* part = red + (warp + kk) * (2 + DH);
      const float f = exp2f(part[0] - m_all);
      l += part[1] * f;
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int d = i * kWarp + lane;
        if (d < DH) acc[i] += part[2 + d] * f;
      }
    }
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int d = i * kWarp + lane;
    if (d < DH) orow[d] = from_f32<T>(acc[i] * inv);
  }
}

template <typename T, int NCH>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* tables, const int* kv_lens, void* out, int S,
                   int W, int H, int G, int DH, int n_pages, int PS, int P,
                   float scale, cudaStream_t stream) {
  const int rows = W * (H / G);
  const size_t page_bytes = 2u * PS * DH * sizeof(T);   // K + V
  int split = rows < kTargetWarps ? kTargetWarps / rows : 1;
  while (split > 1 && 2u * split * page_bytes > kMaxSmem) split /= 2;
  const size_t copies = 2u * split * page_bytes;
  const size_t merge = (size_t)rows * split * (2 + DH) * sizeof(float);
  const size_t smem = copies > merge ? copies : merge;
  if (smem > 48u * 1024u) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_window_kernel<T, NCH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(S, G);
  dim3 block(kWarp * rows * split);
  paged_window_kernel<T, NCH><<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), tables, kv_lens, static_cast<T*>(out),
      W, H, G, DH, n_pages, PS, P, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k_pages, const void* v_pages,
                     const int* tables, const int* kv_lens, void* out, int S,
                     int W, int H, int G, int DH, int n_pages, int PS, int P,
                     float scale, cudaStream_t stream) {
  const int nch = (DH + kWarp - 1) / kWarp;
  if (nch <= 1)
    return launch<T, 1>(q, k_pages, v_pages, tables, kv_lens, out, S, W, H,
                        G, DH, n_pages, PS, P, scale, stream);
  if (nch <= 2)
    return launch<T, 2>(q, k_pages, v_pages, tables, kv_lens, out, S, W, H,
                        G, DH, n_pages, PS, P, scale, stream);
  if (nch <= 4)
    return launch<T, 4>(q, k_pages, v_pages, tables, kv_lens, out, S, W, H,
                        G, DH, n_pages, PS, P, scale, stream);
  return launch<T, kMaxChunks>(q, k_pages, v_pages, tables, kv_lens, out, S,
                               W, H, G, DH, n_pages, PS, P, scale, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns cudaGetLastError() after the
// launch (0 on success); the wrapper raises on anything else.
extern "C" int pt_paged_window_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* kv_lens, void* out, int S, int W, int H,
    int G, int DH, int n_pages, int PS, int P, float scale, int dtype,
    void* stream) {
  if (S <= 0 || W <= 0 || G <= 0 || H % G != 0 || DH <= 0 || DH % 8 ||
      DH > kMaxChunks * kWarp || W * (H / G) > kWarp || PS <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(kv_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch<float>(q, k_pages, v_pages, tb, ln, out, S, W, H, G, DH,
                        n_pages, PS, P, scale, st);
  else if (dtype == 1)
    e = dispatch<__nv_bfloat16>(q, k_pages, v_pages, tb, ln, out, S, W, H,
                                G, DH, n_pages, PS, P, scale, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

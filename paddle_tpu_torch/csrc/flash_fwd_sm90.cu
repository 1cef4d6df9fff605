// Flash-attention forward for Hopper's tensor cores (sm_90a), bfloat16.
//
// Replaces: paddle_tpu/ops/pallas_attention.py:_flash_kernel (launched
// by _flash_call, public flash_attention) for bf16 q/k/v; float32 takes
// the 3xTF32 kernel of flash_fwd_tf32_sm90.cu. Same function as that
// kernel documents: a base-2 online softmax (scale*log2(e) folded into
// the scores, p zeroed explicitly on masked entries) over the per-row
// (q_len, kv_len) mask and, under causal, cols <= rows; rows with no
// valid column write 0 and lse = NEG_INF; lse is [b*h, Tq] float32 in
// natural units (m*ln2 + ln l). P is rounded to bf16 before P.V, where
// the TPU kernel rounds it (p.astype(v.dtype)).
//
// What bounds it on an H100: at the transformer's shapes (b 8, h 8,
// T 1024, d 64, causal) 8.6 GFLOP on the bf16 tensor cores (8.7 us at
// 989 TFLOP/s) against 33.5 MB of q/k/v/out (10.0 us at 3.35 TB/s):
// near balance, so the kernel has to keep the tensor cores fed while
// each K/V tile is read once per 128 query rows.
//
// Design: one block owns (b*h, 128 query rows): two consumer warpgroups
// of 64 rows each and one producer warp.
//   - The producer's elected lane loads Q once, then K and V tiles of
//     64 rows into a 2-stage ring by TMA (a 4-D map over the layer's
//     [b, T, h, d] layout, 128-byte swizzle), guarded by full/empty
//     mbarriers, so the next tile's copy overlaps this tile's math.
//     Rows past T and columns past d arrive as zeros (a head dim above
//     64 takes two 64-column panels), so nothing checks bounds.
//   - S = Q K^T is a wgmma SS product (both K-major), 64 x 64 per
//     warpgroup, over every 16-column step of its panels: the zero
//     columns past d add nothing, and a step count fixed at compile
//     time keeps the wgmmas back to back (with a runtime bound on the
//     steps ptxas fences each one); the mask and the online
//     update run in registers on the accumulator fragments (a row sits
//     in the 4 threads of a quad: two shfl_xor for its max; the sum is
//     kept per thread and reduced once at the end). Only tiles that
//     straddle q_len, kv_len or the diagonal compute the mask, as the
//     TPU kernel's _fast_block skips it.
//   - P goes to bf16 in registers and feeds O += P V as a wgmma RS
//     product (A = P from registers, B = V MN-major, transposed): P
//     never touches shared memory.
//   - It visits only key tiles k0 < kv_len and, under causal, k0 <= the
//     block's last row; a warpgroup skips a tile wholly above its own
//     diagonal; a block wholly past q_len writes zeros and NEG_INF.
//     Under causal the heaviest query blocks are launched first.
//   - The epilogue writes O / l as bf16 straight from the fragments.
// Registers: O (32 a panel) + S (32) + P (16) a thread; no spills.
// Each warpgroup's tile is a serial chain (S, softmax, P.V), hidden only
// by the other warpgroups on the SM (two blocks fit); a deeper ring
// changes nothing, and issuing the next S before this P.V makes ptxas
// serialize the products. Overlapping softmax with the tensor cores
// across warpgroups (ping-pong) is the next step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared
// -Xcompiler -fPIC (paddle_tpu_torch/ops/_build.py); bound with ctypes
// through the plain C functions at the bottom.

#include "flash_common.cuh"
#include "sm90_pipeline.cuh"

namespace {

using namespace flash;
using namespace sm90;

constexpr int kStages = 2;
constexpr int kWarpgroups = 2;       // consumer warpgroups: 128 query rows

template <int NP>
__global__ void __launch_bounds__(128 * kWarpgroups + 32, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const int* __restrict__ lens,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int H, int Tq, int Tk,
                          int D, float scale_log2, int causal) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t kv_full[kStages];
  __shared__ __align__(8) uint64_t kv_empty[kStages];
  uint8_t* smem = align1024(smem_raw);
  // Q panel (g, p) at (g*NP + p) tiles; stage s: K panels, then V panels
  uint8_t* q_s = smem;
  uint8_t* kv_s = smem + kWarpgroups * NP * kTileBytes;
  auto k_tile = [&](int s, int p) {
    return kv_s + (s * 2 * NP + p) * kTileBytes;
  };
  auto v_tile = [&](int s, int p) {
    return kv_s + (s * 2 * NP + NP + p) * kTileBytes;
  };

  constexpr int kRowsBlock = 64 * kWarpgroups;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kRowsBlock;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q_len = min(lens[2 * b], Tq);
  const int kv_len = min(lens[2 * b + 1], Tk);
  int kb_end = (kv_len + kRows - 1) / kRows;
  if (causal) kb_end = min(kb_end, (q0 + kRowsBlock - 1) / kRows + 1);
  if (q0 >= q_len) kb_end = 0;       // every row masked

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], 4 * kWarpgroups);   // one arrive a warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * kWarpgroups) {     // ---- producer warp
    if (lane == 0 && kb_end > 0) {
      tma_prefetch_map(&map_k);
      tma_prefetch_map(&map_v);
      mbar_expect_tx(&q_full, kWarpgroups * NP * kTileBytes);
      for (int g = 0; g < kWarpgroups; ++g)
        for (int p = 0; p < NP; ++p)
          tma_load(q_s + (g * NP + p) * kTileBytes, &map_q, &q_full,
                   p * kPanel, h, q0 + 64 * g, b);
      for (int kb = 0; kb < kb_end; ++kb) {
        const int s = kb % kStages;
        mbar_wait(&kv_empty[s], ((kb / kStages) & 1) ^ 1);
        mbar_expect_tx(&kv_full[s], 2 * NP * kTileBytes);
        for (int p = 0; p < NP; ++p) {
          tma_load(k_tile(s, p), &map_k, &kv_full[s], p * kPanel, h,
                   kb * kRows, b);
          tma_load(v_tile(s, p), &map_v, &kv_full[s], p * kPanel, h,
                   kb * kRows, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup g: query rows q0 + 64g .. q0 + 64g + 63
  const int g = warp / 4;
  const int w = warp % 4;
  const int qg = q0 + 64 * g;
  const int row0 = qg + 16 * w + lane / 4;   // and row0 + 8
  const uint8_t* qt_s = q_s + g * NP * kTileBytes;

  float o[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  if (kb_end > 0) mbar_wait(&q_full, 0);
  for (int kb = 0; kb < kb_end; ++kb) {
    const int s = kb % kStages;
    const int k0 = kb * kRows;
    mbar_wait(&kv_full[s], (kb / kStages) & 1);
    // a tile wholly above this warpgroup's diagonal adds nothing
    if (!causal || k0 <= qg + 63) {
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NP; ++kk)
        wgmma_ss<0>(sc, desc_k(qt_s + (kk / 4) * kTileBytes, kk % 4),
                    desc_k(k_tile(s, kk / 4), kk % 4), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      const bool interior = (qg + 64 <= q_len) && (k0 + kRows <= kv_len) &&
                            (!causal || k0 + kRows - 1 <= qg);
      if (interior)
        online_softmax<false, 32, NP>(sc, o, m, l, scale_log2, row0, k0,
                                      q_len, kv_len, causal, lane);
      else
        online_softmax<true, 32, NP>(sc, o, m, l, scale_log2, row0, k0,
                                     q_len, kv_len, causal, lane);
      uint32_t pa[16];
      pack_a(sc, pa);

      fence_regs(pa);
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(o[p]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          wgmma_rs<1>(o[p], &pa[4 * kk], desc_mn(v_tile(s, p), kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(o[p]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&kv_empty[s]);
  }

  // the row sums were kept per thread: reduce over the quad once
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    inv[hh] = l[hh] > 0.f ? 1.f / l[hh] : 0.f;
  }
  const size_t rs = (size_t)H * D;   // elements between rows of a head
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= Tq) continue;
    __nv_bfloat16* orow = out + ((size_t)b * Tq + row) * rs + (size_t)h * D;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = p * kPanel + 8 * j + 2 * (lane % 4);
        if (col < D)
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16(o[p][4 * j + 2 * hh] * inv[hh],
                        o[p][4 * j + 2 * hh + 1] * inv[hh]);
      }
    if (lane % 4 == 0)
      lse[(size_t)bh * Tq + row] =
          l[hh] > 0.f ? m[hh] * kLn2 + logf(l[hh]) : kNegInf;
  }
}

template <int NP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lens, void* out, float* lse, int B, int H,
                   int Tq, int Tk, int D, float scale, int causal,
                   cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_bthd_map(&mq, q, B, Tq, H, D) ||
      !make_bthd_map(&mk, k, B, Tk, H, D) ||
      !make_bthd_map(&mv, v, B, Tk, H, D))
    return cudaErrorInvalidValue;
  const size_t smem =
      1024 + (size_t)(kWarpgroups * NP + 2 * kStages * NP) * kTileBytes;
  static size_t configured = 0;
  cudaError_t e =
      set_smem((const void*)flash_fwd_sm90_kernel<NP>, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((Tq + 64 * kWarpgroups - 1) / (64 * kWarpgroups), B * H);
  flash_fwd_sm90_kernel<NP><<<grid, 128 * kWarpgroups + 32, smem, stream>>>(
      mq, mk, mv, lens, static_cast<__nv_bfloat16*>(out), lse, H, Tq, Tk, D,
      scale * kLog2e, causal);
  return cudaGetLastError();
}

// ---- a check of the building blocks, one warpgroup, one tile each:
// c_abt = A B^T (wgmma SS, both K-major: the S product) and c_ab = A B
// (wgmma RS, A from registers read from a_plain, B MN-major: the P.V
// product), A and B [64, 64] bf16 loaded by TMA as [1, 64, 1, 64]
__global__ void __launch_bounds__(128) sm90_product_check_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_b,
    const __nv_bfloat16* __restrict__ a_plain, float* __restrict__ c_abt,
    float* __restrict__ c_ab) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full;
  uint8_t* smem = align1024(smem_raw);
  uint8_t* a_s = smem;
  uint8_t* b_s = smem + kTileBytes;
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(&full, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&full, 2 * kTileBytes);
    tma_load(a_s, &map_a, &full, 0, 0, 0, 0);
    tma_load(b_s, &map_b, &full, 0, 0, 0, 0);
  }
  mbar_wait(&full, 0);

  float c[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) c[i] = 0.f;
  fence_regs(c);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<0>(c, desc_k(a_s, kk), desc_k(b_s, kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(c);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    c_abt[frag_row(i, w, lane) * 64 + frag_col(i, lane)] = c[i];

  uint32_t a[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    // register r of chunk kk = r / 4: row +8 for odd r % 4, col +8 for
    // r % 4 >= 2
    const int row = 16 * w + lane / 4 + 8 * (r & 1);
    const int col = 16 * (r / 4) + 8 * ((r % 4) / 2) + 2 * (lane % 4);
    a[r] = *reinterpret_cast<const uint32_t*>(a_plain + row * 64 + col);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) c[i] = 0.f;
  fence_regs(c);
  fence_regs(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(c, &a[4 * kk], desc_mn(b_s, kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(c);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    c_ab[frag_row(i, w, lane) * 64 + frag_col(i, lane)] = c[i];
}

}  // namespace

// dtype must be 1 (bfloat16): float32 takes flash_fwd_tf32_sm90.cu.
// Returns cudaGetLastError() after the launch (0 on success); the
// wrapper raises on anything else.
extern "C" int pt_flash_fwd_sm90(const void* q, const void* k, const void* v,
                                 const void* lens, void* out, void* lse,
                                 int B, int H, int Tq, int Tk, int D,
                                 float scale, int causal, int dtype,
                                 void* stream) {
  if (!shapes_ok(B, H, Tq, Tk, D) || dtype != 1)
    return (int)cudaErrorInvalidValue;
  const int* ln = static_cast<const int*>(lens);
  float* ls = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= kPanel)
    return (int)launch<1>(q, k, v, ln, out, ls, B, H, Tq, Tk, D, scale,
                          causal, st);
  return (int)launch<2>(q, k, v, ln, out, ls, B, H, Tq, Tk, D, scale, causal,
                        st);
}

// a and b: bf16 [64, 64] row-major; c_abt, c_ab: float32 [64, 64]
extern "C" int pt_sm90_product_check(const void* a, const void* b,
                                     void* c_abt, void* c_ab, void* stream) {
  CUtensorMap ma, mb;
  if (!make_bthd_map(&ma, a, 1, 64, 1, 64) ||
      !make_bthd_map(&mb, b, 1, 64, 1, 64))
    return (int)cudaErrorInvalidValue;
  const size_t smem = 1024 + 2 * kTileBytes;
  sm90_product_check_kernel<<<1, 128, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      ma, mb, static_cast<const __nv_bfloat16*>(a), static_cast<float*>(c_abt),
      static_cast<float*>(c_ab));
  return (int)cudaGetLastError();
}

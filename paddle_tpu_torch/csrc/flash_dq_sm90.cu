// Flash-attention dq for Hopper's tensor cores (sm_90a), bfloat16.
//
// Replaces: paddle_tpu/ops/pallas_attention.py:_flash_bwd_dq_kernel
// (launched by _flash_grads) for bf16 operands; float32 takes the
// 3xTF32 kernel of flash_dq_tf32_sm90.cu. Same function: p is
// recomputed from the saved natural-units lse as
// exp2(s*scale*log2e - lse*log2e) under the full (q_len, kv_len,
// causal) mask, the mask applied BEFORE the exponent (a fully-masked
// row's lse is NEG_INF), then with D = rowsum(dO*O)
//   dQ = sum_k dS K,   dS = P (dP - D) scale,   dP = dO V^T,
// accumulated in float32 and written in bf16. dS is rounded to bf16
// before its product, where the TPU kernel rounds it
// (ds.astype(k.dtype)). A query row with no valid key (past q_len, or
// kv_len 0) writes 0.
//
// What bounds it on an H100: at the transformer's shapes (b 8, h 8,
// T 1024, d 64, causal) three products of 2*d flops a valid pair, 12.9
// GFLOP (13.0 us at the bf16 tensor cores' 989 TFLOP/s) against ~42 MB
// of q/k/v/dO/dq plus lse and D (12.5 us at 3.35 TB/s).
//
// Design: one block owns (b*h, 128 query rows): two consumer warpgroups
// of 64 rows each and one producer warp.
//   - The producer's elected lane loads Q and dO once by TMA (4-D map
//     over [b, T, h, d], 128-byte swizzle; rows past T and columns past
//     d arrive as zeros, so a head dim above 64 takes a second panel
//     and nothing checks bounds), then walks the key tiles with
//     k0 < kv_len and, under causal, k0 <= q0 + 127 (the JAX kernel's
//     skip at this block height), loading K and V into a 2-stage ring
//     guarded by full/empty mbarriers. Each consumer thread reads the
//     lse*log2e and D of its own two rows once, from global memory: the
//     rows of a thread never change, so they need no shared copy.
//   - Per key tile, on wgmma with f32 accumulators:
//       S  = Q K^T     SS, both K-major;
//       dP = dO V^T    SS, both K-major;
//       dQ += dS K     RS: A = dS packed to bf16 from the dP
//                      accumulator, B = K MN-major (transposed).
//     The swizzled K tile is read K-major by S and MN-major by dQ: two
//     descriptors over one buffer. P and dS never touch shared memory.
//     Only tiles that straddle q_len, kv_len or the diagonal compute the
//     mask; a warpgroup skips a tile wholly above its own diagonal.
//   - No sum crosses blocks, so there are no atomics; under causal the
//     heaviest query blocks are launched first.
// Each tile is a serial chain per warpgroup (two products, the
// elementwise P and dS, one product), hidden by the other warpgroup of
// the block. The step count over d is fixed at compile time (a runtime
// bound makes ptxas fence each wgmma), and the next tile's S is not
// issued before this tile's dQ product (ptxas would serialize them).
// Registers: S, dP and dQ are 64 x 64 f32 accumulators, 32 registers
// each a thread; at d 128 dQ takes 64. No spills.
//
// Build: see flash_fwd_sm90.cu.

#include "flash_common.cuh"
#include "sm90_pipeline.cuh"

namespace {

using namespace flash;
using namespace sm90;

constexpr int kStages = 2;
constexpr int kWarpgroups = 2;       // consumer warpgroups: 128 query rows

template <int NP>
__global__ void __launch_bounds__(128 * kWarpgroups + 32, 1)
    flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ dd,
                         const int* __restrict__ lens,
                         __nv_bfloat16* __restrict__ dq, int H, int Tq,
                         int Tk, int D, float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t qdo_full;
  __shared__ __align__(8) uint64_t kv_full[kStages];
  __shared__ __align__(8) uint64_t kv_empty[kStages];
  uint8_t* smem = align1024(smem_raw);
  // Q panel (g, p) at (g*NP + p) tiles, dO panels after them; stage s:
  // K panels, then V panels
  uint8_t* q_s = smem;
  uint8_t* do_s = smem + kWarpgroups * NP * kTileBytes;
  uint8_t* kv_s = smem + 2 * kWarpgroups * NP * kTileBytes;
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
  if (q0 >= q_len) kb_end = 0;       // every p is masked: dq = 0

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(&qdo_full, 1);
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
      mbar_expect_tx(&qdo_full, 2 * kWarpgroups * NP * kTileBytes);
      for (int g = 0; g < kWarpgroups; ++g)
        for (int p = 0; p < NP; ++p) {
          tma_load(q_s + (g * NP + p) * kTileBytes, &map_q, &qdo_full,
                   p * kPanel, h, q0 + 64 * g, b);
          tma_load(do_s + (g * NP + p) * kTileBytes, &map_do, &qdo_full,
                   p * kPanel, h, q0 + 64 * g, b);
        }
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
  const uint8_t* dot_s = do_s + g * NP * kTileBytes;
  const float scale_log2 = scale * kLog2e;
  float lse_r[2], dd_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    const bool in = row < Tq && kb_end > 0;
    lse_r[hh] = in ? lse[(size_t)bh * Tq + row] * kLog2e : 0.f;
    dd_r[hh] = in ? dd[(size_t)bh * Tq + row] : 0.f;
  }

  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

  if (kb_end > 0) mbar_wait(&qdo_full, 0);
  for (int kb = 0; kb < kb_end; ++kb) {
    const int s = kb % kStages;
    const int k0 = kb * kRows;
    mbar_wait(&kv_full[s], (kb / kStages) & 1);
    // a tile wholly above this warpgroup's diagonal adds nothing
    if (!causal || k0 <= qg + 63) {
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NP; ++kk)
        wgmma_ss<0>(sc, desc_k(qt_s + (kk / 4) * kTileBytes, kk % 4),
                    desc_k(k_tile(s, kk / 4), kk % 4), 1);
#pragma unroll
      for (int kk = 0; kk < 4 * NP; ++kk)
        wgmma_ss<0>(dp, desc_k(dot_s + (kk / 4) * kTileBytes, kk % 4),
                    desc_k(v_tile(s, kk / 4), kk % 4), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // dS on the fragments: row = query, column = key
      const bool interior = (qg + 64 <= q_len) && (k0 + kRows <= kv_len) &&
                            (!causal || k0 + kRows - 1 <= qg);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        const int row = row0 + 8 * hh;
        const int col = k0 + frag_col(i, lane);
        const bool valid = interior || (row < q_len && col < kv_len &&
                                        (!causal || col <= row));
        const float p =
            valid ? exp2f(sc[i] * scale_log2 - lse_r[hh]) : 0.f;
        dp[i] = p * (dp[i] - dd_r[hh]) * scale;
      }
      uint32_t dsa[16];
      pack_a(dp, dsa);

      fence_regs(dsa);
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          wgmma_rs<1>(acc[p], &dsa[4 * kk], desc_mn(k_tile(s, p), kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&kv_empty[s]);
  }

  const size_t rs = (size_t)H * D;   // elements between rows of a head
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= Tq) continue;
    __nv_bfloat16* qrow = dq + ((size_t)b * Tq + row) * rs + (size_t)h * D;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = p * kPanel + 8 * j + 2 * (lane % 4);
        if (col < D)
          *reinterpret_cast<uint32_t*>(qrow + col) =
              pack_bf16(acc[p][4 * j + 2 * hh], acc[p][4 * j + 2 * hh + 1]);
      }
  }
}

template <int NP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* dd,
                   const int* lens, void* dq, int B, int H, int Tq, int Tk,
                   int D, float scale, int causal, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  if (!make_bthd_map(&mq, q, B, Tq, H, D) ||
      !make_bthd_map(&mk, k, B, Tk, H, D) ||
      !make_bthd_map(&mv, v, B, Tk, H, D) ||
      !make_bthd_map(&mdo, dout, B, Tq, H, D))
    return cudaErrorInvalidValue;
  const size_t smem =
      1024 + (size_t)(2 * kWarpgroups * NP + 2 * kStages * NP) * kTileBytes;
  static size_t configured = 0;
  cudaError_t e =
      set_smem((const void*)flash_dq_sm90_kernel<NP>, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((Tq + 64 * kWarpgroups - 1) / (64 * kWarpgroups), B * H);
  flash_dq_sm90_kernel<NP><<<grid, 128 * kWarpgroups + 32, smem, stream>>>(
      mq, mk, mv, mdo, lse, dd, lens, static_cast<__nv_bfloat16*>(dq), H,
      Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype must be 1 (bfloat16): float32 takes flash_dq_tf32_sm90.cu.
// Returns cudaGetLastError() after the launch (0 on success); the
// wrapper raises on anything else.
extern "C" int pt_flash_dq_sm90(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* dd, const void* lens, void* dq,
                                int B, int H, int Tq, int Tk, int D,
                                float scale, int causal, int dtype,
                                void* stream) {
  if (!shapes_ok(B, H, Tq, Tk, D) || dtype != 1)
    return (int)cudaErrorInvalidValue;
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(dd);
  const int* ln = static_cast<const int*>(lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= kPanel)
    return (int)launch<1>(q, k, v, dout, ls, dl, ln, dq, B, H, Tq, Tk, D,
                          scale, causal, st);
  return (int)launch<2>(q, k, v, dout, ls, dl, ln, dq, B, H, Tq, Tk, D,
                        scale, causal, st);
}

// Flash-attention dq for Hopper's tensor cores (sm_90a), float32, every
// product in 3xTF32 (sm90_tf32.cuh).
//
// Replaces: paddle_tpu/ops/pallas_attention.py:_flash_bwd_dq_kernel
// (launched by _flash_grads) for float32 operands, which the JAX kernel
// multiplies at Precision.HIGHEST (on the TPU itself a multi-pass bf16
// product); bfloat16 takes flash_dq_sm90.cu, dk/dv is
// flash_dkv_tf32_sm90.cu. Same function as flash_dq_sm90.cu documents:
// p = exp2(s*scale*log2e - lse*log2e) under the full (q_len, kv_len,
// causal) mask, the mask applied BEFORE the exponent (a fully-masked
// row's lse is NEG_INF), then with D = rowsum(dO*O)
//   dQ = sum_k dS K,   dS = P (dP - D) scale,   dP = dO V^T,
// accumulated and written in float32. A query row with no valid key
// (past q_len, or kv_len 0) writes 0.
//
// What bounds it on an H100: at the transformer's shapes (b 8, h 8,
// T 1024, d 64, causal) three products of 2*d flops a valid pair, 12.9
// GFLOP; as three TF32 passes at 494.7 TFLOP/s that is 78.2 us, against
// ~84 MB of float32 q/k/v/dO/dq plus lse and D (25 us at 3.35 TB/s).
//
// Design: one block owns (b*h, 64 WG query rows): WG consumer
// warpgroups of 64 rows each and one producer warpgroup.
//   - Each consumer warpgroup splits its own Q and dO rows (loaded once
//     by TMA, 4-D map over [b, T, h, d], 128-byte swizzle, 32 columns a
//     panel) into hi and lo.
//   - The producer walks the key tiles of 32 keys with k0 < kv_len and,
//     under causal, k0 <= q0 + 64 WG - 1 (the JAX kernel's skip at this
//     block height). Its first thread loads K and V by TMA into a ring
//     of STAGES stages (full/empty mbarriers); all 128 threads then
//     write K^T (split into hi and lo, rows = d, the tokens in the k
//     order of the register A fragment), split K and V in place and
//     arrive on the stage's ready barrier.
//   - Per key tile and consumer warpgroup, on wgmma with f32
//     accumulators, three TF32 products each:
//       S  = Q K^T    SS m64n32k8, both K-major;
//       dP = dO V^T   SS m64n32k8, both K-major;
//       dQ += dS K    RS m64n64k8: A = dS split in registers from the
//                     dP accumulator, B = K^T (K-major over keys).
//     Only tiles that straddle q_len, kv_len or the diagonal compute
//     the mask; a warpgroup skips a tile wholly above its diagonal.
//   - No sum crosses blocks, so there are no atomics; under causal the
//     heaviest query blocks are launched first.
// Shared memory sets the plan (Plan below; ops/flash_attention.py
// flash_tf32_plan mirrors it and chip_smoke.py holds the two equal): at
// d <= 64, 2 consumer warpgroups and a 2-stage ring, 225 KB; at d <= 128
// one consumer warpgroup and one stage, at most 225 KB. The step count
// over d is fixed at compile time (NPF panels of 32 columns; columns
// past d are zeros), and the next tile's S is not issued before this
// tile's dQ product.
//
// Build: see flash_fwd_sm90.cu.

#include "flash_common.cuh"
#include "sm90_tf32.cuh"

namespace {

using namespace flash;
using namespace tf32;

constexpr int kBK = 32;                        // keys a tile
constexpr uint32_t kRowTile = 64 * kRowBytes;  // 64 rows of one panel

// The launch at NPF panels of 32 columns of d
template <int NPF>
struct Plan {
  static constexpr int kNP = (NPF + 1) / 2;       // 64-column dQ panels
  static constexpr int kWG = NPF <= 2 ? 2 : 1;    // consumer warpgroups
  static constexpr int kStages = NPF <= 2 ? 2 : 1;
  static constexpr uint32_t kQ = NPF * kRowTile;  // a warpgroup's Q rows
  static constexpr uint32_t kKV = NPF * kBK * kRowBytes;   // a K tile
  static constexpr uint32_t kKT = kNP * kRowTile;          // K^T, hi or lo
  static constexpr uint32_t kStage = 4 * kKV + 2 * kKT;
  static constexpr uint32_t kSmem = 1024 + 4 * kWG * kQ + kStages * kStage;
};

template <int NPF>
__global__ void __launch_bounds__(128 * (Plan<NPF>::kWG + 1), 1)
    flash_dq_tf32_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ dd,
                         const int* __restrict__ lens,
                         float* __restrict__ dq, int H, int Tq, int Tk,
                         int D, float scale, int causal) {
  using P = Plan<NPF>;
  constexpr int kWG = P::kWG;
  constexpr int kStages = P::kStages;
  constexpr int kNP = P::kNP;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t qdo_full;
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t ready[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  uint8_t* smem = align1024(smem_raw);
  // Q hi, Q lo, dO hi, dO lo (kQ a warpgroup each), then per stage:
  // K hi, K lo, V hi, V lo, K^T hi, K^T lo
  uint8_t* const q_hi = smem;
  uint8_t* const q_lo = q_hi + kWG * P::kQ;
  uint8_t* const do_hi = q_lo + kWG * P::kQ;
  uint8_t* const do_lo = do_hi + kWG * P::kQ;
  uint8_t* const ring = do_lo + kWG * P::kQ;
  auto k_hi = [&](int s) { return ring + s * P::kStage; };
  auto k_lo = [&](int s) { return ring + s * P::kStage + P::kKV; };
  auto v_hi = [&](int s) { return ring + s * P::kStage + 2 * P::kKV; };
  auto v_lo = [&](int s) { return ring + s * P::kStage + 3 * P::kKV; };
  auto k_t = [&](int s) { return ring + s * P::kStage + 4 * P::kKV; };

  constexpr int kRowsBlock = 64 * kWG;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kRowsBlock;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q_len = min(lens[2 * b], Tq);
  const int kv_len = min(lens[2 * b + 1], Tk);
  int kb_end = (kv_len + kBK - 1) / kBK;
  if (causal) kb_end = min(kb_end, (q0 + kRowsBlock - 1) / kBK + 1);
  if (q0 >= q_len) kb_end = 0;       // every p is masked: dq = 0

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  if (threadIdx.x == 0) {
    mbar_init(&qdo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], 128);       // every producer thread
      mbar_init(&empty[s], 4 * kWG);   // one arrive a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kWG) {                   // ---- producer warpgroup
    if (kb_end == 0) return;
    if (t == 0) {
      tma_prefetch_map(&map_k);
      tma_prefetch_map(&map_v);
      mbar_expect_tx(&qdo_full, 2 * kWG * P::kQ);
      for (int g = 0; g < kWG; ++g)
        for (int p = 0; p < NPF; ++p) {
          tma_load(q_hi + g * P::kQ + p * kRowTile, &map_q, &qdo_full,
                   p * kCols, h, q0 + 64 * g, b);
          tma_load(do_hi + g * P::kQ + p * kRowTile, &map_do, &qdo_full,
                   p * kCols, h, q0 + 64 * g, b);
        }
    }
    for (int kb = 0; kb < kb_end; ++kb) {
      const int s = kb % kStages;
      const uint32_t par = (kb / kStages) & 1;
      if (t == 0) {
        mbar_wait(&empty[s], par ^ 1);
        mbar_expect_tx(&full[s], 2 * P::kKV);
        for (int p = 0; p < NPF; ++p) {
          tma_load(k_hi(s) + p * kBK * kRowBytes, &map_k, &full[s],
                   p * kCols, h, kb * kBK, b);
          tma_load(v_hi(s) + p * kBK * kRowBytes, &map_v, &full[s],
                   p * kCols, h, kb * kBK, b);
        }
      }
      mbar_wait(&full[s], par);
      transpose_tile<kBK, NPF>(k_hi(s), k_t(s), P::kKT, t, 128);
      split_tile<kBK, NPF>(v_hi(s), v_hi(s), v_lo(s), t, 128);
      group_sync(1, 128);            // K^T read K before it is split
      split_tile<kBK, NPF>(k_hi(s), k_hi(s), k_lo(s), t, 128);
      fence_proxy_async_shared();    // the split, before wgmma reads it
      mbar_arrive(&ready[s]);
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows q0 + 64 wg .. q0 + 64 wg + 63
  const int qg = q0 + 64 * wg;
  const int row0 = qg + 16 * warp + lane / 4;   // and row0 + 8
  uint8_t* const qh = q_hi + wg * P::kQ;
  uint8_t* const ql = q_lo + wg * P::kQ;
  uint8_t* const dh = do_hi + wg * P::kQ;
  uint8_t* const dl = do_lo + wg * P::kQ;
  const float scale_log2 = scale * kLog2e;
  float lse_r[2], dd_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    const bool in = row < Tq && kb_end > 0;
    lse_r[hh] = in ? lse[(size_t)bh * Tq + row] * kLog2e : 0.f;
    dd_r[hh] = in ? dd[(size_t)bh * Tq + row] : 0.f;
  }

  float acc[kNP][32];
#pragma unroll
  for (int p = 0; p < kNP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

  if (kb_end > 0) {
    mbar_wait(&qdo_full, 0);
    split_tile<64, NPF>(qh, qh, ql, t, 128);
    split_tile<64, NPF>(dh, dh, dl, t, 128);
    fence_proxy_async_shared();
    group_sync(2 + wg, 128);
  }
  for (int kb = 0; kb < kb_end; ++kb) {
    const int s = kb % kStages;
    const int k0 = kb * kBK;
    mbar_wait(&ready[s], (kb / kStages) & 1);
    // a tile wholly above this warpgroup's diagonal adds nothing
    if (!causal || k0 <= qg + 63) {
      float sc[16], dp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] = dp[i] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      // the small passes of both products first, then the large ones
#pragma unroll
      for (int p = 0; p < NPF; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          mma_small_ss(sc, desc_k(qh + p * kRowTile, kk),
                       desc_k(ql + p * kRowTile, kk),
                       desc_k(k_hi(s) + p * kBK * kRowBytes, kk),
                       desc_k(k_lo(s) + p * kBK * kRowBytes, kk));
          mma_small_ss(dp, desc_k(dh + p * kRowTile, kk),
                       desc_k(dl + p * kRowTile, kk),
                       desc_k(v_hi(s) + p * kBK * kRowBytes, kk),
                       desc_k(v_lo(s) + p * kBK * kRowBytes, kk));
        }
#pragma unroll
      for (int p = 0; p < NPF; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss(sc, desc_k(qh + p * kRowTile, kk),
                   desc_k(k_hi(s) + p * kBK * kRowBytes, kk));
          wgmma_ss(dp, desc_k(dh + p * kRowTile, kk),
                   desc_k(v_hi(s) + p * kBK * kRowBytes, kk));
        }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // dS on the fragments: row = query, column = key
      const bool interior = (qg + 64 <= q_len) && (k0 + kBK <= kv_len) &&
                            (!causal || k0 + kBK - 1 <= qg);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int hh = (i >> 1) & 1;
        const int row = row0 + 8 * hh;
        const int col = k0 + frag_col(i, lane);
        const bool valid = interior || (row < q_len && col < kv_len &&
                                        (!causal || col <= row));
        const float p =
            valid ? exp2f(sc[i] * scale_log2 - lse_r[hh]) : 0.f;
        dp[i] = p * (dp[i] - dd_r[hh]) * scale;
      }
      uint32_t ah[16], al[16];
      split_a(dp, ah, al);

      fence_regs(ah);
      fence_regs(al);
#pragma unroll
      for (int p = 0; p < kNP; ++p) fence_regs(acc[p]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
        for (int p = 0; p < kNP; ++p)
          mma_small_rs(acc[p], &ah[4 * kk], &al[4 * kk],
                       desc_k(tr_part<kBK>(k_t(s), P::kKT, 0, p), kk),
                       desc_k(tr_part<kBK>(k_t(s), P::kKT, 1, p), kk));
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
        for (int p = 0; p < kNP; ++p)
          wgmma_rs(acc[p], &ah[4 * kk],
                   desc_k(tr_part<kBK>(k_t(s), P::kKT, 0, p), kk));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < kNP; ++p) fence_regs(acc[p]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const size_t rs = (size_t)H * D;   // elements between rows of a head
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= Tq) continue;
    float* qrow = dq + ((size_t)b * Tq + row) * rs + (size_t)h * D;
#pragma unroll
    for (int p = 0; p < kNP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = p * 64 + 8 * j + 2 * (lane % 4);
        if (col < D)
          *reinterpret_cast<float2*>(qrow + col) =
              make_float2(acc[p][4 * j + 2 * hh], acc[p][4 * j + 2 * hh + 1]);
      }
  }
}

template <int NPF>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* dd,
                   const int* lens, void* dq, int B, int H, int Tq, int Tk,
                   int D, float scale, int causal, cudaStream_t stream) {
  using P = Plan<NPF>;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_bthd_map_f32(&mq, q, B, Tq, H, D, 64) ||
      !make_bthd_map_f32(&mk, k, B, Tk, H, D, kBK) ||
      !make_bthd_map_f32(&mv, v, B, Tk, H, D, kBK) ||
      !make_bthd_map_f32(&mdo, dout, B, Tq, H, D, 64))
    return cudaErrorInvalidValue;
  static size_t configured = 0;
  cudaError_t e = set_smem((const void*)flash_dq_tf32_kernel<NPF>, P::kSmem,
                           configured);
  if (e != cudaSuccess) return e;
  dim3 grid((Tq + 64 * P::kWG - 1) / (64 * P::kWG), B * H);
  (void)cudaGetLastError();          // report this launch's error only
  flash_dq_tf32_kernel<NPF><<<grid, 128 * (P::kWG + 1), P::kSmem, stream>>>(
      mq, mk, mv, mdo, lse, dd, lens, static_cast<float*>(dq), H, Tq, Tk, D,
      scale, causal);
  return cudaGetLastError();
}

template <int NPF>
int fill_plan(int* plan) {
  using P = Plan<NPF>;
  cudaFuncAttributes attr;
  const cudaError_t e =
      cudaFuncGetAttributes(&attr, (const void*)flash_dq_tf32_kernel<NPF>);
  if (e != cudaSuccess) return (int)e;
  const int out[6] = {P::kWG,    64 * P::kWG,    kBK,
                      P::kStages, (int)P::kSmem, (int)attr.sharedSizeBytes};
  for (int i = 0; i < 6; ++i) plan[i] = out[i];
  return 0;
}

// phase 1's check of the 3xTF32 building blocks: A [64, 64] and B
// [32, 64] float32, loaded by TMA through make_bthd_map_f32 (as
// [1, T, 1, 64]) and split; C = A B^T in 3xTF32 SS (m64n32k8, both
// K-major), then E = C B in 3xTF32 RS (m64n64k8), C split in registers
// from its accumulator (split_a) and B^T written by transpose_tile.
__global__ void __launch_bounds__(128, 1)
    tf32_product_check_kernel(const __grid_constant__ CUtensorMap map_a,
                              const __grid_constant__ CUtensorMap map_b,
                              float* __restrict__ c, float* __restrict__ e) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  uint8_t* smem = align1024(smem_raw);
  uint8_t* a_hi = smem;                      // 2 panels x 64 rows
  uint8_t* a_lo = a_hi + 2 * kRowTile;
  uint8_t* b_hi = a_lo + 2 * kRowTile;       // 2 panels x 32 rows
  uint8_t* b_lo = b_hi + 2 * kBK * kRowBytes;
  uint8_t* b_t = b_lo + 2 * kBK * kRowBytes;  // hi panel, lo panel
  const int t = threadIdx.x;
  if (t == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(&bar, 2 * kRowTile + 2 * kBK * kRowBytes);
    for (int p = 0; p < 2; ++p) {
      tma_load(a_hi + p * kRowTile, &map_a, &bar, p * kCols, 0, 0, 0);
      tma_load(b_hi + p * kBK * kRowBytes, &map_b, &bar, p * kCols, 0, 0, 0);
    }
  }
  mbar_wait(&bar, 0);
  transpose_tile<kBK, 2>(b_hi, b_t, kRowTile, t, 128);
  split_tile<64, 2>(a_hi, a_hi, a_lo, t, 128);
  __syncthreads();
  split_tile<kBK, 2>(b_hi, b_hi, b_lo, t, 128);
  fence_proxy_async_shared();
  __syncthreads();

  float cc[16], ee[32];
#pragma unroll
  for (int i = 0; i < 16; ++i) cc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) ee[i] = 0.f;
  fence_regs(cc);
  wgmma_fence();
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_small_ss(cc, desc_k(a_hi + p * kRowTile, kk),
                   desc_k(a_lo + p * kRowTile, kk),
                   desc_k(b_hi + p * kBK * kRowBytes, kk),
                   desc_k(b_lo + p * kBK * kRowBytes, kk));
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(cc, desc_k(a_hi + p * kRowTile, kk),
               desc_k(b_hi + p * kBK * kRowBytes, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(cc);
  uint32_t ch[16], cl[16];
  split_a(cc, ch, cl);
  fence_regs(ch);
  fence_regs(cl);
  fence_regs(ee);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk)
    mma_small_rs(ee, &ch[4 * kk], &cl[4 * kk],
                 desc_k(tr_part<kBK>(b_t, kRowTile, 0, 0), kk),
                 desc_k(tr_part<kBK>(b_t, kRowTile, 1, 0), kk));
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk)
    wgmma_rs(ee, &ch[4 * kk], desc_k(tr_part<kBK>(b_t, kRowTile, 0, 0), kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(ee);
  const int w = t / 32;
  const int l = t % 32;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    c[frag_row(i, w, l) * kBK + frag_col(i, l)] = cc[i];
#pragma unroll
  for (int i = 0; i < 32; ++i)
    e[frag_row(i, w, l) * 64 + frag_col(i, l)] = ee[i];
}

}  // namespace

// dtype must be 0 (float32): bfloat16 takes flash_dq_sm90.cu. Returns
// cudaGetLastError() after the launch (0 on success); the wrapper
// raises on anything else.
extern "C" int pt_flash_dq_tf32_sm90(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* dd,
                                     const void* lens, void* dq, int B,
                                     int H, int Tq, int Tk, int D,
                                     float scale, int causal, int dtype,
                                     void* stream) {
  if (!shapes_ok(B, H, Tq, Tk, D) || dtype != 0)
    return (int)cudaErrorInvalidValue;
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(dd);
  const int* ln = static_cast<const int*>(lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + kCols - 1) / kCols) {
    case 1:
      return (int)launch<1>(q, k, v, dout, ls, dl, ln, dq, B, H, Tq, Tk, D,
                            scale, causal, st);
    case 2:
      return (int)launch<2>(q, k, v, dout, ls, dl, ln, dq, B, H, Tq, Tk, D,
                            scale, causal, st);
    case 3:
      return (int)launch<3>(q, k, v, dout, ls, dl, ln, dq, B, H, Tq, Tk, D,
                            scale, causal, st);
    default:
      return (int)launch<4>(q, k, v, dout, ls, dl, ln, dq, B, H, Tq, Tk, D,
                            scale, causal, st);
  }
}

// The launch's plan at head dim D: plan[0..5] = consumer warpgroups,
// query rows a block, keys a tile, stages, dynamic and static shared
// bytes (ops/flash_attention.py flash_tf32_plan("dq", D) must agree).
extern "C" int pt_flash_dq_tf32_plan(int D, int* plan) {
  if (D <= 0 || D % 8 != 0 || D > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  switch ((D + kCols - 1) / kCols) {
    case 1: return fill_plan<1>(plan);
    case 2: return fill_plan<2>(plan);
    case 3: return fill_plan<3>(plan);
    default: return fill_plan<4>(plan);
  }
}

// a [64, 64], b [32, 64] float32 on the card; writes c [64, 32] = a b^T
// and e [64, 64] = c b (phase 1 of chip_smoke.py)
extern "C" int pt_tf32_product_check(const void* a, const void* b, void* c,
                                     void* e, void* stream) {
  CUtensorMap ma, mb;
  if (!make_bthd_map_f32(&ma, a, 1, 64, 1, 64, 64) ||
      !make_bthd_map_f32(&mb, b, 1, kBK, 1, 64, kBK))
    return (int)cudaErrorInvalidValue;
  const size_t smem = 1024 + 6 * kRowTile + 4 * kBK * kRowBytes;
  static size_t configured = 0;
  cudaError_t err =
      set_smem((const void*)tf32_product_check_kernel, smem, configured);
  if (err != cudaSuccess) return (int)err;
  (void)cudaGetLastError();
  tf32_product_check_kernel<<<1, 128, smem, static_cast<cudaStream_t>(
                                                stream)>>>(
      ma, mb, static_cast<float*>(c), static_cast<float*>(e));
  return (int)cudaGetLastError();
}

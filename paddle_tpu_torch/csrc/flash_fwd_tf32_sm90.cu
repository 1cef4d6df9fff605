// Flash-attention forward for Hopper's tensor cores (sm_90a), float32,
// both products in 3xTF32 (sm90_tf32.cuh).
//
// Replaces: paddle_tpu/ops/pallas_attention.py:_flash_kernel (launched
// by _flash_call, public flash_attention) for float32 q/k/v, which the
// JAX kernel multiplies at Precision.HIGHEST; bfloat16 takes
// flash_fwd_sm90.cu. Same function: softmax attention of each query row
// over the key rows under the per-row (q_len, kv_len) mask and, if
// causal, cols <= rows, computed as a base-2 online softmax
// (scale*log2(e) folded into the scores, p zeroed explicitly on masked
// entries); rows with no valid column (rows >= q_len among them) write
// 0, and lse ([b*h, Tq] float32) is the row logsumexp in natural units
// (m*ln2 + ln l), NEG_INF where l == 0.
//
// What bounds it on an H100: at the transformer's shapes (b 8, h 8,
// T 1024, d 64, causal) two products of 2*d flops a valid pair, 8.6
// GFLOP; as three TF32 passes at 494.7 TFLOP/s that is 52.1 us, against
// 67.4 MB of float32 q/k/v/out plus lse (20.1 us at 3.35 TB/s).
//
// Design: the dataflow of flash_dq_tf32_sm90.cu without its dP product.
// One block owns (b*h, 64 WG query rows): WG consumer warpgroups of 64
// rows each and one producer warpgroup.
//   - The producer's first thread loads every consumer's Q rows once by
//     TMA (4-D map over [b, T, h, d], 128-byte swizzle, 32 columns a
//     panel); each consumer warpgroup splits its own into hi and lo.
//   - The producer walks the key tiles of BK keys (64 at d <= 64, else
//     32) with k0 < kv_len and, under causal, k0 <= q0 + 64 WG - 1. Its
//     first thread loads K and V by TMA into a 2-stage ring (full/empty
//     mbarriers), V in 32-key halves; all 128 threads then write V^T of
//     each half (split into hi and lo, rows = d, the tokens in the k
//     order of the register A fragment), split K in place and arrive on
//     the stage's ready barrier.
//   - Per key tile and consumer warpgroup, on wgmma with f32
//     accumulators, three TF32 products each, small passes first:
//       S  = Q K^T    SS m64nBKk8, both K-major;
//       O += P V      RS m64n64k8: A = P split in registers from the S
//                     accumulator, B = V^T (K-major over keys).
//     Between the two the online update runs in registers on the S
//     fragments (flash_common.cuh online_softmax, as in
//     flash_fwd_sm90.cu), and O is rescaled in place. Only tiles that
//     straddle q_len, kv_len or the diagonal compute the mask; a
//     warpgroup skips a tile wholly above its own diagonal.
//   - A block wholly past q_len writes zeros and NEG_INF; under causal
//     the heaviest query blocks are launched first; the epilogue writes
//     O / l and lse straight from the fragments.
// Shared memory and registers set the plan (Plan below;
// ops/flash_attention.py flash_tf32_plan("fwd", d) mirrors it and
// chip_smoke.py holds the two equal): at d <= 64, 2 consumer warpgroups
// and 64-key tiles, 225 KB (a 64-key tile halves the per-tile chain of
// waits, shuffles and rescales: 145 us against 177 us at 32 keys with 3
// stages, and 204 us with 3 consumer warpgroups, on the H100 at the
// shapes above); at d <= 128 one consumer warpgroup and 32-key tiles,
// at most 225 KB. The step count over d is fixed at compile time (NPF
// panels of 32 columns; columns past d are zeros).
//
// Build: see flash_fwd_sm90.cu.

#include "flash_common.cuh"
#include "sm90_tf32.cuh"

namespace {

using namespace flash;
using namespace tf32;

constexpr uint32_t kRowTile = 64 * kRowBytes;  // 64 rows of one panel
constexpr uint32_t kHalfTile = 32 * kRowBytes; // 32 rows of one panel

// The launch at NPF panels of 32 columns of d
template <int NPF>
struct Plan {
  static constexpr int kNP = (NPF + 1) / 2;       // 64-column O panels
  static constexpr int kWG = NPF <= 2 ? 2 : 1;    // consumer warpgroups
  static constexpr int kBK = NPF <= 2 ? 64 : 32;  // keys a tile
  static constexpr int kHalves = kBK / 32;        // 32-key halves of V
  static constexpr int kStages = 2;
  static constexpr uint32_t kQ = NPF * kRowTile;  // a warpgroup's Q rows
  static constexpr uint32_t kKV = NPF * kBK * kRowBytes;   // a K or V tile
  static constexpr uint32_t kVT = kNP * kRowTile;  // V^T of 32 keys, hi/lo
  static constexpr uint32_t kStage = 3 * kKV + 2 * kHalves * kVT;
  static constexpr uint32_t kSmem = 1024 + 2 * kWG * kQ + kStages * kStage;
};

template <int NPF>
__global__ void __launch_bounds__(128 * (Plan<NPF>::kWG + 1), 1)
    flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const int* __restrict__ lens,
                          float* __restrict__ out, float* __restrict__ lse,
                          int H, int Tq, int Tk, int D, float scale_log2,
                          int causal) {
  using P = Plan<NPF>;
  constexpr int kWG = P::kWG;
  constexpr int kStages = P::kStages;
  constexpr int kNP = P::kNP;
  constexpr int kBK = P::kBK;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t ready[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  uint8_t* smem = align1024(smem_raw);
  // Q hi, Q lo (kQ a warpgroup each), then per stage: K hi, K lo, the V
  // tile as loaded (32-key halves), V^T hi and lo of each half
  uint8_t* const q_hi = smem;
  uint8_t* const q_lo = q_hi + kWG * P::kQ;
  uint8_t* const ring = q_lo + kWG * P::kQ;
  auto k_hi = [&](int s) { return ring + s * P::kStage; };
  auto k_lo = [&](int s) { return ring + s * P::kStage + P::kKV; };
  auto v_in = [&](int s) { return ring + s * P::kStage + 2 * P::kKV; };
  auto v_t = [&](int s) { return ring + s * P::kStage + 3 * P::kKV; };

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
  if (q0 >= q_len) kb_end = 0;       // every row masked

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
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
      mbar_expect_tx(&q_full, kWG * P::kQ);
      for (int g = 0; g < kWG; ++g)
        for (int p = 0; p < NPF; ++p)
          tma_load(q_hi + g * P::kQ + p * kRowTile, &map_q, &q_full,
                   p * kCols, h, q0 + 64 * g, b);
    }
    for (int kb = 0; kb < kb_end; ++kb) {
      const int s = kb % kStages;
      const uint32_t par = (kb / kStages) & 1;
      if (t == 0) {
        mbar_wait(&empty[s], par ^ 1);
        mbar_expect_tx(&full[s], 2 * P::kKV);
        for (int p = 0; p < NPF; ++p)
          tma_load(k_hi(s) + p * kBK * kRowBytes, &map_k, &full[s],
                   p * kCols, h, kb * kBK, b);
        for (int hf = 0; hf < P::kHalves; ++hf)
          for (int p = 0; p < NPF; ++p)
            tma_load(v_in(s) + (hf * NPF + p) * kHalfTile, &map_v, &full[s],
                     p * kCols, h, kb * kBK + 32 * hf, b);
      }
      mbar_wait(&full[s], par);
      for (int hf = 0; hf < P::kHalves; ++hf)
        transpose_tile<32, NPF>(v_in(s) + hf * NPF * kHalfTile,
                                v_t(s) + hf * 2 * P::kVT, P::kVT, t, 128);
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

  float o[kNP][32];
#pragma unroll
  for (int p = 0; p < kNP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  if (kb_end > 0) {
    mbar_wait(&q_full, 0);
    split_tile<64, NPF>(qh, qh, ql, t, 128);
    fence_proxy_async_shared();
    group_sync(2 + wg, 128);
  }
  for (int kb = 0; kb < kb_end; ++kb) {
    const int s = kb % kStages;
    const int k0 = kb * kBK;
    mbar_wait(&ready[s], (kb / kStages) & 1);
    // a tile wholly above this warpgroup's diagonal adds nothing
    if (!causal || k0 <= qg + 63) {
      float sc[kBK / 2];
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < NPF; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_small_ss(sc, desc_k(qh + p * kRowTile, kk),
                       desc_k(ql + p * kRowTile, kk),
                       desc_k(k_hi(s) + p * kBK * kRowBytes, kk),
                       desc_k(k_lo(s) + p * kBK * kRowBytes, kk));
#pragma unroll
      for (int p = 0; p < NPF; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(sc, desc_k(qh + p * kRowTile, kk),
                   desc_k(k_hi(s) + p * kBK * kRowBytes, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      const bool interior = (qg + 64 <= q_len) && (k0 + kBK <= kv_len) &&
                            (!causal || k0 + kBK - 1 <= qg);
      if (interior)
        online_softmax<false, kBK / 2, kNP>(sc, o, m, l, scale_log2, row0,
                                            k0, q_len, kv_len, causal, lane);
      else
        online_softmax<true, kBK / 2, kNP>(sc, o, m, l, scale_log2, row0,
                                           k0, q_len, kv_len, causal, lane);
      uint32_t ph[kBK / 2], pl[kBK / 2];
      split_a(sc, ph, pl);

      fence_regs(ph);
      fence_regs(pl);
#pragma unroll
      for (int p = 0; p < kNP; ++p) fence_regs(o[p]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
        for (int p = 0; p < kNP; ++p) {
          const uint8_t* vt = v_t(s) + (kk / 4) * 2 * P::kVT;
          mma_small_rs(o[p], &ph[4 * kk], &pl[4 * kk],
                       desc_k(tr_part<32>(vt, P::kVT, 0, p), kk % 4),
                       desc_k(tr_part<32>(vt, P::kVT, 1, p), kk % 4));
        }
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
        for (int p = 0; p < kNP; ++p)
          wgmma_rs(o[p], &ph[4 * kk],
                   desc_k(tr_part<32>(v_t(s) + (kk / 4) * 2 * P::kVT, P::kVT,
                                      0, p),
                          kk % 4));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < kNP; ++p) fence_regs(o[p]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
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
    float* orow = out + ((size_t)b * Tq + row) * rs + (size_t)h * D;
#pragma unroll
    for (int p = 0; p < kNP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = p * 64 + 8 * j + 2 * (lane % 4);
        if (col < D)
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(o[p][4 * j + 2 * hh] * inv[hh],
                          o[p][4 * j + 2 * hh + 1] * inv[hh]);
      }
    if (lane % 4 == 0)
      lse[(size_t)bh * Tq + row] =
          l[hh] > 0.f ? m[hh] * kLn2 + logf(l[hh]) : kNegInf;
  }
}

template <int NPF>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lens, void* out, float* lse, int B, int H,
                   int Tq, int Tk, int D, float scale, int causal,
                   cudaStream_t stream) {
  using P = Plan<NPF>;
  CUtensorMap mq, mk, mv;
  if (!make_bthd_map_f32(&mq, q, B, Tq, H, D, 64) ||
      !make_bthd_map_f32(&mk, k, B, Tk, H, D, P::kBK) ||
      !make_bthd_map_f32(&mv, v, B, Tk, H, D, 32))
    return cudaErrorInvalidValue;
  static size_t configured = 0;
  cudaError_t e = set_smem((const void*)flash_fwd_tf32_kernel<NPF>, P::kSmem,
                           configured);
  if (e != cudaSuccess) return e;
  dim3 grid((Tq + 64 * P::kWG - 1) / (64 * P::kWG), B * H);
  (void)cudaGetLastError();          // report this launch's error only
  flash_fwd_tf32_kernel<NPF><<<grid, 128 * (P::kWG + 1), P::kSmem, stream>>>(
      mq, mk, mv, lens, static_cast<float*>(out), lse, H, Tq, Tk, D,
      scale * kLog2e, causal);
  return cudaGetLastError();
}

template <int NPF>
int fill_plan(int* plan) {
  using P = Plan<NPF>;
  cudaFuncAttributes attr;
  const cudaError_t e =
      cudaFuncGetAttributes(&attr, (const void*)flash_fwd_tf32_kernel<NPF>);
  if (e != cudaSuccess) return (int)e;
  const int out[6] = {P::kWG,    64 * P::kWG,    P::kBK,
                      P::kStages, (int)P::kSmem, (int)attr.sharedSizeBytes};
  for (int i = 0; i < 6; ++i) plan[i] = out[i];
  return 0;
}

}  // namespace

// dtype must be 0 (float32): bfloat16 takes flash_fwd_sm90.cu. Returns
// cudaGetLastError() after the launch (0 on success); the wrapper
// raises on anything else.
extern "C" int pt_flash_fwd_tf32_sm90(const void* q, const void* k,
                                      const void* v, const void* lens,
                                      void* out, void* lse, int B, int H,
                                      int Tq, int Tk, int D, float scale,
                                      int causal, int dtype, void* stream) {
  if (!shapes_ok(B, H, Tq, Tk, D) || dtype != 0)
    return (int)cudaErrorInvalidValue;
  const int* ln = static_cast<const int*>(lens);
  float* ls = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + kCols - 1) / kCols) {
    case 1:
      return (int)launch<1>(q, k, v, ln, out, ls, B, H, Tq, Tk, D, scale,
                            causal, st);
    case 2:
      return (int)launch<2>(q, k, v, ln, out, ls, B, H, Tq, Tk, D, scale,
                            causal, st);
    case 3:
      return (int)launch<3>(q, k, v, ln, out, ls, B, H, Tq, Tk, D, scale,
                            causal, st);
    default:
      return (int)launch<4>(q, k, v, ln, out, ls, B, H, Tq, Tk, D, scale,
                            causal, st);
  }
}

// The launch's plan at head dim D: plan[0..5] = consumer warpgroups,
// query rows a block, keys a tile, stages, dynamic and static shared
// bytes (ops/flash_attention.py flash_tf32_plan("fwd", D) must agree).
extern "C" int pt_flash_fwd_tf32_plan(int D, int* plan) {
  if (D <= 0 || D % 8 != 0 || D > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  switch ((D + kCols - 1) / kCols) {
    case 1: return fill_plan<1>(plan);
    case 2: return fill_plan<2>(plan);
    case 3: return fill_plan<3>(plan);
    default: return fill_plan<4>(plan);
  }
}

// Flash-attention dk/dv for Hopper's tensor cores (sm_90a), float32,
// every product in 3xTF32 (sm90_tf32.cuh).
//
// Replaces: paddle_tpu/ops/pallas_attention.py:_flash_bwd_dkv_kernel
// (launched by _flash_grads) for float32 operands, which the JAX kernel
// multiplies at Precision.HIGHEST; bfloat16 takes flash_dkv_sm90.cu,
// the float32 dq is flash_dq_tf32_sm90.cu. Same function as
// flash_dkv_sm90.cu documents: p = exp2(s*scale*log2e - lse*log2e)
// under the full (q_len, kv_len, causal) mask, the mask applied BEFORE
// the exponent, then with D = rowsum(dO*O)
//   dV = sum_q P^T dO,   dK = sum_q dS^T Q,   dS = P (dP - D) scale,
// accumulated and written in float32. A key block wholly past kv_len
// writes zeros.
//
// What bounds it on an H100: at the transformer's shapes (b 8, h 8,
// T 1024, d 64, causal) four products of 2*d flops a valid pair, 17.2
// GFLOP; as three TF32 passes at 494.7 TFLOP/s that is 104.3 us,
// against ~101 MB of float32 q/k/v/dO/dk/dv plus lse and D (30 us at
// 3.35 TB/s).
//
// Design: one block owns 64 key rows of one (b*h): WG consumer
// warpgroups (2 at d <= 64, 1 above), each holding dV and dK over all
// of d for the query tiles it takes, and one producer warp.
//   - The producer loads K and V once by TMA (4-D map over [b, T, h,
//     d], 128-byte swizzle, 32 columns a panel), which the consumers
//     split into hi and lo together; then it walks the query tiles of
//     BQ queries (32 at d <= 64, 16 above, where shared memory is
//     short) with q0 < q_len and, under causal, q0 + BQ - 1 >= k0,
//     loading Q and dO by TMA into a ring of STAGES stages (full/empty
//     mbarriers), its 32 lanes copying the tile's lse*log2e and D.
//   - Consumer warpgroup g takes tiles g, g + WG, ...: it splits the
//     tile's Q and dO in place, writes Q^T and dO^T (hi and lo, rows =
//     d, the queries in the k order of the register A fragment), then
//     on wgmma with f32 accumulators, three TF32 products each:
//       S^T  = K Q^T     SS m64nBQk8, both K-major;
//       dP^T = V dO^T    SS m64nBQk8, both K-major;
//       dV  += P^T dO    RS m64n64k8: A = P^T split in registers from
//                        the S^T accumulator, B = dO^T;
//       dK  += dS^T Q    RS m64n64k8: A = dS^T, B = Q^T.
//     With two, one warpgroup's split and elementwise work overlaps the
//     other's products (a lone one took 476.66 us against 403.42 at the
//     training shapes, H100 80GB HBM3, 700 W, chip_smoke.py phase 9;
//     splitting the tile into a landing slot and a work area, or
//     staging P^T and dS^T in shared memory for SS products, gained
//     nothing there); at the end
//     each hands the other half of its sums through its own stage (the
//     ring has one stage a warpgroup) and stores dV (g 0) or dK (g 1).
//     Only tiles that straddle q_len, kv_len or the diagonal compute
//     the mask. The tensor cores round each accumulation toward zero,
//     so every product issues its small passes first; and dP^T, which
//     cancels against D (exactly, for a key that is a row's only one)
//     before dK sums it over every query row, keeps its large passes in
//     one accumulator per 32-column panel (two at d > 96, where
//     registers run out), added in float32: one accumulator put ~4e-5
//     of noise on such a dK at full width, past the float32 tolerance
//     (atol 2e-5).
//   - No sum crosses blocks, so there are no atomics.
// Shared memory sets the plan (Plan below; ops/flash_attention.py
// flash_tf32_plan mirrors it and chip_smoke.py holds the two equal): K
// and V split stay resident (32 KB a 32-column panel), a stage holds Q
// and dO split and their transposed copies; d <= 64: BQ 32, 2 stages,
// 193 KB; d <= 96: BQ 16, 2 stages, 209 KB; d <= 128: BQ 16, 1 stage,
// 193 KB. With BQ 16 the lo half of a transposed copy shares the hi
// half's 128-byte rows. The step count over d is fixed at compile time.
//
// Build: see flash_fwd_sm90.cu.

#include "flash_common.cuh"
#include "sm90_tf32.cuh"

namespace {

using namespace flash;
using namespace tf32;

constexpr uint32_t kRowTile = 64 * kRowBytes;  // 64 rows of one panel

// The launch at NPF panels of 32 columns of d
template <int NPF>
struct Plan {
  static constexpr int kNP = (NPF + 1) / 2;       // 64-column dK/dV panels
  static constexpr int kWG = NPF <= 2 ? 2 : 1;    // consumer warpgroups
  static constexpr int kBQ = NPF <= 2 ? 32 : 16;  // queries a tile
  static constexpr int kStages = NPF <= 3 ? 2 : 1;
  // dP^T accumulators (below): one a panel, two at d > 96 (registers)
  static constexpr int kAccP = NPF <= 3 ? NPF : 2;
  static constexpr uint32_t kKV = NPF * kRowTile;            // K, hi or lo
  static constexpr uint32_t kQ = NPF * kBQ * kRowBytes;      // a Q tile
  static constexpr uint32_t kTP = kNP * kRowTile;   // a transposed panel
  static constexpr uint32_t kT = (2 * kBQ / kCols) * kTP;    // hi and lo
  static constexpr uint32_t kStage = 4 * kQ + 2 * kT;
  static constexpr uint32_t kSmem = 1024 + 4 * kKV + kStages * kStage;
  static_assert(kWG == 1 || (kStages == kWG && kNP == 1 &&
                             kStage >= 32 * 128 * 4),
                "two warpgroups: a stage each, each holding a sum");
};

template <int NPF>
__global__ void __launch_bounds__(128 * Plan<NPF>::kWG + 32, 1)
    flash_dkv_tf32_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ dd,
                          const int* __restrict__ lens,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int H, int Tq, int Tk, int D, float scale,
                          int causal) {
  using P = Plan<NPF>;
  constexpr int kWG = P::kWG;
  constexpr int kBQ = P::kBQ;
  constexpr int kStages = P::kStages;
  constexpr int kNP = P::kNP;
  constexpr int kAccP = P::kAccP;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full;
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ float lse_s[kStages][kBQ];   // lse * log2(e)
  __shared__ float dd_s[kStages][kBQ];
  uint8_t* smem = align1024(smem_raw);
  // K hi, K lo, V hi, V lo, then per stage: Q hi, Q lo, dO hi, dO lo,
  // Q^T, dO^T (hi and lo each)
  uint8_t* const k_hi = smem;
  uint8_t* const k_lo = k_hi + P::kKV;
  uint8_t* const v_hi = k_lo + P::kKV;
  uint8_t* const v_lo = v_hi + P::kKV;
  uint8_t* const ring = v_lo + P::kKV;
  auto q_hi = [&](int s) { return ring + s * P::kStage; };
  auto q_lo = [&](int s) { return ring + s * P::kStage + P::kQ; };
  auto do_hi = [&](int s) { return ring + s * P::kStage + 2 * P::kQ; };
  auto do_lo = [&](int s) { return ring + s * P::kStage + 3 * P::kQ; };
  auto q_t = [&](int s) { return ring + s * P::kStage + 4 * P::kQ; };
  auto do_t = [&](int s) {
    return ring + s * P::kStage + 4 * P::kQ + P::kT;
  };

  const int k0 = blockIdx.x * 64;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q_len = min(lens[2 * b], Tq);
  const int kv_len = min(lens[2 * b + 1], Tk);
  // query tiles j with j*BQ < q_len and (causal) j*BQ + BQ - 1 >= k0
  const int j_begin = causal ? k0 / kBQ : 0;
  int j_end = (q_len + kBQ - 1) / kBQ;
  if (k0 >= kv_len) j_end = 0;       // every column masked: dk = dv = 0
  const int n_it = max(0, j_end - j_begin);

  const int g = threadIdx.x / 128;   // kWG: the producer warp
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  if (threadIdx.x == 0) {
    mbar_init(&kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);   // expect-tx + the warp's row copies
      mbar_init(&empty[s], 4);       // one arrive a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (g == kWG) {                    // ---- producer warp
    if (n_it == 0) return;
    if (lane == 0) {
      tma_prefetch_map(&map_q);
      tma_prefetch_map(&map_do);
      mbar_expect_tx(&kv_full, 2 * P::kKV);
      for (int p = 0; p < NPF; ++p) {
        tma_load(k_hi + p * kRowTile, &map_k, &kv_full, p * kCols, h, k0, b);
        tma_load(v_hi + p * kRowTile, &map_v, &kv_full, p * kCols, h, k0, b);
      }
    }
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kStages;
      const int q0 = (j_begin + it) * kBQ;
      mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * P::kQ);
        for (int p = 0; p < NPF; ++p) {
          tma_load(q_hi(s) + p * kBQ * kRowBytes, &map_q, &full[s],
                   p * kCols, h, q0, b);
          tma_load(do_hi(s) + p * kBQ * kRowBytes, &map_do, &full[s],
                   p * kCols, h, q0, b);
        }
      }
      for (int r = lane; r < kBQ; r += 32) {
        const int qr = q0 + r;
        const bool in = qr < Tq;
        lse_s[s][r] = in ? lse[(size_t)bh * Tq + qr] * kLog2e : 0.f;
        dd_s[s][r] = in ? dd[(size_t)bh * Tq + qr] : 0.f;
      }
      mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumer warpgroup g: key rows k0 .. k0 + 63, all of d, query
  // tiles g, g + kWG, ...
  const int key0 = k0 + 16 * warp + lane / 4;   // and key0 + 8
  const float scale_log2 = scale * kLog2e;

  float acc_v[kNP][32], acc_k[kNP][32];
#pragma unroll
  for (int p = 0; p < kNP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_v[p][i] = acc_k[p][i] = 0.f;

  if (n_it > 0) {
    mbar_wait(&kv_full, 0);
    split_tile<64, NPF>(k_hi, k_hi, k_lo, threadIdx.x, 128 * kWG);
    split_tile<64, NPF>(v_hi, v_hi, v_lo, threadIdx.x, 128 * kWG);
    fence_proxy_async_shared();
    group_sync(1 + kWG, 128 * kWG);
  }
  for (int it = g; it < n_it; it += kWG) {
    const int s = it % kStages;
    const int q0 = (j_begin + it) * kBQ;
    mbar_wait(&full[s], (it / kStages) & 1);
    transpose_tile<kBQ, NPF>(q_hi(s), q_t(s), P::kTP, t, 128);
    transpose_tile<kBQ, NPF>(do_hi(s), do_t(s), P::kTP, t, 128);
    group_sync(1 + g, 128);          // the copies read Q, dO before the split
    split_tile<kBQ, NPF>(q_hi(s), q_hi(s), q_lo(s), t, 128);
    split_tile<kBQ, NPF>(do_hi(s), do_hi(s), do_lo(s), t, 128);
    fence_proxy_async_shared();      // the split, before wgmma reads it
    group_sync(1 + g, 128);

    // dP^T cancels against D in dS^T, and a dK entry sums dS^T over
    // every query row: its large passes go to kAccP accumulators (one a
    // panel of d, each rounding at its partial sum), added in float32
    // below; the small passes of both products go first
    float st[kBQ / 2], dpt[kAccP][kBQ / 2];
#pragma unroll
    for (int i = 0; i < kBQ / 2; ++i) st[i] = 0.f;
#pragma unroll
    for (int a = 0; a < kAccP; ++a)
#pragma unroll
      for (int i = 0; i < kBQ / 2; ++i) dpt[a][i] = 0.f;
    fence_regs(st);
#pragma unroll
    for (int a = 0; a < kAccP; ++a) fence_regs(dpt[a]);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < NPF; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma_small_ss(st, desc_k(k_hi + p * kRowTile, kk),
                     desc_k(k_lo + p * kRowTile, kk),
                     desc_k(q_hi(s) + p * kBQ * kRowBytes, kk),
                     desc_k(q_lo(s) + p * kBQ * kRowBytes, kk));
        mma_small_ss(dpt[0], desc_k(v_hi + p * kRowTile, kk),
                     desc_k(v_lo + p * kRowTile, kk),
                     desc_k(do_hi(s) + p * kBQ * kRowBytes, kk),
                     desc_k(do_lo(s) + p * kBQ * kRowBytes, kk));
      }
#pragma unroll
    for (int p = 0; p < NPF; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss(st, desc_k(k_hi + p * kRowTile, kk),
                 desc_k(q_hi(s) + p * kBQ * kRowBytes, kk));
        wgmma_ss(dpt[p * kAccP / NPF], desc_k(v_hi + p * kRowTile, kk),
                 desc_k(do_hi(s) + p * kBQ * kRowBytes, kk));
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
#pragma unroll
    for (int a = 0; a < kAccP; ++a) fence_regs(dpt[a]);
#pragma unroll
    for (int a = 1; a < kAccP; ++a)
#pragma unroll
      for (int i = 0; i < kBQ / 2; ++i) dpt[0][i] += dpt[a][i];

    // P^T and dS^T on the fragments: row = key, column = query. dV's
    // products run before dS^T is split: with both split at once a
    // consumer beside another (168 registers a thread: 9 warps put 3 on
    // an SM quarter) spilled.
    const bool interior = (q0 + kBQ <= q_len) && (k0 + 64 <= kv_len) &&
                          (!causal || k0 + 63 <= q0);
#pragma unroll
    for (int i = 0; i < kBQ / 2; ++i) {
      const int qc = frag_col(i, lane);
      const int key = key0 + 8 * ((i >> 1) & 1);
      const int qrow = q0 + qc;
      const bool valid = interior || (qrow < q_len && key < kv_len &&
                                      (!causal || key <= qrow));
      const float p = valid ? exp2f(st[i] * scale_log2 - lse_s[s][qc]) : 0.f;
      st[i] = p;
      dpt[0][i] = p * (dpt[0][i] - dd_s[s][qc]) * scale;
    }
    {
      uint32_t ph[kBQ / 2], pl[kBQ / 2];
      split_a(st, ph, pl);
      fence_regs(ph);
      fence_regs(pl);
#pragma unroll
      for (int p = 0; p < kNP; ++p) fence_regs(acc_v[p]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 8; ++kk)
#pragma unroll
        for (int p = 0; p < kNP; ++p)
          mma_small_rs(acc_v[p], &ph[4 * kk], &pl[4 * kk],
                       desc_k(tr_part<kBQ>(do_t(s), P::kTP, 0, p), kk),
                       desc_k(tr_part<kBQ>(do_t(s), P::kTP, 1, p), kk));
#pragma unroll
      for (int kk = 0; kk < kBQ / 8; ++kk)
#pragma unroll
        for (int p = 0; p < kNP; ++p)
          wgmma_rs(acc_v[p], &ph[4 * kk],
                   desc_k(tr_part<kBQ>(do_t(s), P::kTP, 0, p), kk));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < kNP; ++p) fence_regs(acc_v[p]);
    }
    {
      uint32_t sh[kBQ / 2], sl[kBQ / 2];
      split_a(dpt[0], sh, sl);
      fence_regs(sh);
      fence_regs(sl);
#pragma unroll
      for (int p = 0; p < kNP; ++p) fence_regs(acc_k[p]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 8; ++kk)
#pragma unroll
        for (int p = 0; p < kNP; ++p)
          mma_small_rs(acc_k[p], &sh[4 * kk], &sl[4 * kk],
                       desc_k(tr_part<kBQ>(q_t(s), P::kTP, 0, p), kk),
                       desc_k(tr_part<kBQ>(q_t(s), P::kTP, 1, p), kk));
#pragma unroll
      for (int kk = 0; kk < kBQ / 8; ++kk)
#pragma unroll
        for (int p = 0; p < kNP; ++p)
          wgmma_rs(acc_k[p], &sh[4 * kk],
                   desc_k(tr_part<kBQ>(q_t(s), P::kTP, 0, p), kk));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < kNP; ++p) fence_regs(acc_k[p]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // two warpgroups: each hands the other the sum it does not store,
  // through its own stage (no tile is loaded into it any more)
  bool store_k = true, store_v = true;
  if constexpr (kWG == 2) {
    float* mine = reinterpret_cast<float*>(ring + g * P::kStage);
    const float* other =
        reinterpret_cast<const float*>(ring + (1 - g) * P::kStage);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mine[i * 128 + t] = g == 0 ? acc_k[0][i] : acc_v[0][i];
    group_sync(1 + kWG, 128 * kWG);
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_v[0][i] += other[i * 128 + t];
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_k[0][i] += other[i * 128 + t];
    }
    store_k = g == 1;
    store_v = g == 0;
  }

  const size_t rs = (size_t)H * D;   // elements between rows of a head
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = key0 + 8 * hh;
    if (key >= Tk) continue;
    const size_t off = ((size_t)b * Tk + key) * rs + (size_t)h * D;
#pragma unroll
    for (int p = 0; p < kNP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = p * 64 + 8 * j + 2 * (lane % 4);
        if (col >= D) continue;
        if (store_k)
          *reinterpret_cast<float2*>(dk + off + col) = make_float2(
              acc_k[p][4 * j + 2 * hh], acc_k[p][4 * j + 2 * hh + 1]);
        if (store_v)
          *reinterpret_cast<float2*>(dv + off + col) = make_float2(
              acc_v[p][4 * j + 2 * hh], acc_v[p][4 * j + 2 * hh + 1]);
      }
  }
}

template <int NPF>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* dd,
                   const int* lens, void* dk, void* dv, int B, int H, int Tq,
                   int Tk, int D, float scale, int causal,
                   cudaStream_t stream) {
  using P = Plan<NPF>;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_bthd_map_f32(&mq, q, B, Tq, H, D, P::kBQ) ||
      !make_bthd_map_f32(&mk, k, B, Tk, H, D, 64) ||
      !make_bthd_map_f32(&mv, v, B, Tk, H, D, 64) ||
      !make_bthd_map_f32(&mdo, dout, B, Tq, H, D, P::kBQ))
    return cudaErrorInvalidValue;
  static size_t configured = 0;
  cudaError_t e = set_smem((const void*)flash_dkv_tf32_kernel<NPF>,
                           P::kSmem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((Tk + 63) / 64, B * H);
  (void)cudaGetLastError();          // report this launch's error only
  flash_dkv_tf32_kernel<NPF>
      <<<grid, 128 * P::kWG + 32, P::kSmem, stream>>>(
      mq, mk, mv, mdo, lse, dd, lens, static_cast<float*>(dk),
      static_cast<float*>(dv), H, Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

template <int NPF>
int fill_plan(int* plan) {
  using P = Plan<NPF>;
  cudaFuncAttributes attr;
  const cudaError_t e =
      cudaFuncGetAttributes(&attr, (const void*)flash_dkv_tf32_kernel<NPF>);
  if (e != cudaSuccess) return (int)e;
  const int out[6] = {P::kWG,     64,            P::kBQ,
                      P::kStages, (int)P::kSmem, (int)attr.sharedSizeBytes};
  for (int i = 0; i < 6; ++i) plan[i] = out[i];
  return 0;
}

}  // namespace

// dtype must be 0 (float32): bfloat16 takes flash_dkv_sm90.cu. Returns
// cudaGetLastError() after the launch (0 on success); the wrapper
// raises on anything else.
extern "C" int pt_flash_dkv_tf32_sm90(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* dd,
                                      const void* lens, void* dk, void* dv,
                                      int B, int H, int Tq, int Tk, int D,
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
      return (int)launch<1>(q, k, v, dout, ls, dl, ln, dk, dv, B, H, Tq, Tk,
                            D, scale, causal, st);
    case 2:
      return (int)launch<2>(q, k, v, dout, ls, dl, ln, dk, dv, B, H, Tq, Tk,
                            D, scale, causal, st);
    case 3:
      return (int)launch<3>(q, k, v, dout, ls, dl, ln, dk, dv, B, H, Tq, Tk,
                            D, scale, causal, st);
    default:
      return (int)launch<4>(q, k, v, dout, ls, dl, ln, dk, dv, B, H, Tq, Tk,
                            D, scale, causal, st);
  }
}

// The launch's plan at head dim D: plan[0..5] = consumer warpgroups,
// key rows a block, queries a tile, stages, dynamic and static shared
// bytes (ops/flash_attention.py flash_tf32_plan("dkv", D) must agree).
extern "C" int pt_flash_dkv_tf32_plan(int D, int* plan) {
  if (D <= 0 || D % 8 != 0 || D > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  switch ((D + kCols - 1) / kCols) {
    case 1: return fill_plan<1>(plan);
    case 2: return fill_plan<2>(plan);
    case 3: return fill_plan<3>(plan);
    default: return fill_plan<4>(plan);
  }
}

// Flash-attention dk/dv for Hopper's tensor cores (sm_90a), bfloat16.
//
// Replaces: paddle_tpu/ops/pallas_attention.py:_flash_bwd_dkv_kernel
// (launched by _flash_grads) for bf16 operands; float32 takes the
// 3xTF32 kernel of flash_dkv_tf32_sm90.cu. The bf16 dq is
// flash_dq_sm90.cu. Same function: p is recomputed from the saved
// natural-units lse as exp2(s*scale*log2e - lse*log2e) under the full
// (q_len, kv_len, causal) mask, the mask applied BEFORE the exponent (a
// fully-masked row's lse is NEG_INF), then with D = rowsum(dO*O)
//   dV = sum_q P^T dO,   dK = sum_q dS^T Q,   dS = P (dP - D) scale,
// accumulated in float32 and written in bf16. P^T and dS^T are rounded
// to bf16 before their products, where the TPU kernel rounds them
// (p.astype(do.dtype), ds.astype(q.dtype)).
//
// What bounds it on an H100: at the transformer's shapes (b 8, h 8,
// T 1024, d 64, causal) four products of 2*d flops a valid pair, 17.2
// GFLOP (17.4 us at the bf16 tensor cores' 989 TFLOP/s) against ~50 MB
// of q/k/v/dO/dk/dv plus lse and D (15 us at 3.35 TB/s).
//
// Design: one block owns 64 key rows of one (b*h), with one producer
// warp and, per 64-column panel of d, one consumer warpgroup.
//   - The producer's elected lane loads K and V once by TMA (4-D map over
//     [b, T, h, d], 128-byte swizzle), then walks the query tiles j with
//     j*64 < q_len and, under causal, j*64 + 63 >= k0, loading Q and dO
//     into a 2-stage ring guarded by full/empty mbarriers; its 32 lanes
//     copy the tile's 64 entries of lse*log2e and D into the stage and
//     arrive on the same full barrier (1 + 32 arrivals a phase).
//   - Per query tile, on wgmma with f32 accumulators:
//       S^T  = K Q^T     SS, both K-major;
//       dP^T = V dO^T    SS, both K-major;
//       dV  += P^T dO    RS: A = P^T packed to bf16 from the S^T
//                        accumulator, B = dO MN-major (transposed);
//       dK  += dS^T Q    RS: A = dS^T in bf16 registers, B = Q MN-major.
//     Each swizzled Q and dO tile is read K-major by the first two and
//     MN-major by the last two: two descriptors over one buffer, no
//     second copy. P and dS never touch shared memory. Only tiles that
//     straddle q_len, kv_len or the diagonal compute the mask.
//   - A key tile wholly past kv_len writes zeros. No sum crosses blocks,
//     so there are no atomics.
// Each tile is a serial chain per warpgroup (two products, the
// elementwise P and dS, two products), hidden only by the other block
// on the SM: a deeper ring or copying lse and D asynchronously changes
// nothing, and issuing dV's product before computing dS makes ptxas
// serialize the products. Larger key tiles and cross-warpgroup overlap
// are the next step.
// Register budget: S^T, dP^T, dV and dK are four 64 x 64 f32
// accumulators, 128 registers a thread. A head dim above 64 would double
// dV and dK, so it takes a second consumer warpgroup instead: both
// recompute S^T and dP^T (over all of d), and warpgroup g keeps dV and
// dK of columns 64g .. 64g + 63 only. Every thread holds the same four
// accumulators at every head dim; no spills.
//
// Build: see flash_fwd_sm90.cu.

#include "flash_common.cuh"
#include "sm90_pipeline.cuh"

namespace {

using namespace flash;
using namespace sm90;

constexpr int kStages = 2;

template <int NP>
__global__ void __launch_bounds__(128 * NP + 32, 1) flash_dkv_sm90_kernel(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_do,
    const float* __restrict__ lse, const float* __restrict__ dd,
    const int* __restrict__ lens, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int H, int Tq, int Tk, int D,
    float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full;
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ float lse_s[kStages][kRows];   // lse * log2(e)
  __shared__ float dd_s[kStages][kRows];
  uint8_t* smem = align1024(smem_raw);
  // K panels, V panels, then per stage Q panels and dO panels
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + NP * kTileBytes;
  auto q_tile = [&](int s, int p) {
    return smem + (2 * NP + s * 2 * NP + p) * kTileBytes;
  };
  auto do_tile = [&](int s, int p) {
    return smem + (2 * NP + s * 2 * NP + NP + p) * kTileBytes;
  };

  const int k0 = blockIdx.x * kRows;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q_len = min(lens[2 * b], Tq);
  const int kv_len = min(lens[2 * b + 1], Tk);
  // query tiles j with j*64 < q_len and (causal) j*64 + 63 >= k0
  const int j_begin = causal ? k0 / kRows : 0;
  int j_end = (q_len + kRows - 1) / kRows;
  if (k0 >= kv_len) j_end = 0;       // every column masked: dk = dv = 0
  const int n_it = max(0, j_end - j_begin);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(&kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);   // expect-tx + the warp's row copies
      mbar_init(&empty[s], 4 * NP);  // one arrive a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * NP) {              // ---- producer warp
    if (n_it > 0 && lane == 0) {
      tma_prefetch_map(&map_q);
      tma_prefetch_map(&map_do);
      mbar_expect_tx(&kv_full, 2 * NP * kTileBytes);
      for (int p = 0; p < NP; ++p) {
        tma_load(k_s + p * kTileBytes, &map_k, &kv_full, p * kPanel, h, k0,
                 b);
        tma_load(v_s + p * kTileBytes, &map_v, &kv_full, p * kPanel, h, k0,
                 b);
      }
    }
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kStages;
      const int q0 = (j_begin + it) * kRows;
      mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * NP * kTileBytes);
        for (int p = 0; p < NP; ++p) {
          tma_load(q_tile(s, p), &map_q, &full[s], p * kPanel, h, q0, b);
          tma_load(do_tile(s, p), &map_do, &full[s], p * kPanel, h, q0, b);
        }
      }
#pragma unroll
      for (int r = lane; r < kRows; r += 32) {
        const int qr = q0 + r;
        const bool in = qr < Tq;
        lse_s[s][r] = in ? lse[(size_t)bh * Tq + qr] * kLog2e : 0.f;
        dd_s[s][r] = in ? dd[(size_t)bh * Tq + qr] : 0.f;
      }
      mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumer warpgroup g: dV and dK columns 64g .. 64g + 63
  const int g = warp / 4;
  const int w = warp % 4;
  const int key0 = k0 + 16 * w + lane / 4;   // key rows key0 and key0 + 8
  const float scale_log2 = scale * kLog2e;

  float acc_v[32], acc_k[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_v[i] = acc_k[i] = 0.f;

  if (n_it > 0) mbar_wait(&kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    const int q0 = (j_begin + it) * kRows;
    mbar_wait(&full[s], (it / kStages) & 1);

    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk)
      wgmma_ss<0>(st, desc_k(k_s + (kk / 4) * kTileBytes, kk % 4),
                  desc_k(q_tile(s, kk / 4), kk % 4), 1);
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk)
      wgmma_ss<0>(dpt, desc_k(v_s + (kk / 4) * kTileBytes, kk % 4),
                   desc_k(do_tile(s, kk / 4), kk % 4), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T on the fragments: row = key, column = query
    const bool interior = (q0 + kRows <= q_len) && (k0 + kRows <= kv_len) &&
                          (!causal || k0 + kRows - 1 <= q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qc = frag_col(i, lane);
      const int key = key0 + 8 * ((i >> 1) & 1);
      const int qrow = q0 + qc;
      const bool valid = interior || (qrow < q_len && key < kv_len &&
                                      (!causal || key <= qrow));
      const float p = valid ? exp2f(st[i] * scale_log2 - lse_s[s][qc]) : 0.f;
      st[i] = p;
      dpt[i] = p * (dpt[i] - dd_s[s][qc]) * scale;
    }
    uint32_t pa[16], dsa[16];
    pack_a(st, pa);
    pack_a(dpt, dsa);

    fence_regs(pa);
    fence_regs(dsa);
    fence_regs(acc_v);
    fence_regs(acc_k);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(acc_v, &pa[4 * kk], desc_mn(do_tile(s, g), kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(acc_k, &dsa[4 * kk], desc_mn(q_tile(s, g), kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_v);
    fence_regs(acc_k);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const size_t rs = (size_t)H * D;   // elements between rows of a head
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = key0 + 8 * hh;
    if (key >= Tk) continue;
    const size_t off = ((size_t)b * Tk + key) * rs + (size_t)h * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = g * kPanel + 8 * j + 2 * (lane % 4);
      if (col < D) {
        *reinterpret_cast<uint32_t*>(dk + off + col) =
            pack_bf16(acc_k[4 * j + 2 * hh], acc_k[4 * j + 2 * hh + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + col) =
            pack_bf16(acc_v[4 * j + 2 * hh], acc_v[4 * j + 2 * hh + 1]);
      }
    }
  }
}

template <int NP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* dd,
                   const int* lens, void* dk, void* dv, int B, int H, int Tq,
                   int Tk, int D, float scale, int causal,
                   cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  if (!make_bthd_map(&mq, q, B, Tq, H, D) ||
      !make_bthd_map(&mk, k, B, Tk, H, D) ||
      !make_bthd_map(&mv, v, B, Tk, H, D) ||
      !make_bthd_map(&mdo, dout, B, Tq, H, D))
    return cudaErrorInvalidValue;
  const size_t smem = 1024 + (size_t)(2 * NP + 2 * kStages * NP) * kTileBytes;
  static size_t configured = 0;
  cudaError_t e =
      set_smem((const void*)flash_dkv_sm90_kernel<NP>, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((Tk + kRows - 1) / kRows, B * H);
  flash_dkv_sm90_kernel<NP><<<grid, 128 * NP + 32, smem, stream>>>(
      mq, mk, mv, mdo, lse, dd, lens, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype must be 1 (bfloat16): float32 takes flash_dkv_tf32_sm90.cu.
// Returns cudaGetLastError() after the launch (0 on success); the
// wrapper raises on anything else.
extern "C" int pt_flash_dkv_sm90(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* dd, const void* lens, void* dk,
                                 void* dv, int B, int H, int Tq, int Tk,
                                 int D, float scale, int causal, int dtype,
                                 void* stream) {
  if (!shapes_ok(B, H, Tq, Tk, D) || dtype != 1)
    return (int)cudaErrorInvalidValue;
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(dd);
  const int* ln = static_cast<const int*>(lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= kPanel)
    return (int)launch<1>(q, k, v, dout, ls, dl, ln, dk, dv, B, H, Tq, Tk, D,
                          scale, causal, st);
  return (int)launch<2>(q, k, v, dout, ls, dl, ln, dk, dv, B, H, Tq, Tk, D,
                        scale, causal, st);
}

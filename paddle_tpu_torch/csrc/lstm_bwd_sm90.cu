// Fused LSTM sequence backward for Hopper's tensor cores (sm_90a),
// bfloat16.
//
// Replaces: paddle_tpu/ops/pallas_rnn.py:_lstm_bwd_kernel (launched by
// _lstm_bwd) for bf16 weights; float32 takes lstm_bwd_bf16x3_sm90.cu.
// Same function as that file documents: in reverse time it
// carries (dh, dc) in float32, emits dz_t = [dzi, dzf, dzc, dzo] in bf16,
// and forms dh_{t-1} = dz_t W^T from dz_t as stored (rounded to bf16),
// the product accumulated in float32.
//
// What bounds it on an H100: dz W^T at B 128, H 1280 over 100 valid
// steps is 167.8 GFLOP (0.17 ms at the bf16 tensor cores' 989 TFLOP/s),
// the streams about 0.4 GB (0.12 ms at 3.35 TB/s). The plan below adds a
// cost the bound does not count: every step, every block reads all of
// dz_t ([128, 5120] bf16, 1.31 MB) from L2 — 105 MB a step over 80
// blocks — plus one grid barrier a step.
//
// Design: the persistent, weight-stationary plan of rnn_common.cuh
// with the per-step product on wgmma:
//   - One cooperative launch; block x owns kUnits = 16 hidden units
//     [16x, 16x + 16) (80 blocks at H 1280) and keeps their weight rows
//     W[j, :] resident in shared memory as bf16: [16, 4H] (160 KB at H
//     1280), stored as 64-column K-major tiles with the 128-byte swizzle
//     (written once by the block's threads, then a proxy fence), the B
//     operand of an m64n16k16 product.
//   - (a) Each step the block computes dz_t of its units from its own
//     dh/dc carries (the gate math of that file), and writes it into the
//     dz output and into one of the two planes of a scratch [2, B, 4H] (row
//     pitch rounded to 16 bytes, which the TMA needs and dz's own rows
//     lack for odd H); (b) it meets the other blocks at the grid barrier;
//     (c) one producer warp streams dz_t, in 64-column chunks of 64 batch
//     rows, from the scratch by TMA (128-byte swizzle, rows past B and
//     columns past 4H zero-filled) into a ring of full/empty mbarrier
//     stages, and two consumer warpgroups (64 batch rows each: batch
//     tiles of 128) accumulate dh_{t-1}[rows, units] = dz_t W_units^T on
//     wgmma m64n16k16, both operands K-major (the layout of S = Q K^T),
//     one commit group in flight while the next chunk's wait runs.
//   - The scratch's two planes alternate by step parity, so one barrier a
//     step suffices: a plane is rewritten two steps later, after every
//     block has passed the barrier that ends its reads.
//   - Cross-proxy order: dz_t is written with generic stores by other
//     blocks and read by the TMA (the async proxy). Writers fence
//     (fence.proxy.async.global) before the barrier's release; the
//     producer fences again after its acquire, before the first load.
// The carries never leave their owner; steps past the
// longest row are not run. `mode` 1 runs the steps with no product
// (dz math and the barrier) and mode 2 the barriers alone: the
// per-step floors of this plan (timed by chip_smoke.py; their results
// are not the function).
//
// Build: as lstm_bwd_bf16x3_sm90.cu.

#include "rnn_common.cuh"
#include "sm90_pipeline.cuh"

namespace {

using namespace rnn;

constexpr int kUnits = 16;                 // hidden units a block: wgmma N
constexpr int kChunk = 64;                 // columns of 4H a chunk
constexpr int kZRows = 64;                 // batch rows a TMA box
constexpr int kConsumers = 2;              // warpgroups: 128 batch rows
constexpr int kBatchTile = kZRows * kConsumers;
constexpr int kThreadsSm90 = 128 * kConsumers + 32;
constexpr uint32_t kWTileBytes = kUnits * kChunk * 2;     // 2048
constexpr uint32_t kZTileBytes = kZRows * kChunk * 2;     // 8192
constexpr int kMaxStages = 8;
// static shared memory of the kernel (barriers, steps_to_run), rounded up
constexpr size_t kStaticReserve = 1024;

__host__ __device__ inline int n_chunks(int H) {
  return (4 * H + kChunk - 1) / kChunk;
}

// Ring stages that fit beside the resident weights (rnn_common.cuh
// ring_stages_fit)
__host__ __device__ inline int ring_stages(int H, int cap) {
  return ring_stages_fit((long long)kStaticReserve + 1024 +
                             (long long)n_chunks(H) * kWTileBytes,
                         (long long)kConsumers * kZTileBytes, kMaxStages, cap);
}

__host__ __device__ inline size_t dyn_smem(int H, int stages) {
  return 1024 + (size_t)n_chunks(H) * kWTileBytes +
         (size_t)stages * kConsumers * kZTileBytes;
}

// byte offset of element (n, kc) (unit row n < 16, column kc < 64) in a
// [16, 64] bf16 K-major tile with the 128-byte swizzle: 8-row atoms of
// 1024 bytes, the 16-byte chunk c of row r at chunk c ^ (r % 8)
__device__ __forceinline__ uint32_t wtile_off(int n, int kc) {
  const int r = n & 7;
  return (n >> 3) * 1024 + r * 128 + ((((kc >> 3) ^ r) & 7) << 4) +
         (kc & 7) * 2;
}

// rows j0 .. j0 + uu - 1 of w [*, K4] (row pitch K4) as K-major tiles of
// 64 columns; rows past uu and columns past K4 are zero. Generic stores:
// the caller fences the async proxy before a wgmma reads them.
__device__ void load_w_tiles(uint8_t* ws, const __nv_bfloat16* w, int K4,
                             int j0, int uu, int nchunk) {
  const unsigned short* wu = reinterpret_cast<const unsigned short*>(w);
  const int total = nchunk * kUnits * 8;     // 16-byte groups
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int g8 = idx & 7;
    const int n = (idx >> 3) % kUnits;
    const int c = idx / (8 * kUnits);
    const int k = c * kChunk + g8 * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n < uu && k < K4) {
      const size_t at = (size_t)(j0 + n) * K4 + k;
      if (k + 8 <= K4 && at % 8 == 0) {
        v = *reinterpret_cast<const uint4*>(wu + at);
      } else {
        uint32_t e[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) e[i] = k + i < K4 ? wu[at + i] : 0u;
        v = make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16),
                       e[4] | (e[5] << 16), e[6] | (e[7] << 16));
      }
    }
    *reinterpret_cast<uint4*>(ws + c * kWTileBytes + wtile_off(n, g8 * 8)) =
        v;
  }
}

// acc (+)= the [64, 16] product of one 64-column chunk: A = a [64 rows,
// 64 cols] swizzled by the TMA, B = the chunk's weight tile
__device__ __forceinline__ void chunk_product(float (&acc)[8],
                                              const uint8_t* a,
                                              const uint8_t* wt) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::wgmma_ss_n16(acc, sm90::desc_k(a, kk), sm90::desc_k(wt, kk), 1);
}

__global__ void __launch_bounds__(kThreadsSm90, 1) lstm_bwd_sm90_kernel(
    const __grid_constant__ CUtensorMap map_z,
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ peep,
    const int* __restrict__ lens, const __nv_bfloat16* __restrict__ gates,
    const __nv_bfloat16* __restrict__ cseq,
    const __nv_bfloat16* __restrict__ dhseq, const float* __restrict__ dhT,
    const float* __restrict__ dcT, __nv_bfloat16* dz, __nv_bfloat16* zt,
    float* __restrict__ dh, float* __restrict__ dc, unsigned int* bar, int B,
    int Tn, int H, int pitch, int mode, int stages) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  uint8_t* smem = sm90::align1024(smem_raw);
  const int K4 = 4 * H;
  const int nchunk = n_chunks(H);
  uint8_t* ws = smem;
  uint8_t* ring = smem + (size_t)nchunk * kWTileBytes;
  auto z_tile = [&](int s, int g) {
    return ring + (s * kConsumers + g) * kZTileBytes;
  };

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int j0 = blockIdx.x * kUnits;
  const int uu = min(kUnits, H - j0);
  const size_t H4 = (size_t)K4;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4 * kConsumers);   // one arrive a warp
    }
    sm90::mbar_fence_init();
  }
  load_w_tiles(ws, w, K4, j0, uu, nchunk);
  sm90::fence_proxy_async_shared();
  const int t_end = steps_to_run(lens, B, Tn);      // syncs the block
  const __nv_bfloat16 zero = from_f<__nv_bfloat16>(0.f);
  for (int p = tid; p < B * uu; p += blockDim.x) {
    const int r = p / uu;
    const int j = j0 + (p - r * uu);
    const size_t s = (size_t)r * H + j;
    dh[s] = dhT[s];
    dc[s] = dcT[s];
    for (int t = t_end; t < Tn; ++t) {
      __nv_bfloat16* dr = dz + ((size_t)r * Tn + t) * H4;
      for (int g = 0; g < 4; ++g) dr[g * H + j] = zero;
    }
  }
  __syncthreads();

  const int n_bt = (B + kBatchTile - 1) / kBatchTile;
  uint32_t it = 0;           // ring position: the same walk on both sides
  unsigned int epoch = 0;
  for (int t = t_end - 1; t >= 0; --t) {
    const int plane = t & 1;
    if (mode != 2) {
      // (a) dz_t of the owned units, into dz and the scratch plane
      for (int p = tid; p < B * uu; p += blockDim.x) {
        const int r = p / uu;
        const int j = j0 + (p - r * uu);
        const size_t s = (size_t)r * H + j;
        const size_t row = (size_t)r * Tn + t;
        const bool valid = t < lens[r];
        const __nv_bfloat16* g4 = gates + row * H4;
        const float ig = to_f(g4[j]);
        const float fg = to_f(g4[H + j]);
        const float cand = to_f(g4[2 * H + j]);
        const float og = to_f(g4[3 * H + j]);
        const float ct = to_f(cseq[row * H + j]);
        const float cp = t > 0 ? to_f(cseq[(row - 1) * H + j]) : 0.f;
        const float dht = dh[s] + (valid ? to_f(dhseq[row * H + j]) : 0.f);
        const float tc = tanhf(ct);
        const float dov = dht * tc;
        const float dzo = dov * og * (1.f - og);
        const float dct =
            dc[s] + dht * og * (1.f - tc * tc) + dzo * peep[2 * H + j];
        const float di = dct * cand;
        const float dzi = di * ig * (1.f - ig);
        const float df = dct * cp;
        const float dzf = df * fg * (1.f - fg);
        const float dg = dct * ig;
        const float dzc = dg * (1.f - cand * cand);
        const __nv_bfloat16 z4[4] = {
            from_f<__nv_bfloat16>(valid ? dzi : 0.f),
            from_f<__nv_bfloat16>(valid ? dzf : 0.f),
            from_f<__nv_bfloat16>(valid ? dzc : 0.f),
            from_f<__nv_bfloat16>(valid ? dzo : 0.f)};
        __nv_bfloat16* dr = dz + row * H4;
        __nv_bfloat16* zr = zt + ((size_t)plane * B + r) * pitch;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          dr[g * H + j] = z4[g];
          zr[g * H + j] = z4[g];
        }
        if (valid) dc[s] = dct * fg + dzi * peep[j] + dzf * peep[H + j];
      }
      sm90::fence_proxy_async_global();
    }
    grid_sync(bar, ++epoch);
    if (mode == 0) {
      if (warp == 4 * kConsumers) {    // ---- producer warp
        if (lane == 0) {
          sm90::fence_proxy_async_global();
          for (int bt = 0; bt < n_bt; ++bt) {
            const int r0 = bt * kBatchTile;
            const int tiles = r0 + kZRows < B ? 2 : 1;
            for (int c = 0; c < nchunk; ++c, ++it) {
              const int s = it % stages;
              sm90::mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
              sm90::mbar_expect_tx(&full[s], tiles * kZTileBytes);
              for (int g = 0; g < tiles; ++g)
                sm90::tma_load_3d(z_tile(s, g), &map_z, &full[s],
                                  c * kChunk, r0 + kZRows * g, plane);
            }
          }
        }
        __syncwarp();
      } else {                         // ---- consumer warpgroup g
        const int g = warp / 4;
        const int w4 = warp % 4;
        for (int bt = 0; bt < n_bt; ++bt) {
          const int rbase = bt * kBatchTile + kZRows * g;
          const bool active = rbase < B;
          float acc[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] = 0.f;
          sm90::fence_regs(acc);
          int prev = 0;
          // every warpgroup multiplies, the one with no rows too (on a
          // tile it was not sent, its result unused): a wgmma on a
          // divergent path makes ptxas serialize them all (C7518)
          for (int c = 0; c < nchunk; ++c, ++it) {
            const int s = it % stages;
            sm90::mbar_wait(&full[s], (it / stages) & 1);
            sm90::wgmma_fence();
            chunk_product(acc, z_tile(s, g), ws + c * kWTileBytes);
            sm90::wgmma_commit();
            sm90::wgmma_wait<1>();       // the previous chunk is done
            if (c > 0) {
              __syncwarp();
              if (lane == 0) sm90::mbar_arrive(&empty[prev]);
            }
            prev = s;
          }
          sm90::wgmma_wait<0>();
          sm90::fence_regs(acc);
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(&empty[prev]);
          // dh_{t-1} of the owned units: row = batch, column = unit
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = rbase + sm90::frag_row(i, w4, lane);
            const int col = sm90::frag_col(i, lane);
            if (active && r < B && col < uu && t < lens[r])
              dh[(size_t)r * H + j0 + col] = acc[i];
          }
        }
      }
    }
    __syncthreads();                   // dh is read by other threads in (a)
  }
}

// ---- a check of the building blocks on one [64, K] x [16, K]^T product:
// A loaded by TMA through the scratch's map (one plane, chunks of 64
// columns, the tail zero-filled), W through load_w_tiles, the chunks on
// wgmma m64n16k16 with one commit group in flight, as the kernel runs
__global__ void __launch_bounds__(128) lstm_sm90_product_check_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __nv_bfloat16* __restrict__ w, float* __restrict__ c, int K) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full;
  uint8_t* smem = sm90::align1024(smem_raw);
  const int nchunk = (K + kChunk - 1) / kChunk;
  uint8_t* ws = smem;
  uint8_t* as = smem + nchunk * kWTileBytes;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&full, 1);
    sm90::mbar_fence_init();
  }
  load_w_tiles(ws, w, K, 0, kUnits, nchunk);
  sm90::fence_proxy_async_shared();
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_expect_tx(&full, nchunk * kZTileBytes);
    for (int ch = 0; ch < nchunk; ++ch)
      sm90::tma_load_3d(as + ch * kZTileBytes, &map_a, &full, ch * kChunk,
                        0, 0);
  }
  sm90::mbar_wait(&full, 0);
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  sm90::fence_regs(acc);
  for (int ch = 0; ch < nchunk; ++ch) {
    sm90::wgmma_fence();
    chunk_product(acc, as + ch * kZTileBytes, ws + ch * kWTileBytes);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  const int w4 = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    c[sm90::frag_row(i, w4, lane) * kUnits + sm90::frag_col(i, lane)] =
        acc[i];
}

}  // namespace

// w [H, 4H], gates [B, T, 4H], cseq and dhseq [B, T, H] and dz [B, T, 4H]
// bf16; zt the bf16 scratch [2, B, pitch] with pitch = 4H rounded up to
// 8; peep [3H], dhT, dcT and the scratch carries dh, dc [B, H] float32;
// lens [B] int32; bar one zeroed uint32. `mode` 0 computes the function;
// 1 and 2 are the floors of the file note. `stages` caps the ring's
// depth (0: as many as fit; the ring depth changes no result). Returns
// the CUDA error of the launch (0 on success); the wrapper raises on
// anything else.
extern "C" int pt_lstm_bwd_sm90(const void* w, const void* peep,
                                const void* lens, const void* gates,
                                const void* cseq, const void* dhseq,
                                const void* dhT, const void* dcT, void* dz,
                                void* zt, void* dh, void* dc, void* bar,
                                int B, int Tn, int H, int mode, int stages,
                                void* stream) {
  if (B <= 0 || Tn <= 0 || H <= 0 || mode < 0 || mode > 2 || stages < 0)
    return (int)cudaErrorInvalidValue;
  stages = ring_stages(H, stages);
  if (stages == 0) return (int)cudaErrorInvalidValue;
  int pitch = (4 * H + 7) / 8 * 8;
  CUtensorMap mz;
  if (!sm90::make_rows_map(&mz, zt, 4 * H, B, 2, pitch))
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* w_ = static_cast<const __nv_bfloat16*>(w);
  const float* peep_ = static_cast<const float*>(peep);
  const int* lens_ = static_cast<const int*>(lens);
  const __nv_bfloat16* gates_ = static_cast<const __nv_bfloat16*>(gates);
  const __nv_bfloat16* cseq_ = static_cast<const __nv_bfloat16*>(cseq);
  const __nv_bfloat16* dhseq_ = static_cast<const __nv_bfloat16*>(dhseq);
  const float* dhT_ = static_cast<const float*>(dhT);
  const float* dcT_ = static_cast<const float*>(dcT);
  __nv_bfloat16* dz_ = static_cast<__nv_bfloat16*>(dz);
  __nv_bfloat16* zt_ = static_cast<__nv_bfloat16*>(zt);
  float* dh_ = static_cast<float*>(dh);
  float* dc_ = static_cast<float*>(dc);
  unsigned int* bar_ = static_cast<unsigned int*>(bar);
  void* args[] = {&mz,    &w_,   &peep_, &lens_, &gates_, &cseq_, &dhseq_,
                  &dhT_,  &dcT_, &dz_,   &zt_,   &dh_,    &dc_,   &bar_,
                  &B,     &Tn,   &H,     &pitch, &mode,  &stages};
  static size_t configured = 0;
  return (int)coop_launch((const void*)lstm_bwd_sm90_kernel,
                          (H + kUnits - 1) / kUnits, dyn_smem(H, stages),
                          configured,
                          args, static_cast<cudaStream_t>(stream),
                          kThreadsSm90);
}

// a [64, K] and w [16, K] bf16 row-major (K % 8 == 0, K <= 256); c
// [64, 16] float32 = a w^T
extern "C" int pt_lstm_sm90_product_check(const void* a, const void* w,
                                          void* c, int K, void* stream) {
  if (K <= 0 || K % 8 != 0 || K > 256) return (int)cudaErrorInvalidValue;
  CUtensorMap ma;
  if (!sm90::make_rows_map(&ma, a, K, kZRows, 1, K))
    return (int)cudaErrorInvalidValue;
  const int nchunk = (K + kChunk - 1) / kChunk;
  const size_t smem = 1024 + (size_t)nchunk * (kWTileBytes + kZTileBytes);
  lstm_sm90_product_check_kernel<<<1, 128, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      ma, static_cast<const __nv_bfloat16*>(w), static_cast<float*>(c), K);
  return (int)cudaGetLastError();
}

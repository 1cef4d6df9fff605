// Fused LSTM sequence forward for Hopper's tensor cores (sm_90a),
// bfloat16.
//
// Replaces: paddle_tpu/ops/pallas_rnn.py:_lstm_kernel (launched by
// _lstm_fwd_call, public lstm_sequence) for bf16 weights; float32 takes
// lstm_fwd_bf16x3_sm90.cu. Same function as that file documents, with
// the rounding points of the TPU kernel in bf16: for each step t
//   z = x4[:, t] + round_bf16(h_{t-1}) @ W + bias    (gates [i, f, c~, o])
// with the product accumulated in float32, the gate math, the carries,
// hT, cT, bias and peepholes in float32; invalid steps (t >= lens[r])
// freeze h and c and write 0 to out; with residuals (the training call)
// also the frozen c sequence and the activated gates, in bf16.
//
// What bounds it on an H100: at B 128, H 1280 and 100 valid steps the
// products are 2*B*H*4H*100 = 167.8 GFLOP (0.17 ms at the bf16 tensor
// cores' 989 TFLOP/s) against about 0.43 GB of streams (0.13 ms at 3.35
// TB/s): operation-bound. The plan below adds what the bound does not
// count: every step every block reads all of round(h_{t-1}) ([128, 1280]
// bf16, 327 KB) from L2 — 26 MB a step over 80 blocks — and one grid
// barrier a step.
//
// Design: the persistent, weight-stationary plan of lstm_bwd_sm90.cu,
// turned around:
//   - One cooperative launch; block x owns kUnits = 16 hidden units
//     [16x, 16x + 16) (80 blocks at H 1280) and keeps their 64 weight
//     columns W[:, g*H + j] (4 gates x 16 units) resident in shared
//     memory as bf16, ordered gate-major (column n = 16 g + u) and
//     stored as K-major [64 n x 64 k] tiles in the 128-byte swizzle (160
//     KB at H 1280; written once by the block's threads, then a proxy
//     fence): the B operand of an m64n64k16 product.
//   - Gate-major columns put, by the accumulator's fragment map
//     (sm90_pipeline.cuh), all four gates of units 2q, 2q+1, 2q+8, 2q+9
//     (q = lane % 4) of two batch rows in one thread: the gate math runs
//     in registers with no exchange, and the c and h carries of those
//     (row, unit) pairs stay in that thread's registers for the whole
//     sequence (in hT / cT, owner-only, when B > 128 takes several batch
//     tiles).
//   - Each step one producer warp streams round(h_{t-1}) by TMA from one
//     of the two planes of a scratch [2, B, H rounded to 8] (16-byte row
//     pitch for the TMA; columns past H and rows past B zero-filled), in
//     64-column chunks of 64 batch rows, into a ring of full/empty
//     mbarrier stages; two consumer warpgroups (64 batch rows each: batch
//     tiles of 128) accumulate z[rows, 64 columns] on wgmma m64n64k16,
//     both operands K-major, one commit group in flight while the next
//     chunk's wait runs. Each thread's x4 values (and its rows' lengths)
//     of a step are in its registers before the step's product, so their
//     latency hides (x4 does not depend on the recurrence).
//   - End of a step: each thread writes round(h_keep) (the frozen h for
//     an invalid step: the next product reads it) into the other plane,
//     fences fence.proxy.async.global and the block arrives at the grid
//     barrier (rnn_common.cuh grid_arrive); only then does it store out,
//     cseq and gates (no block reads them) and load the next step's x4,
//     and then waits for the others (grid_wait). The producer fences
//     again after the wait, before its first load: the planes are written
//     by generic stores of other blocks and read by the TMA (the async
//     proxy). A plane is rewritten two steps later, after every block has
//     passed the barrier that ends its reads.
//   - The consumers' waits give up after ~10 s instead of trapping, and
//     the kernel traps at its end: sm90::mbar_wait's trap, on a branch
//     between the products, made ptxas serialize every wgmma (C7518;
//     found by building variants). The accumulators are read on no
//     divergent path, and the sigmoid divides with __fdividef: the form
//     that was built free of C7518.
// hT and cT come from the float32 carries, never from the rounded plane.
// Steps past the longest row are not run; their outputs are written as
// 0 (cseq: the frozen c, gates: 0), by the whole block, neighbouring
// threads on neighbouring units. `Mode` 1 runs the steps with no product
// (x4 loads, gate math, stores, barrier) and 2 the barriers alone: the
// per-step floors of this plan (timed by chip_smoke.py; their results
// are not the function). Mode is a template constant, so no wgmma sits
// under a runtime branch. `stages` caps the ring's depth for the same
// timings.
//
// Build: as lstm_bwd_bf16x3_sm90.cu.

#include "rnn_common.cuh"
#include "sm90_pipeline.cuh"

namespace {

using namespace rnn;

constexpr int kUnits = 16;                 // hidden units a block
constexpr int kCols = 4 * kUnits;          // wgmma N: 4 gates x 16 units
constexpr int kChunk = 64;                 // columns of h (K) a chunk
constexpr int kHRows = 64;                 // batch rows a TMA box
constexpr int kConsumers = 2;              // warpgroups: 128 batch rows
constexpr int kBatchTile = kHRows * kConsumers;
constexpr int kThreadsSm90 = 128 * kConsumers + 32;
constexpr uint32_t kWTileBytes = kCols * kChunk * 2;      // 8192
constexpr uint32_t kHTileBytes = kHRows * kChunk * 2;     // 8192
constexpr int kMaxStages = 8;
// static shared memory of the kernel (barriers, steps_to_run), rounded up
constexpr size_t kStaticReserve = 1024;

__host__ __device__ inline int n_chunks(int H) {
  return (H + kChunk - 1) / kChunk;
}

// Ring stages that fit beside the resident weights (rnn_common.cuh
// ring_stages_fit)
__host__ __device__ inline int ring_stages(int H, int cap) {
  return ring_stages_fit((long long)kStaticReserve + 1024 +
                             (long long)n_chunks(H) * kWTileBytes,
                         (long long)kConsumers * kHTileBytes, kMaxStages, cap);
}

__host__ __device__ inline size_t dyn_smem(int H, int stages) {
  return 1024 + (size_t)n_chunks(H) * kWTileBytes +
         (size_t)stages * kConsumers * kHTileBytes;
}

// byte offset of element (n, kc) (column n < 64, k offset kc < 64) in a
// [64, 64] bf16 K-major tile with the 128-byte swizzle: 8-row atoms of
// 1024 bytes, the 16-byte chunk c of row n at chunk c ^ (n % 8)
__device__ __forceinline__ uint32_t wtile_off(int n, int kc) {
  const int r = n & 7;
  return (n >> 3) * 1024 + r * 128 + ((((kc >> 3) ^ r) & 7) << 4) +
         (kc & 7) * 2;
}

// The block's weight columns as K-major tiles of 64 k: tile c, row n =
// 16 g + u holds w[k, g * gs + j0 + u] for k in [64c, 64c + 64), with w
// of row pitch ldw and K rows; units past uu and k past K are zero.
// Lanes take consecutive n, so each load of a warp reads two runs of 16
// adjacent columns. Generic stores: the caller fences the async proxy
// before a wgmma reads them.
__device__ void load_w_tiles(uint8_t* ws, const __nv_bfloat16* w, int K,
                             size_t ldw, int gs, int j0, int uu,
                             int nchunk) {
  const unsigned short* wu = reinterpret_cast<const unsigned short*>(w);
  const int total = nchunk * 8 * kCols;      // 16-byte groups
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int n = idx % kCols;
    const int g8 = (idx / kCols) & 7;
    const int c = idx / (8 * kCols);
    const int u = n % kUnits;
    const int k0 = c * kChunk + g8 * 8;
    uint32_t e[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    if (u < uu) {
      const size_t col = (size_t)(n / kUnits) * gs + j0 + u;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (k0 + i < K) e[i] = wu[(size_t)(k0 + i) * ldw + col];
    }
    *reinterpret_cast<uint4*>(ws + c * kWTileBytes + wtile_off(n, g8 * 8)) =
        make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16),
                   e[4] | (e[5] << 16), e[6] | (e[7] << 16));
  }
}

// acc (+)= the [64, 64] product of one 64-column chunk: A = a [64 rows,
// 64 k] swizzled by the TMA, B = the chunk's weight tile
__device__ __forceinline__ void chunk_product(float (&acc)[32],
                                              const uint8_t* a,
                                              const uint8_t* wt) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::wgmma_ss<0>(acc, sm90::desc_k(a, kk), sm90::desc_k(wt, kk), 1);
}

// The accumulator register of gate g, row half hh (rows l/4 and l/4 + 8)
// and unit slot us (units 2q, 2q+1, 2q+8, 2q+9 for us 0..3): column
// n = 16 g + u sits at d[4 * (n / 8) + 2 hh + n % 2].
__device__ __forceinline__ constexpr int acc_at(int g, int hh, int us) {
  return 4 * (2 * g + (us >> 1)) + 2 * hh + (us & 1);
}

// the unit (within the block) of slot us for lane quad q
__device__ __forceinline__ int slot_unit(int us, int q) {
  return (us >> 1) * 8 + 2 * q + (us & 1);
}

// two adjacent bf16 values at p: one 32-bit access when `pair` (both
// valid, 4-byte aligned), else element by element for the first n
__device__ __forceinline__ uint32_t ld2(const __nv_bfloat16* p, int n,
                                       bool pair) {
  if (pair) return __ldg(reinterpret_cast<const unsigned int*>(p));
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  uint32_t v = n > 0 ? (uint32_t)__ldg(q) : 0u;
  if (n > 1) v |= (uint32_t)__ldg(q + 1) << 16;
  return v;
}

// two bf16 values packed in v (the first in the low half) to p, the
// same way
__device__ __forceinline__ void st2(__nv_bfloat16* p, uint32_t v, int n,
                                    bool pair) {
  if (pair) {
    *reinterpret_cast<uint32_t*>(p) = v;
  } else {
    unsigned short* q = reinterpret_cast<unsigned short*>(p);
    if (n > 0) q[0] = (unsigned short)(v & 0xffffu);
    if (n > 1) q[1] = (unsigned short)(v >> 16);
  }
}

__device__ __forceinline__ float lo_f(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_f(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// sm90::mbar_wait for the consumers: the same parity wait, but a phase
// that never completes (over 2^35 cycles, above 10 s) ends the wait with
// false instead of a trap. A trap on that path, between the products,
// makes ptxas serialize every wgmma (C7518); the kernel traps at its end
// instead, once no product is in flight, so the launch still fails
// rather than hang the card.
__device__ __forceinline__ bool mbar_wait_or_give_up(uint64_t* bar,
                                                     uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p, more;\n"
      ".reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "@p bra LAB_DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.lt.u64 more, t1, 34359738368;\n"
      "@more bra LAB_WAIT;\n"
      "LAB_DONE:\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(sm90::smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// 1 / (1 + e^-x) through __fdividef (within 2 ulp of the IEEE division,
// whose rare slow path is a call on a branch; only this form was built
// free of C7518 here)
__device__ __forceinline__ float sigmoid_fd(float x) {
  return __fdividef(1.f, 1.f + expf(-x));
}

template <int Mode>
__global__ void __launch_bounds__(kThreadsSm90, 1) lstm_fwd_sm90_kernel(
    const __grid_constant__ CUtensorMap map_h,
    const __nv_bfloat16* __restrict__ x4, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ peep,
    const int* __restrict__ lens, __nv_bfloat16* __restrict__ out,
    __nv_bfloat16* __restrict__ cseq, __nv_bfloat16* __restrict__ gates,
    float* __restrict__ hT, float* __restrict__ cT, __nv_bfloat16* hs,
    unsigned int* bar, int B, int Tn, int H, int pitch, int stages) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  // bias (4 gates) and peepholes (3) of the block's units, read by the
  // threads as broadcasts rather than held in 28 registers each
  __shared__ float bp[7][kUnits];
  uint8_t* smem = sm90::align1024(smem_raw);
  const int nchunk = n_chunks(H);
  uint8_t* ws = smem;
  uint8_t* ring = smem + (size_t)nchunk * kWTileBytes;
  auto h_tile = [&](int s, int g) {
    return ring + (s * kConsumers + g) * kHTileBytes;
  };

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q = lane % 4;
  const int j0 = blockIdx.x * kUnits;
  const int uu = min(kUnits, H - j0);
  const size_t H4 = 4 * (size_t)H;
  const bool even = (H & 1) == 0;   // adjacent units share 4-byte words
  const bool consumer = warp < 4 * kConsumers;
  const int wg = warp / 4;
  const int w4 = warp % 4;
  const int n_bt = (B + kBatchTile - 1) / kBatchTile;
  const bool res = cseq != nullptr;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4 * kConsumers);   // one arrive a warp
    }
    sm90::mbar_fence_init();
  }
  if (Mode == 0) {
    load_w_tiles(ws, w, H, H4, H, j0, uu, nchunk);
    sm90::fence_proxy_async_shared();
  }

  // the thread's units (slots us: 2q, 2q+1, 2q+8, 2q+9) and, per pair
  // p (slots 2p, 2p+1), how many of its two units the block owns
  int npair[2];
#pragma unroll
  for (int p = 0; p < 2; ++p)
    npair[p] = max(0, min(2, uu - (8 * p + 2 * q)));
  if (tid < 7 * kUnits) {
    const int g = tid / kUnits;
    const int u = tid % kUnits;
    bp[g][u] = u >= uu ? 0.f
               : g < 4 ? bias[g * H + j0 + u] : peep[(g - 4) * H + j0 + u];
  }
  // the float32 carries of one batch tile (of the only one when n_bt is
  // 1; else hT / cT hold them between tiles)
  float hc[2][4], cc[2][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int us = 0; us < 4; ++us) hc[hh][us] = cc[hh][us] = 0.f;
  auto row_of = [&](int bt, int hh) {
    return bt * kBatchTile + kHRows * wg + 16 * w4 + lane / 4 + 8 * hh;
  };
  if (consumer && n_bt > 1) {
    for (int bt = 0; bt < n_bt; ++bt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row_of(bt, hh);
#pragma unroll
        for (int us = 0; us < 4; ++us)
          if (r < B && slot_unit(us, q) < uu) {
            hT[(size_t)r * H + j0 + slot_unit(us, q)] = 0.f;
            cT[(size_t)r * H + j0 + slot_unit(us, q)] = 0.f;
          }
      }
  }
  // x4 of step t for the thread's (row, gate, pair) of tile bt, raw, and
  // the two rows' lengths (0 past B)
  uint32_t xr[2][4][2];
  int xl[2];
  auto load_x = [&](int bt, int t) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row_of(bt, hh);
      const bool rv = r < B;
      xl[hh] = rv ? __ldg(lens + r) : 0;
      const __nv_bfloat16* xrow =
          x4 + ((size_t)(rv ? r : 0) * Tn + t) * H4 + j0 + 2 * q;
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int n = rv ? npair[p] : 0;
          xr[hh][g][p] = ld2(xrow + g * H + 8 * p, n, even && n == 2);
        }
    }
  };
  // the residuals of the last tile of a step, packed bf16 pairs: stored
  // after the block arrives at the step's barrier
  uint32_t rout[2][2], rcs[2][2], rga[2][4][2];
  auto store_res = [&](int bt, int t) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row_of(bt, hh);
      if (r >= B) continue;
      const size_t srow = (size_t)r * Tn + t;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int n = npair[p];
        if (n == 0) continue;
        const int j = j0 + 8 * p + 2 * q;
        const bool pair = even && n == 2;
        st2(out + srow * H + j, rout[hh][p], n, pair);
        if (res) {
          st2(cseq + srow * H + j, rcs[hh][p], n, pair);
#pragma unroll
          for (int g = 0; g < 4; ++g)
            st2(gates + srow * H4 + g * H + j, rga[hh][g][p], n, pair);
        }
      }
    }
  };
  const int t_end = steps_to_run(lens, B, Tn);      // syncs the block
  if (consumer && Mode != 2 && t_end > 0) load_x(0, 0);

  uint32_t it = 0;           // ring position: the same walk on both sides
  unsigned int epoch = 0;
  bool stuck = false;        // a consumer's wait gave up (see above)
  for (int t = 0; t < t_end; ++t) {
    const int plane = t & 1;                 // holds round(h_{t-1})
    __nv_bfloat16* hnext = hs + (size_t)(plane ^ 1) * B * pitch;
    if (!consumer) {                         // ---- producer warp
      if (Mode == 0 && lane == 0) {
        sm90::fence_proxy_async_global();
        for (int bt = 0; bt < n_bt; ++bt) {
          const int r0 = bt * kBatchTile;
          const int tiles = r0 + kHRows < B ? 2 : 1;
          for (int c = 0; c < nchunk; ++c, ++it) {
            const int s = it % stages;
            sm90::mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
            sm90::mbar_expect_tx(&full[s], tiles * kHTileBytes);
            for (int g = 0; g < tiles; ++g)
              sm90::tma_load_3d(h_tile(s, g), &map_h, &full[s],
                                c * kChunk, r0 + kHRows * g,
                                plane);
          }
        }
      }
      __syncwarp();
    } else if (Mode != 2) {                  // ---- consumer warpgroup wg
      for (int bt = 0; bt < n_bt; ++bt) {
        if (bt > 0) load_x(bt, t);
        float acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        if (Mode == 0) {
          sm90::fence_regs(acc);
          int prev = 0;
          // every warpgroup multiplies, the one with no rows too (on a
          // tile it was not sent, its result unused): a wgmma on a
          // divergent path makes ptxas serialize them all (C7518)
          for (int c = 0; c < nchunk; ++c, ++it) {
            const int s = it % stages;
            if (!stuck && !mbar_wait_or_give_up(&full[s], (it / stages) & 1))
              stuck = true;
            sm90::wgmma_fence();
            chunk_product(acc, h_tile(s, wg),
                          ws + c * kWTileBytes);
            sm90::wgmma_commit();
            sm90::wgmma_wait<1>();           // the previous chunk is done
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
        }
        // z of the thread's (row, unit) pairs, read from the accumulators
        // on no divergent path (ptxas would serialize every wgmma, C7518)
        float z[2][4][4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int us = 0; us < 4; ++us)
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              const uint32_t xg = xr[hh][g][us >> 1];
              z[hh][us][g] = ((us & 1) ? hi_f(xg) : lo_f(xg)) +
                             acc[acc_at(g, hh, us)] +
                             bp[g][slot_unit(us, q)];
            }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int us = 0; us < 4; ++us) sm90::fence_regs(z[hh][us]);
        // the gate math in registers; rows past B compute as frozen rows
        // and store nothing
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = row_of(bt, hh);
          const bool rv = r < B;
          const bool valid = t < xl[hh];
          if (n_bt > 1) {
#pragma unroll
            for (int us = 0; us < 4; ++us)
              if (rv && slot_unit(us, q) < uu) {
                const size_t s = (size_t)r * H + j0 + slot_unit(us, q);
                hc[hh][us] = hT[s];
                cc[hh][us] = cT[s];
              }
          }
          float ho[4], ga[4][4];
#pragma unroll
          for (int us = 0; us < 4; ++us) {
            const int u = slot_unit(us, q);
            const float c = cc[hh][us];
            const float ig = sigmoid_fd(z[hh][us][0] + bp[4][u] * c);
            const float fg = sigmoid_fd(z[hh][us][1] + bp[5][u] * c);
            const float cand = tanhf(z[hh][us][2]);
            const float cn = fg * c + ig * cand;
            const float og = sigmoid_fd(z[hh][us][3] + bp[6][u] * cn);
            const float hn = og * tanhf(cn);
            ho[us] = valid ? hn : 0.f;
            hc[hh][us] = valid ? hn : hc[hh][us];
            cc[hh][us] = valid ? cn : c;
            ga[0][us] = ig;
            ga[1][us] = fg;
            ga[2][us] = cand;
            ga[3][us] = og;
          }
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            rout[hh][p] = sm90::pack_bf16(ho[2 * p], ho[2 * p + 1]);
            rcs[hh][p] = sm90::pack_bf16(cc[hh][2 * p], cc[hh][2 * p + 1]);
#pragma unroll
            for (int g = 0; g < 4; ++g)
              rga[hh][g][p] = sm90::pack_bf16(ga[g][2 * p], ga[g][2 * p + 1]);
            // round(h_keep) for the next product: frozen rows keep h
            const int n = rv ? npair[p] : 0;
            if (n > 0)
              st2(hnext + (size_t)r * pitch + j0 + 8 * p + 2 * q,
                  sm90::pack_bf16(hc[hh][2 * p], hc[hh][2 * p + 1]), n,
                  n == 2);
          }
          if (n_bt > 1) {
#pragma unroll
            for (int us = 0; us < 4; ++us)
              if (rv && slot_unit(us, q) < uu) {
                const size_t s = (size_t)r * H + j0 + slot_unit(us, q);
                hT[s] = hc[hh][us];
                cT[s] = cc[hh][us];
              }
          }
        }
        if (bt + 1 < n_bt) store_res(bt, t);
      }
      sm90::fence_proxy_async_global();
    }
    // the others wait only for the planes: the last tile's residuals
    // and the next step's x4 loads go between arriving and waiting
    grid_arrive(bar);
    if (consumer && Mode != 2) {
      store_res(n_bt - 1, t);
      if (t + 1 < t_end) load_x(0, t + 1);
    }
    grid_wait(bar, ++epoch);
  }

  if (stuck) __trap();
  // final state from the carries, then the steps past the longest row
  // by the whole block, neighbouring threads on neighbouring units
  if (consumer && n_bt == 1) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row_of(0, hh);
#pragma unroll
      for (int us = 0; us < 4; ++us)
        if (r < B && slot_unit(us, q) < uu) {
          const size_t s = (size_t)r * H + j0 + slot_unit(us, q);
          hT[s] = hc[hh][us];
          cT[s] = cc[hh][us];
        }
    }
  }
  if (t_end == Tn) return;
  __syncthreads();                           // cT is read by all threads
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int p = tid; p < B * uu; p += blockDim.x) {
    const int r = p / uu;
    const int j = j0 + (p - r * uu);
    const __nv_bfloat16 c = __float2bfloat16(cT[(size_t)r * H + j]);
    for (int t = t_end; t < Tn; ++t) {
      const size_t srow = (size_t)r * Tn + t;
      out[srow * H + j] = zero;
      if (res) {
        cseq[srow * H + j] = c;
        for (int g = 0; g < 4; ++g) gates[srow * H4 + g * H + j] = zero;
      }
    }
  }
}

// ---- a check of the building blocks on one [64, K] x [K, 64] product:
// A loaded by TMA through the scratch's map (one plane, chunks of 64
// columns, the tail zero-filled), W as four gate blocks of 16 columns
// (gate stride 16) through load_w_tiles, the chunks on wgmma m64n64k16
// with one commit group in flight, as the kernel runs
__global__ void __launch_bounds__(128) lstm_fwd_sm90_product_check_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __nv_bfloat16* __restrict__ w, float* __restrict__ c, int K) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full;
  uint8_t* smem = sm90::align1024(smem_raw);
  const int nchunk = n_chunks(K);
  uint8_t* ws = smem;
  uint8_t* as = smem + nchunk * kWTileBytes;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&full, 1);
    sm90::mbar_fence_init();
  }
  load_w_tiles(ws, w, K, kCols, kUnits, 0, kUnits, nchunk);
  sm90::fence_proxy_async_shared();
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_expect_tx(&full, nchunk * kHTileBytes);
    for (int ch = 0; ch < nchunk; ++ch)
      sm90::tma_load_3d(as + ch * kHTileBytes, &map_a, &full, ch * kChunk,
                        0, 0);
  }
  sm90::mbar_wait(&full, 0);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  sm90::fence_regs(acc);
  for (int ch = 0; ch < nchunk; ++ch) {
    sm90::wgmma_fence();
    chunk_product(acc, as + ch * kHTileBytes, ws + ch * kWTileBytes);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  const int w4 = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    c[sm90::frag_row(i, w4, lane) * kCols + sm90::frag_col(i, lane)] =
        acc[i];
}

template <int Mode>
cudaError_t launch_mode(void** args, int grid, size_t smem,
                        cudaStream_t stream) {
  static size_t configured = 0;
  return coop_launch((const void*)lstm_fwd_sm90_kernel<Mode>, grid, smem,
                     configured, args, stream, kThreadsSm90);
}

}  // namespace

// x4 [B, T, 4H], w [H, 4H], out, cseq [B, T, H] and gates [B, T, 4H]
// bf16 (cseq and gates null: no residuals); bias [4H], peep [3H], hT and
// cT [B, H] float32; hs the bf16 scratch [2, B, pitch] with pitch = H
// rounded up to 8, plane 0 zeroed (h_{-1} = 0); lens [B] int32; bar one
// zeroed uint32. `mode` 0 computes the function; 1 and 2 are the floors
// of the file note. `stages` caps the ring's depth (0: as many as fit;
// the ring depth changes no result). Returns the CUDA error of the
// launch (0 on success); the wrapper raises on anything else.
extern "C" int pt_lstm_fwd_sm90(const void* x4, const void* w,
                                const void* bias, const void* peep,
                                const void* lens, void* out, void* cseq,
                                void* gates, void* hT, void* cT, void* hs,
                                void* bar, int B, int Tn, int H, int mode,
                                int stages, void* stream) {
  if (B <= 0 || Tn <= 0 || H <= 0 || mode < 0 || mode > 2 || stages < 0 ||
      (cseq == nullptr) != (gates == nullptr))
    return (int)cudaErrorInvalidValue;
  stages = ring_stages(H, stages);
  if (stages == 0) return (int)cudaErrorInvalidValue;
  int pitch = (H + 7) / 8 * 8;
  CUtensorMap mh;
  if (!sm90::make_rows_map(&mh, hs, H, B, 2, pitch))
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* x4_ = static_cast<const __nv_bfloat16*>(x4);
  const __nv_bfloat16* w_ = static_cast<const __nv_bfloat16*>(w);
  const float* bias_ = static_cast<const float*>(bias);
  const float* peep_ = static_cast<const float*>(peep);
  const int* lens_ = static_cast<const int*>(lens);
  __nv_bfloat16* out_ = static_cast<__nv_bfloat16*>(out);
  __nv_bfloat16* cseq_ = static_cast<__nv_bfloat16*>(cseq);
  __nv_bfloat16* gates_ = static_cast<__nv_bfloat16*>(gates);
  float* hT_ = static_cast<float*>(hT);
  float* cT_ = static_cast<float*>(cT);
  __nv_bfloat16* hs_ = static_cast<__nv_bfloat16*>(hs);
  unsigned int* bar_ = static_cast<unsigned int*>(bar);
  void* args[] = {&mh,  &x4_, &w_,   &bias_, &peep_, &lens_, &out_,
                  &cseq_, &gates_, &hT_, &cT_, &hs_, &bar_, &B,
                  &Tn,  &H,   &pitch, &stages};
  const int grid = (H + kUnits - 1) / kUnits;
  const size_t smem = dyn_smem(H, stages);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (mode == 0)
    e = launch_mode<0>(args, grid, smem, st);
  else if (mode == 1)
    e = launch_mode<1>(args, grid, smem, st);
  else
    e = launch_mode<2>(args, grid, smem, st);
  return (int)e;
}

// a [64, K] and w [K, 64] bf16 row-major (K % 8 == 0, K <= 128); c
// [64, 64] float32 = a w
extern "C" int pt_lstm_fwd_sm90_product_check(const void* a, const void* w,
                                              void* c, int K, void* stream) {
  if (K <= 0 || K % 8 != 0 || K > 128) return (int)cudaErrorInvalidValue;
  CUtensorMap ma;
  if (!sm90::make_rows_map(&ma, a, K, kHRows, 1, K))
    return (int)cudaErrorInvalidValue;
  const size_t smem = 1024 + (size_t)n_chunks(K) * (kWTileBytes + kHTileBytes);
  lstm_fwd_sm90_product_check_kernel<<<1, 128, smem,
                                       static_cast<cudaStream_t>(stream)>>>(
      ma, static_cast<const __nv_bfloat16*>(w), static_cast<float*>(c), K);
  return (int)cudaGetLastError();
}

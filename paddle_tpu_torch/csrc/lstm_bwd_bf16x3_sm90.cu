// Fused LSTM sequence backward for Hopper's tensor cores (sm_90a),
// float32, its product as three bf16 passes.
//
// Replaces: paddle_tpu/ops/pallas_rnn.py:_lstm_bwd_kernel (launched by
// _lstm_bwd) for float32 weights; bfloat16 takes lstm_bwd_sm90.cu. Same
// function: in reverse time, from the forward's activated gates and c
// sequence, the output cotangent dh_seq and the final-state cotangents
// dhT / dcT, it carries (dh, dc) and emits dz, the cotangent of the gate
// pre-activations:
//   dh_t = dh + [valid] dh_seq[t]
//   dzo = dh_t*tanh(c_t)*o*(1-o)
//   dc_t = dc + dh_t*o*(1-tanh(c_t)^2) + dzo*po
//   dzi = dc_t*c~*i*(1-i), dzf = dc_t*c_{t-1}*f*(1-f), dzc = dc_t*i*(1-c~^2)
//   dz_t = [valid] [dzi, dzf, dzc, dzo]
//   dh <- [valid] dz_t W^T,   dc <- [valid] dc_t*f + dzi*pi + dzf*pf
// (c_{t-1} is 0 at t = 0; valid = t < lens[r]; an invalid step zeroes
// dz and passes dh and dc through unchanged). The weight, bias and
// peephole gradients are large contractions over dz outside the kernel,
// as in the JAX package (ops/fused_rnn.py). Everything is float32 (the
// inputs, dz, the carries and the gate math) except inside the product,
// which runs as
//   dz W^T ~= (dz1 W2^T + dz2 W1^T) + dz1 W1^T,
//   W1 = bf16(W), W2 = bf16(W - W1), dz1 = bf16(dz), dz2 = bf16(dz - dz1)
// on wgmma with float32 accumulation (lstm_bf16x3.cuh).
//
// What bounds it on an H100: at B 128, H 1280 and 100 valid steps the
// three passes are 3 * 2*B*H*4H*100 = 503 GFLOP (0.509 ms at the bf16
// tensor cores' 989 TFLOP/s) against about 0.86 GB of float32 streams
// (0.26 ms at 3.35 TB/s): operation-bound. The plan adds what the bound
// does not count: every step each block reads both bf16 halves of one
// gate of dz_t ([128, 1280] each, 655 KB) from L2 — 84 MB a step over
// 128 blocks — one grid barrier and one group sync a step, and the
// partial products' round trip through L2 (2.6 MB a step).
//
// Design: lstm_fwd_bf16x3_sm90.cu's plan, its blocks split by gate:
//   - One cooperative launch of 4 ceil(H / 40) blocks (128 at H 1280,
//     one per SM): block (c, q) = blockIdx.x (4c + q) serves gate q of
//     the unit group [40c, 40c + 40). It holds W[40c + n, q H + k] for
//     the group's 40 units n and k < H — a contiguous slice of each of
//     the 40 rows — as W1 and W2, each as K-major [40 n x 64 k] tiles in
//     the 128-byte swizzle (2 x 20 x 5120 B at H 1280: the forward's
//     footprint), the B operands of wgmma m64n40k16. Ten units a block
//     with all 4H of their rows (the forward's plan transposed) would
//     need 327 KB for N padded to 16, and every block would read all of
//     dz_t a step.
//   - Owner phase: block (c, q) owns units [40c + 10q, 40c + 10q + 10)
//     and keeps the dh and dc carries of its (row, unit) cells in
//     registers for the whole sequence (in dhs / dcs, owner-only, when
//     B > 128 takes several batch tiles): a thread's 5 cells are the
//     forward's (units 2l, 2l + 1 of both its rows and unit 8 + l/2 of
//     one, l = lane % 4). At step t it sums its units' four partial
//     products P_0..P_3 of step t + 1 in that order for the rows valid
//     there (dh of the others passes through), runs the gate math,
//     writes dz_t split, dz1 and dz2, into the planes of each gate (per
//     gate and half a bf16 [B, H] plane in the A fragment order of
//     lstm_bf16x3.cuh, double-buffered by step parity) and arrives at
//     the grid barrier. Only then does it load the next step's gates,
//     c sequence and dh_seq and store dz_t in float32 (no block reads
//     them), as unit pairs (8-byte accesses), and wait for the others.
//   - Product phase: block (c, q) streams both halves of gate q's
//     planes (the forward's register ring of S k-steps) and writes its
//     partial P_q(t) = dz_t[:, q H : q H + H] W[40c : 40c + 40, q H :
//     q H + H]^T, [B, 40] float32, into a scratch [2 parities][groups]
//     [4 gates][B][40]; then the four blocks of group c meet on a
//     counter of their own (a release add, an acquire wait on an epoch:
//     no second grid barrier) and the owners read their partials. The
//     product of the last step (t = 0) is not needed and not run.
//   - Parities: a plane or a partial slot is rewritten two steps later,
//     after every block has passed the grid barrier that ends its reads.
// Units past H have zero weight rows and no owner cells. Steps past the
// longest row are not run: their dz is written as 0 at the start, whole
// rows across the grid, and the carries pass through them. `Mode` 1
// runs the steps without the product (the partials are 0), 2 the grid
// barriers and group syncs alone, 3 the dz stream alone (the loads of
// both planes, barriers and syncs, nothing else), 4 the steps with the
// products but no dz stream (each step's first S k-steps of fragments,
// loaded once, reused): the per-step floors of this plan (timed by
// chip_smoke.py; their results are not the function). Mode and S are
// template constants, so no wgmma sits under a runtime branch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler
// -fPIC (paddle_tpu_torch/ops/_build.py); bound with ctypes through the
// plain C functions at the bottom.

#include "lstm_bf16x3.cuh"

namespace {

using namespace rnn;
using namespace bf16x3;

// words of the grid barrier and of each group's counter: one 128-byte
// line each
constexpr int kBarPitch = 32;

__host__ __device__ inline int n_groups(int H) {
  return (H + kCols - 1) / kCols;
}

// The block's B operand split into W1 = bf16(w) and W2 = bf16(w - W1),
// as K-major tiles of 64 k: tile c, row n holds w[n * ldw + k] for k in
// [64c, 64c + 64), rows of w contiguous in k; rows n >= n_ok and k >= K
// are zero. Eight threads read 64 consecutive k of one row. Generic
// stores: the caller fences the async proxy before a wgmma reads them.
__device__ void load_w_rows(uint8_t* w1s, uint8_t* w2s, const float* w,
                            size_t ldw, int n_ok, int K, int nchunk) {
  const int total = nchunk * 8 * kCols;      // 16-byte groups of a half
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int g8 = idx & 7;
    const int n = (idx >> 3) % kCols;
    const int c = idx / (8 * kCols);
    const int k0 = c * kChunk + g8 * 8;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (n < n_ok) {
      const float* row = w + (size_t)n * ldw;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (k0 + i < K) v[i] = __ldg(row + k0 + i);
    }
    put_w8(w1s, w2s, c * kWTileBytes + wtile_off(n, g8 * 8), v);
  }
}

// The four blocks of a group meet: each arrives once a product step
// (its partials stored), and waits until all four did (target = 4 x the
// step count); the release and acquire of grid_arrive / grid_wait
__device__ __forceinline__ void group_sync(unsigned int* ctr,
                                           unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ctr, 1u);
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(ctr)
                   : "memory");
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

// two adjacent float32 values at p written in this launch by another
// block (L2, never a stale L1 line)
__device__ __forceinline__ float2 ldcg2(const float* p) {
  return __ldcg(reinterpret_cast<const float2*>(p));
}

template <int Mode, int S>
__global__ void __launch_bounds__(kThreadsX3, 1) lstm_bwd_bf16x3_kernel(
    const float* __restrict__ w, const float* __restrict__ peep,
    const int* __restrict__ lens, const float* __restrict__ gates,
    const float* __restrict__ cseq, const float* __restrict__ dhseq,
    const float* __restrict__ dhT, const float* __restrict__ dcT,
    float* __restrict__ dz, float* __restrict__ dhs, float* __restrict__ dcs,
    uint32_t* zs, float* part, unsigned int* bar, int B, int Tn, int H) {
  extern __shared__ uint8_t smem_raw[];
  // peepholes (i, f, o) of the block's owned units, read as broadcasts
  __shared__ float pp[3][kUnits];
  uint8_t* smem = sm90::align1024(smem_raw);
  const int nchunk = n_chunks(H);
  const int nks = 4 * nchunk;
  uint8_t* w1s = smem;
  uint8_t* w2s = smem + (size_t)nchunk * kWTileBytes;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q = lane % 4;
  const int wg = warp / 4;
  const int w4 = warp % 4;
  const int grp = blockIdx.x >> 2;           // the unit group c
  const int gq = blockIdx.x & 3;             // the gate this block multiplies
  const int g0 = grp * kCols;
  const int j0 = g0 + kUnits * gq;           // the owned units [j0, j0 + 10)
  const int uu = max(0, min(kUnits, H - j0));
  const size_t H4 = 4 * (size_t)H;
  const int n_bt = (B + kBatchTile - 1) / kBatchTile;
  const bool even = (H & 1) == 0;   // unit pairs are 8-byte aligned
  // how many of the thread's unit pair (2q, 2q + 1) the block owns
  const int npair = max(0, min(2, uu - 2 * q));
  // uint4 of one plane: 2 n_bt m-tiles x nks k-steps x kFrags; planes
  // [gate][parity][half]
  const size_t plane = (size_t)2 * n_bt * nks * kFrags;
  auto plane_of = [&](int g, int par) {
    return zs + (size_t)(2 * g + par) * 2 * plane * 4;
  };
  // partials [parity][group][gate][B][40]
  const size_t slab = (size_t)B * kCols;
  auto part_of = [&](int par, int g) {
    return part + ((size_t)(par * (gridDim.x >> 2) + grp) * 4 + g) * slab;
  };
  unsigned int* gbar = bar + kBarPitch * (1 + grp);

  if (Mode == 0 || Mode == 4) {
    load_w_rows(w1s, w2s, w + (size_t)g0 * H4 + (size_t)gq * H, H4,
                min(kCols, H - g0), H, nchunk);
    sm90::fence_proxy_async_shared();
  }
  if (tid < 3 * kUnits) {
    const int g = tid / kUnits;
    const int u = tid % kUnits;
    pp[g][u] = u < uu ? peep[g * H + j0 + u] : 0.f;
  }
  const int t_end = steps_to_run(lens, B, Tn);      // syncs the block
  // dz of the steps past the longest row: 0, whole rows across the grid
  const int tail = Tn - t_end;
  for (int i = blockIdx.x; i < B * tail; i += gridDim.x) {
    const int r = i / tail;
    float4* o = reinterpret_cast<float4*>(
        dz + ((size_t)r * Tn + t_end + (i - r * tail)) * H4);
    for (int k = tid; k < H; k += blockDim.x)
      o[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // the thread's cells (lstm_fwd_bf16x3_sm90.cu's): c < 4 row half c / 2,
  // unit 2q + c % 2; cell 4 unit 8 + q / 2 in row half q % 2
  auto cell_hh = [&](int c) { return c < 4 ? (c >> 1) : (q & 1); };
  auto cell_u = [&](int c) { return c < 4 ? 2 * q + (c & 1) : 8 + (q >> 1); };
  auto row_of = [&](int bt, int hh) {
    return bt * kBatchTile + 64 * wg + 16 * w4 + lane / 4 + 8 * hh;
  };
  auto cell_ok = [&](int bt, int c) {
    return row_of(bt, cell_hh(c)) < B && cell_u(c) < uu;
  };
  // the float32 carries of one batch tile (of the only one when n_bt is
  // 1; else dhs / dcs hold them between tiles)
  float dhc[kCells], dcc[kCells];
#pragma unroll
  for (int c = 0; c < kCells; ++c) dhc[c] = dcc[c] = 0.f;
  for (int bt = 0; bt < n_bt; ++bt)
#pragma unroll
    for (int c = 0; c < kCells; ++c)
      if (cell_ok(bt, c)) {
        const size_t s = (size_t)row_of(bt, cell_hh(c)) * H + j0 + cell_u(c);
        if (n_bt > 1) {
          dhs[s] = dhT[s];
          dcs[s] = dcT[s];
        } else {
          dhc[c] = dhT[s];
          dcc[c] = dcT[s];
        }
      }
  // step t's inputs for the thread's cells of tile bt: gates, c_t,
  // c_{t-1}, dh_seq[t], and the two rows' lengths (0 past B)
  float xg[kCells][4], xc[kCells], xp[kCells], xd[kCells];
  int xl[2];
  auto load_in = [&](int bt, int t) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row_of(bt, hh);
      const bool rv = r < B;
      xl[hh] = rv ? __ldg(lens + r) : 0;
      const int n = rv ? npair : 0;
      const bool pair = even && n == 2;
      const size_t srow = (size_t)(rv ? r : 0) * Tn + t;
      const float* g4 = gates + srow * H4 + j0 + 2 * q;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float2 v = ld_pair(g4 + g * H, n, pair);
        xg[2 * hh][g] = v.x;
        xg[2 * hh + 1][g] = v.y;
      }
      const float* cr = cseq + srow * H + j0 + 2 * q;
      float2 v = ld_pair(cr, n, pair);
      xc[2 * hh] = v.x;
      xc[2 * hh + 1] = v.y;
      v = ld_pair(t > 0 ? cr - H : cr, t > 0 ? n : 0, t > 0 && pair);
      xp[2 * hh] = v.x;
      xp[2 * hh + 1] = v.y;
      v = ld_pair(dhseq + srow * H + j0 + 2 * q, n, pair);
      xd[2 * hh] = v.x;
      xd[2 * hh + 1] = v.y;
    }
    const bool ok = cell_ok(bt, 4);
    const size_t srow = (size_t)(ok ? row_of(bt, cell_hh(4)) : 0) * Tn + t;
    const int j = j0 + cell_u(4);
#pragma unroll
    for (int g = 0; g < 4; ++g)
      xg[4][g] = ok ? __ldg(gates + srow * H4 + g * H + j) : 0.f;
    xc[4] = ok ? __ldg(cseq + srow * H + j) : 0.f;
    xp[4] = ok && t > 0 ? __ldg(cseq + (srow - 1) * H + j) : 0.f;
    xd[4] = ok ? __ldg(dhseq + srow * H + j) : 0.f;
  };
  // dz of the last tile of a step: stored after the block arrives at the
  // step's barrier
  float z[kCells][4];
  auto store_dz = [&](int bt, int t) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row_of(bt, hh);
      if (r >= B || npair == 0) continue;
      float* dr = dz + ((size_t)r * Tn + t) * H4 + j0 + 2 * q;
      const int a = 2 * hh;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        st_pair(dr + g * H, z[a][g], z[a + 1][g], npair, even && npair == 2);
    }
    if (cell_ok(bt, 4)) {
      float* dr = dz + ((size_t)row_of(bt, cell_hh(4)) * Tn + t) * H4 + j0 +
                  cell_u(4);
#pragma unroll
      for (int g = 0; g < 4; ++g) dr[g * H] = z[4][g];
    }
  };
  if (Mode != 2 && Mode != 3 && t_end > 0) load_in(0, t_end - 1);

  unsigned int epoch = 0, gepoch = 0;
  uint32_t sink = 0u;
  for (int t = t_end - 1; t >= 0; --t) {
    const int par = t & 1;
    if (Mode != 2 && Mode != 3) {
      for (int bt = 0; bt < n_bt; ++bt) {
        if (bt > 0) load_in(bt, t);
        if (n_bt > 1) {
#pragma unroll
          for (int c = 0; c < kCells; ++c)
            if (cell_ok(bt, c)) {
              const size_t s =
                  (size_t)row_of(bt, cell_hh(c)) * H + j0 + cell_u(c);
              dhc[c] = dhs[s];
              dcc[c] = dcs[s];
            }
        }
        // dh of the rows valid at step t + 1: the four partials of its
        // product, summed in gate order
        if (t + 1 < t_end) {
          const float* pr = part_of(par ^ 1, 0);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = row_of(bt, hh);
            if (r < B && npair > 0 && t + 1 < xl[hh]) {
              const float* p = pr + (size_t)r * kCols + kUnits * gq + 2 * q;
              float2 s = ldcg2(p);
#pragma unroll
              for (int g = 1; g < 4; ++g) {
                const float2 v = ldcg2(p + g * slab);
                s.x += v.x;
                s.y += v.y;
              }
              dhc[2 * hh] = s.x;
              dhc[2 * hh + 1] = s.y;
            }
          }
          const int r = row_of(bt, cell_hh(4));
          if (cell_ok(bt, 4) && t + 1 < (cell_hh(4) ? xl[1] : xl[0])) {
            const float* p = pr + (size_t)r * kCols + kUnits * gq + cell_u(4);
            float s = __ldcg(p);
#pragma unroll
            for (int g = 1; g < 4; ++g) s += __ldcg(p + g * slab);
            dhc[4] = s;
          }
        }
        // the gate math in registers; cells past B or H compute on zeros
        // and store nothing
#pragma unroll
        for (int c = 0; c < kCells; ++c) {
          const int u = cell_u(c);
          // (a select, not an index: cell 4's row half is q % 2)
          const bool valid = t < (cell_hh(c) ? xl[1] : xl[0]);
          const float ig = xg[c][0], fg = xg[c][1];
          const float cand = xg[c][2], og = xg[c][3];
          const float dht = dhc[c] + (valid ? xd[c] : 0.f);
          const float tc = tanhf(xc[c]);
          const float dzo = dht * tc * og * (1.f - og);
          const float dct = dcc[c] + dht * og * (1.f - tc * tc) +
                            dzo * pp[2][u];
          const float dzi = dct * cand * ig * (1.f - ig);
          const float dzf = dct * xp[c] * fg * (1.f - fg);
          const float dzc = dct * ig * (1.f - cand * cand);
          z[c][0] = valid ? dzi : 0.f;
          z[c][1] = valid ? dzf : 0.f;
          z[c][2] = valid ? dzc : 0.f;
          z[c][3] = valid ? dzo : 0.f;
          if (valid) dcc[c] = dct * fg + dzi * pp[0][u] + dzf * pp[1][u];
        }
        // dz_t split into each gate's planes of parity t. A unit past H
        // (npair 1: the pair's second) computes 0 — its loads, weight rows
        // and carries are 0 — so the pair is written as it is: a select of
        // 0 for it here (npair == 2 ? z : 0) came out 0 for every pair's
        // second unit, though npair was 2
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          uint32_t* p1 = plane_of(g, par);
          uint32_t* p2 = p1 + plane * 4;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = row_of(bt, hh);
            if (r < B && npair > 0)
              put_pair(p1, p2, frag_word(r, j0 + 2 * q, nks), z[2 * hh][g],
                       z[2 * hh + 1][g]);
          }
          if (cell_ok(bt, 4)) {
            const int k = j0 + cell_u(4);
            put_one(p1, p2, frag_word(row_of(bt, cell_hh(4)), k & ~1, nks),
                    k, z[4][g]);
          }
        }
        if (n_bt > 1) {
#pragma unroll
          for (int c = 0; c < kCells; ++c)
            if (cell_ok(bt, c)) {
              const size_t s =
                  (size_t)row_of(bt, cell_hh(c)) * H + j0 + cell_u(c);
              dhs[s] = dhc[c];
              dcs[s] = dcc[c];
            }
        }
        if (bt + 1 < n_bt) store_dz(bt, t);
      }
    }
    // the others wait only for the planes: the next step's loads and the
    // last tile's dz stores go between arriving and waiting (the loads
    // first: issued behind the stores they reach the next step later)
    grid_arrive(bar);
    if (Mode != 2 && Mode != 3) {
      if (t > 0) load_in(0, t - 1);
      store_dz(n_bt - 1, t);
    }
    grid_wait(bar, ++epoch);
    if (t == 0) break;                 // dh_{-1} is no output
    // P_gq(t): this block's partial product of dz_t over gate gq
    const uint4* pin1 = reinterpret_cast<const uint4*>(plane_of(gq, par));
    const uint4* pin2 = pin1 + plane;
    if (Mode == 3) {
      for (int bt = 0; bt < n_bt; ++bt) {
        const size_t fo = ((size_t)(2 * bt + wg) * nks * 4 + w4) * 32 + lane;
        sink ^= stream_only<S>(pin1 + fo, pin2 + fo, nks);
      }
    } else if (Mode != 2) {
      float* pw = part_of(par, gq);
      for (int bt = 0; bt < n_bt; ++bt) {
        float acc_s[kAcc], acc_b[kAcc];
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc_s[i] = acc_b[i] = 0.f;
        if (Mode == 0 || Mode == 4) {
          // every warpgroup multiplies, the one with no rows too (its
          // planes are zero, its result unused): a wgmma on a divergent
          // path makes ptxas serialize them all (C7518)
          const size_t fo =
              ((size_t)(2 * bt + wg) * nks * 4 + w4) * 32 + lane;
          sm90::fence_regs(acc_s);
          sm90::fence_regs(acc_b);
          product_x3<S, Mode == 0>(acc_s, acc_b, pin1 + fo, pin2 + fo, w1s,
                                   w2s, nks);
          sm90::fence_regs(acc_s);
          sm90::fence_regs(acc_b);
        }
        // accumulator register 4j + 2hh + e: row lane/4 + 8hh of the
        // warp's 16, column 8j + 2q + e
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = row_of(bt, hh);
          if (r >= B) continue;
#pragma unroll
          for (int j = 0; j < kAcc / 4; ++j) {
            const int i = 4 * j + 2 * hh;
            *reinterpret_cast<float2*>(pw + (size_t)r * kCols + 8 * j +
                                       2 * q) =
                make_float2(acc_s[i] + acc_b[i], acc_s[i + 1] + acc_b[i + 1]);
          }
        }
      }
    }
    group_sync(gbar, 4 * ++gepoch);
  }
  if (Mode == 3 && sink == 0x9e3779b9u) dz[0] = 0.f;   // keeps the loads
}

// ---- a check of the product on its own building blocks: a [64, K]
// float32 A (one gate of dz) split into the fragment-order planes by the
// kernel's writer (put_pair, into zs), W [40, K] (40 units' rows) split
// into its resident halves by load_w_rows, the three passes over the
// k-steps as the kernel runs them (product_x3, ring depth 8); c3 gets
// the three-pass product A W^T and c1 A1 W1^T alone, both [64, 40]
__global__ void __launch_bounds__(128) lstm_bwd_bf16x3_product_check_kernel(
    const float* __restrict__ a, const float* __restrict__ w,
    float* __restrict__ c3, float* __restrict__ c1, uint32_t* zs, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  const int nchunk = n_chunks(K);
  const int nks = 4 * nchunk;
  uint8_t* w1s = smem;
  uint8_t* w2s = smem + (size_t)nchunk * kWTileBytes;
  load_w_rows(w1s, w2s, w, K, kCols, K, nchunk);
  sm90::fence_proxy_async_shared();
  const size_t plane = (size_t)nks * kFrags;         // uint4 of a plane
  uint32_t* p2 = zs + plane * 4;
  const int kp = (K + 1) / 2;
  for (int p = threadIdx.x; p < 64 * kp; p += blockDim.x) {
    const int r = p / kp;
    const int k = 2 * (p - r * kp);
    put_pair(zs, p2, frag_word(r, k, nks), a[(size_t)r * K + k],
             k + 1 < K ? a[(size_t)r * K + k + 1] : 0.f);
  }
  __threadfence();
  __syncthreads();
  const int w4 = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float acc_s[kAcc], acc_b[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc_s[i] = acc_b[i] = 0.f;
  const size_t fo = (size_t)w4 * 32 + lane;
  const uint4* z = reinterpret_cast<const uint4*>(zs);
  sm90::fence_regs(acc_s);
  sm90::fence_regs(acc_b);
  product_x3<kDefaultRing>(acc_s, acc_b, z + fo, z + plane + fo, w1s, w2s,
                           nks);
  sm90::fence_regs(acc_s);
  sm90::fence_regs(acc_b);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const size_t at = (size_t)sm90::frag_row(i, w4, lane) * kCols +
                      sm90::frag_col(i, lane);
    c3[at] = acc_s[i] + acc_b[i];
    c1[at] = acc_b[i];
  }
}

template <int Mode, int S>
cudaError_t launch_mode(void** args, int grid, size_t smem,
                        cudaStream_t stream) {
  static size_t configured = 0;
  return coop_launch((const void*)lstm_bwd_bf16x3_kernel<Mode, S>, grid,
                     smem, configured, args, stream, kThreadsX3);
}

// the launch plan at H on `sms` SMs with ring depth `stages` (0: the
// default): false where it does not fit (more blocks than SMs, or the
// weight halves past the opt-in beside kStaticReserve)
bool plan_fits(int H, int sms, int& stages) {
  if (stages == 0) stages = kDefaultRing;
  if (H <= 0 || (stages != 4 && stages != 8)) return false;
  return 4 * n_groups(H) <= sms && dyn_smem(H) + kStaticReserve <= kMaxSmem;
}

}  // namespace

// w [H, 4H], gates [B, T, 4H], cseq and dhseq [B, T, H] and dz [B, T,
// 4H] float32; peep [3H], dhT, dcT and the carries' scratch dhs, dcs [B,
// H] float32 (read only when B > 128); zs the scratch of dz's split
// planes, 4 gates x 2 parities x 2 halves x (2 ceil(B / 128) m-tiles x 4
// n_chunks(H) k-steps x 512) words, zeroed (the rows past B and the k
// past H must read 0); part the partials' scratch, 2 x 4 ceil(H / 40) x
// B x 40 floats; lens [B] int32; bar (1 + ceil(H / 40)) x 32 zeroed
// uint32 (the grid barrier, then each group's counter). `mode` 0
// computes the function; 1-4 are the floors of the file note. `stages`
// is the ring depth in k-steps, 4 or 8 (0: 8; no result depends on it).
// Returns the CUDA error of the launch (0 on success); the wrapper
// raises on anything else.
extern "C" int pt_lstm_bwd_bf16x3(const void* w, const void* peep,
                                  const void* lens, const void* gates,
                                  const void* cseq, const void* dhseq,
                                  const void* dhT, const void* dcT, void* dz,
                                  void* dhs, void* dcs, void* zs, void* part,
                                  void* bar, int B, int Tn, int H, int mode,
                                  int stages, void* stream) {
  // the grid (4 blocks per 40 units) must fit the SMs: the cooperative
  // launch refuses it otherwise
  if (B <= 0 || Tn <= 0 || mode < 0 || mode > 4 ||
      !plan_fits(H, 1 << 30, stages))
    return (int)cudaErrorInvalidValue;
  const float* w_ = static_cast<const float*>(w);
  const float* peep_ = static_cast<const float*>(peep);
  const int* lens_ = static_cast<const int*>(lens);
  const float* gates_ = static_cast<const float*>(gates);
  const float* cseq_ = static_cast<const float*>(cseq);
  const float* dhseq_ = static_cast<const float*>(dhseq);
  const float* dhT_ = static_cast<const float*>(dhT);
  const float* dcT_ = static_cast<const float*>(dcT);
  float* dz_ = static_cast<float*>(dz);
  float* dhs_ = static_cast<float*>(dhs);
  float* dcs_ = static_cast<float*>(dcs);
  uint32_t* zs_ = static_cast<uint32_t*>(zs);
  float* part_ = static_cast<float*>(part);
  unsigned int* bar_ = static_cast<unsigned int*>(bar);
  void* args[] = {&w_,  &peep_, &lens_, &gates_, &cseq_, &dhseq_,
                  &dhT_, &dcT_, &dz_,  &dhs_,   &dcs_,  &zs_,
                  &part_, &bar_, &B,   &Tn,     &H};
  const int grid = 4 * n_groups(H);
  const size_t smem = dyn_smem(H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (mode == 0)
    e = stages == 4 ? launch_mode<0, 4>(args, grid, smem, st)
                    : launch_mode<0, 8>(args, grid, smem, st);
  else if (mode == 1)
    e = launch_mode<1, 8>(args, grid, smem, st);
  else if (mode == 2)
    e = launch_mode<2, 8>(args, grid, smem, st);
  else if (mode == 3)
    e = stages == 4 ? launch_mode<3, 4>(args, grid, smem, st)
                    : launch_mode<3, 8>(args, grid, smem, st);
  else
    e = launch_mode<4, 8>(args, grid, smem, st);
  return (int)e;
}

// The plan of ops/fused_rnn.py lstm_bwd_bf16x3_plan, from this file's
// layout: out[0..5] = units a block owns, blocks, dynamic shared bytes,
// ring depth, k-steps of the product (4 n_chunks), and the kernel's
// static shared bytes. Returns 0, or cudaErrorInvalidValue where the plan
// does not fit (out untouched).
extern "C" int pt_lstm_bwd_bf16x3_plan(int H, int sms, int stages,
                                       int* out) {
  if (!plan_fits(H, sms, stages)) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(
      &attr, (const void*)lstm_bwd_bf16x3_kernel<0, kDefaultRing>);
  if (e != cudaSuccess) return (int)e;
  out[0] = kUnits;
  out[1] = 4 * n_groups(H);
  out[2] = (int)dyn_smem(H);
  out[3] = stages;
  out[4] = 4 * n_chunks(H);
  out[5] = (int)attr.sharedSizeBytes;
  return 0;
}

// a [64, K] and w [40, K] float32 row-major (0 < K <= 1024); c3, c1 [64,
// 40] float32 (see the check kernel); zs a zeroed scratch of 2 x 4
// n_chunks(K) x 512 words
extern "C" int pt_lstm_bwd_bf16x3_product_check(const void* a, const void* w,
                                                void* c3, void* c1, void* zs,
                                                int K, void* stream) {
  if (K <= 0 || K > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = dyn_smem(K);
  const void* kern = (const void*)lstm_bwd_bf16x3_product_check_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  lstm_bwd_bf16x3_product_check_kernel<<<1, 128, smem,
                                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(w),
      static_cast<float*>(c3), static_cast<float*>(c1),
      static_cast<uint32_t*>(zs), K);
  return (int)cudaGetLastError();
}

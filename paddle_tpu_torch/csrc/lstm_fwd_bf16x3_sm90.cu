// Fused LSTM sequence forward for Hopper's tensor cores (sm_90a),
// float32, its product as three bf16 passes.
//
// Replaces: paddle_tpu/ops/pallas_rnn.py:_lstm_kernel (launched by
// _lstm_fwd_call, public lstm_sequence) for float32 weights; bfloat16
// takes lstm_fwd_sm90.cu. Same function: for each step t
//   z = x4[:, t] + h_{t-1} @ W + bias             (gates [i, f, c~, o])
//   i = sig(zi + pi*c), f = sig(zf + pf*c), c~ = tanh(zc)
//   c' = f*c + i*c~,    o = sig(zo + po*c'),  h' = o*tanh(c')
// with the ragged rule valid = t < lens[r]: an invalid step freezes h
// and c and writes 0 to out, and the final state is the last valid
// step's. With residuals (the training call) it also writes the frozen
// c sequence and the activated gates. Everything is float32 (x4, W,
// out, cseq, gates, hT, cT, bias, peepholes, the gate math and the
// carries) except inside the product, which runs as
//   h @ W ~= (h1 @ W2 + h2 @ W1) + h1 @ W1,
//   W1 = bf16(W), W2 = bf16(W - W1), h1 = bf16(h), h2 = bf16(h - h1)
// (round to nearest even): three bf16 wgmma passes with float32
// accumulation, the split XLA uses for float32 on bf16 units ("bf16_3x",
// Precision.HIGH). The dropped h2 @ W2 and the halves' own rounding
// leave about 2^-16 of each product; the two small passes go into their
// own accumulator, so that the tensor cores' rounding of each k-step's
// sum toward zero happens at the small passes' magnitude, not the
// product's (the lesson of flash_dkv_tf32_sm90.cu).
//
// What bounds it on an H100: at B 128, H 1280 and 100 valid steps the
// three passes are 3 * 2*B*H*4H*100 = 503 GFLOP (0.509 ms at the bf16
// tensor cores' 989 TFLOP/s) against about 0.86 GB of float32 streams
// (0.26 ms at 3.35 TB/s): operation-bound. The plan adds what the bound
// does not count: every step every block reads both bf16 halves of
// h_{t-1} ([128, 1280] each, 655 KB) from L2 — 84 MB a step over 128
// blocks — and one grid barrier a step.
//
// Design: the persistent, weight-stationary plan of lstm_fwd_sm90.cu,
// with the weight held whole on chip in two bf16 halves:
//   - One cooperative launch; block x owns kUnits = 10 hidden units
//     [10x, 10x + 10) (128 blocks at H 1280) and keeps their 40 weight
//     columns W[:, g*H + j] as W1 and W2, each as K-major [40 n x 64 k]
//     tiles in the 128-byte swizzle (2 x 20 x 5120 B = 200 KB at H
//     1280; split and written once by the block's threads, then a proxy
//     fence): the B operands of wgmma m64n40k16. Sixteen units (N 64,
//     lstm_fwd_sm90.cu's layout) would need 320 KB.
//   - The A operand comes from registers (wgmma RS), loaded straight
//     from global memory: beside the weight only ~22 KB of shared
//     memory is left, too little for a TMA ring worth having, and
//     generic loads need no producer warp, no mbarrier wait between the
//     products and no cross-proxy fence. h_{t-1} lives in a scratch of
//     bf16 planes, double-buffered by step parity, one per half, each
//     in the A fragment order: [64-row m-tile][k-step of 16][warp][lane]
//     x 16 bytes, so one warp's loads of a k-step are 512 contiguous
//     bytes and a thread loads its m64k16 fragment as one uint4. A
//     ring of S k-steps of fragments (S 8, or 4 for a sweep) in each
//     consumer thread's registers: the loads of k-step ks + S - 1 go out
//     as soon as the products of k-step ks - 1 are done (one commit
//     group in flight), S - 1 k-steps ahead of their use. The loads go
//     through L2 (ld.global.cg): other blocks wrote the planes in this
//     launch.
//   - Two consumer warpgroups of 64 batch rows each (batch tiles of
//     128); per k-step the small passes (h1 W2, h2 W1) first, into one
//     accumulator, then h1 W1 into another; the two are added in float32
//     after the last k-step.
//   - Columns: the accumulator's fragment map (sm90_pipeline.cuh) puts
//     columns 8j + 2q + e in lane slot q (q = lane % 4) of both row
//     halves. Pairs j 0-3 hold units 2q and 2q+1, gates (i, f) then
//     (c~, o), so that thread owns those two units of both its rows;
//     pair 4 holds unit 8 + q/2, gates (i, f) in even slots and (c~, o)
//     in odd ones. That unit's gates meet by one exchange between lanes
//     q and q^1 (two shuffles): the even lane runs its upper row, the
//     odd lane its lower. Each thread runs the gate math of 5 (row,
//     unit) cells in registers and keeps their c and h carries there
//     for the whole sequence (in hT / cT, owner-only, when B > 128 takes
//     several batch tiles).
//   - End of a step: each thread writes h_keep (the frozen h for an
//     invalid step: the next product reads it) already split, h1 and
//     h2, into the other parity's planes (a 32-bit word a plane for its
//     unit pair, adjacent in the fragment order), and the block arrives
//     at the grid barrier (rnn_common.cuh grid_arrive); only then does
//     it load the next step's x4 and lengths and store out, cseq and
//     gates (no block reads them), and then waits for the others
//     (grid_wait). A plane is rewritten two steps later, after every
//     block has passed the barrier that ends its reads.
// hT and cT come from the float32 carries, never from the planes.
// Steps past the longest row are not run; their outputs are written as
// 0 (cseq: the frozen c, gates: 0) after one more grid barrier, by the
// whole grid a (row, step) at a time, so that each row is written whole. `Mode` 1 runs the steps with no product
// (x4 loads, gate math, stores, barrier), 2 the barriers alone, 3 the h
// stream alone (the loads of both planes, no product, no gate math, no
// stores), 4 the steps with the products but no h stream (each step's
// first S k-steps of fragments, loaded once, reused): the per-step
// floors of this plan (timed by chip_smoke.py; their results are not
// the function). Mode and S are template constants, so no wgmma sits
// under a runtime branch.
//
// Build: as lstm_bwd_bf16x3_sm90.cu.

#include "lstm_bf16x3.cuh"

namespace {

using namespace rnn;
using namespace bf16x3;

// the gate g and unit u of tile column n (see the file note): pairs j
// 0-3 of lane slot q hold units 2q, 2q+1, gates (i, f) then (c~, o);
// pair 4 gates (i, f) (q even) or (c~, o) (q odd) of unit 8 + q/2
__device__ __forceinline__ void col_gate_unit(int n, int& g, int& u) {
  const int j = n >> 3, q = (n & 7) >> 1, e = n & 1;
  if (j < 4) {
    u = 2 * q + (j >> 1);
    g = 2 * (j & 1) + e;
  } else {
    u = 8 + (q >> 1);
    g = 2 * (q & 1) + e;
  }
}

// The block's weight columns split into W1 = bf16(w) and W2 = bf16(w -
// W1), as K-major tiles of 64 k: tile c, row n holds w[k, g * gs + j0 +
// u] ((g, u) = col_gate_unit(n)) for k in [64c, 64c + 64), with w of
// row pitch ldw and K rows; units past uu and k past K are zero. Generic
// stores: the caller fences the async proxy before a wgmma reads them.
__device__ void load_w_halves(uint8_t* w1s, uint8_t* w2s, const float* w,
                              int K, size_t ldw, int gs, int j0, int uu,
                              int nchunk) {
  const int total = nchunk * 8 * kCols;      // 16-byte groups of a half
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int n = idx % kCols;
    const int g8 = (idx / kCols) & 7;
    const int c = idx / (8 * kCols);
    int g, u;
    col_gate_unit(n, g, u);
    const int k0 = c * kChunk + g8 * 8;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (u < uu) {
      const size_t col = (size_t)g * gs + j0 + u;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (k0 + i < K) v[i] = __ldg(w + (size_t)(k0 + i) * ldw + col);
    }
    put_w8(w1s, w2s, c * kWTileBytes + wtile_off(n, g8 * 8), v);
  }
}

template <int Mode, int S>
__global__ void __launch_bounds__(kThreadsX3, 1) lstm_fwd_bf16x3_kernel(
    const float* __restrict__ x4, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ peep,
    const int* __restrict__ lens, float* __restrict__ out,
    float* __restrict__ cseq, float* __restrict__ gates,
    float* __restrict__ hT, float* __restrict__ cT, uint32_t* hs,
    unsigned int* bar, int B, int Tn, int H) {
  extern __shared__ uint8_t smem_raw[];
  // bias (4 gates) and peepholes (3) of the block's units, read by the
  // threads as broadcasts
  __shared__ float bp[7][kUnits];
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
  const int j0 = blockIdx.x * kUnits;
  const int uu = min(kUnits, H - j0);
  const size_t H4 = 4 * (size_t)H;
  const int n_bt = (B + kBatchTile - 1) / kBatchTile;
  const bool res = cseq != nullptr;
  const bool even = (H & 1) == 0;   // unit pairs are 8-byte aligned
  // how many of the thread's unit pair (2q, 2q + 1) the block owns
  const int npair = max(0, min(2, uu - 2 * q));
  // uint4 of one plane: 2 n_bt m-tiles x nks k-steps x kFrags
  const size_t plane = (size_t)2 * n_bt * nks * kFrags;

  if (Mode == 0 || Mode == 4) {
    load_w_halves(w1s, w2s, w, H, H4, H, j0, uu, nchunk);
    sm90::fence_proxy_async_shared();
  }
  if (tid < 7 * kUnits) {
    const int g = tid / kUnits;
    const int u = tid % kUnits;
    bp[g][u] = u >= uu ? 0.f
               : g < 4 ? bias[g * H + j0 + u] : peep[(g - 4) * H + j0 + u];
  }

  // the thread's cells: c < 4 row half c / 2, unit 2q + c % 2; cell 4
  // unit 8 + q / 2 in row half q % 2
  auto cell_hh = [&](int c) { return c < 4 ? (c >> 1) : (q & 1); };
  auto cell_u = [&](int c) { return c < 4 ? 2 * q + (c & 1) : 8 + (q >> 1); };
  auto row_of = [&](int bt, int hh) {
    return bt * kBatchTile + 64 * wg + 16 * w4 + lane / 4 + 8 * hh;
  };
  // the float32 carries of one batch tile (of the only one when n_bt is
  // 1; else hT / cT hold them between tiles)
  float hc[kCells], cc[kCells];
#pragma unroll
  for (int c = 0; c < kCells; ++c) hc[c] = cc[c] = 0.f;
  if (n_bt > 1) {
    for (int bt = 0; bt < n_bt; ++bt)
#pragma unroll
      for (int c = 0; c < kCells; ++c) {
        const int r = row_of(bt, cell_hh(c));
        if (r < B && cell_u(c) < uu) {
          hT[(size_t)r * H + j0 + cell_u(c)] = 0.f;
          cT[(size_t)r * H + j0 + cell_u(c)] = 0.f;
        }
      }
  }
  // x4 of step t for the thread's cells of tile bt, and the two rows'
  // lengths (0 past B)
  float xr[kCells][4];
  int xl[2];
  auto load_x = [&](int bt, int t) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row_of(bt, hh);
      const bool rv = r < B;
      xl[hh] = rv ? __ldg(lens + r) : 0;
      const int n = rv ? npair : 0;
      const float* xrow =
          x4 + ((size_t)(rv ? r : 0) * Tn + t) * H4 + j0 + 2 * q;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float2 v = ld_pair(xrow + g * H, n, even && n == 2);
        xr[2 * hh][g] = v.x;
        xr[2 * hh + 1][g] = v.y;
      }
    }
    const int r = row_of(bt, cell_hh(4));
    const bool ok = r < B && cell_u(4) < uu;
    const float* xrow =
        x4 + ((size_t)(ok ? r : 0) * Tn + t) * H4 + j0 + cell_u(4);
#pragma unroll
    for (int g = 0; g < 4; ++g) xr[4][g] = ok ? __ldg(xrow + g * H) : 0.f;
  };
  // the residuals of the last tile of a step: stored after the block
  // arrives at the step's barrier
  float rout[kCells], rcs[kCells], rga[kCells][4];
  auto store_res = [&](int bt, int t) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row_of(bt, hh);
      if (r >= B || npair == 0) continue;
      const size_t srow = (size_t)r * Tn + t;
      const int j = j0 + 2 * q;
      const bool pair = even && npair == 2;
      const int a = 2 * hh;
      st_pair(out + srow * H + j, rout[a], rout[a + 1], npair, pair);
      if (res) {
        st_pair(cseq + srow * H + j, rcs[a], rcs[a + 1], npair, pair);
#pragma unroll
        for (int g = 0; g < 4; ++g)
          st_pair(gates + srow * H4 + g * H + j, rga[a][g], rga[a + 1][g],
                  npair, pair);
      }
    }
    const int r = row_of(bt, cell_hh(4));
    if (r < B && cell_u(4) < uu) {
      const size_t srow = (size_t)r * Tn + t;
      const int j = j0 + cell_u(4);
      out[srow * H + j] = rout[4];
      if (res) {
        cseq[srow * H + j] = rcs[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) gates[srow * H4 + g * H + j] = rga[4][g];
      }
    }
  };
  const int t_end = steps_to_run(lens, B, Tn);      // syncs the block
  if (Mode != 2 && Mode != 3 && t_end > 0) load_x(0, 0);

  unsigned int epoch = 0;
  uint32_t sink = 0u;
  for (int t = 0; t < t_end; ++t) {
    const int par = t & 1;                   // the planes of h_{t-1}
    const uint4* hin1 = reinterpret_cast<const uint4*>(hs) + 2 * par * plane;
    const uint4* hin2 = hin1 + plane;
    uint32_t* hout1 = hs + (size_t)2 * (par ^ 1) * plane * 4;
    uint32_t* hout2 = hout1 + plane * 4;
    if (Mode == 3) {
      for (int bt = 0; bt < n_bt; ++bt) {
        const size_t fo = ((size_t)(2 * bt + wg) * nks * 4 + w4) * 32 + lane;
        sink ^= stream_only<S>(hin1 + fo, hin2 + fo, nks);
      }
    } else if (Mode != 2) {
      for (int bt = 0; bt < n_bt; ++bt) {
        if (bt > 0) load_x(bt, t);
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
          product_x3<S, Mode == 0>(acc_s, acc_b, hin1 + fo, hin2 + fo, w1s,
                                   w2s, nks);
          sm90::fence_regs(acc_s);
          sm90::fence_regs(acc_b);
        }
        float zc[kAcc];
#pragma unroll
        for (int i = 0; i < kAcc; ++i) zc[i] = acc_s[i] + acc_b[i];
        // unit 8 + q/2: the even lane keeps (i, f) of both rows and takes
        // (c~, o) of the upper row from its odd neighbour, which takes
        // (i, f) of the lower row
        const bool odd = (q & 1) != 0;
        const float s0 = odd ? zc[16] : zc[18];
        const float s1 = odd ? zc[17] : zc[19];
        const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
        float z[kCells][4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int uo = 0; uo < 2; ++uo) {
            const int base = 8 * uo + 2 * hh;
            z[2 * hh + uo][0] = zc[base];
            z[2 * hh + uo][1] = zc[base + 1];
            z[2 * hh + uo][2] = zc[base + 4];
            z[2 * hh + uo][3] = zc[base + 5];
          }
        z[4][0] = odd ? r0 : zc[16];
        z[4][1] = odd ? r1 : zc[17];
        z[4][2] = odd ? zc[18] : r0;
        z[4][3] = odd ? zc[19] : r1;
        // the gate math in registers; rows past B compute as frozen rows
        // and store nothing
        if (n_bt > 1) {
#pragma unroll
          for (int c = 0; c < kCells; ++c) {
            const int r = row_of(bt, cell_hh(c));
            if (r < B && cell_u(c) < uu) {
              const size_t s = (size_t)r * H + j0 + cell_u(c);
              hc[c] = hT[s];
              cc[c] = cT[s];
            }
          }
        }
#pragma unroll
        for (int c = 0; c < kCells; ++c) {
          const int u = cell_u(c);
          // (a select, not an index: cell 4's row half is q % 2)
          const bool valid = t < (cell_hh(c) ? xl[1] : xl[0]);
          const float cp = cc[c];
          const float zi = xr[c][0] + z[c][0] + bp[0][u];
          const float zf = xr[c][1] + z[c][1] + bp[1][u];
          const float zg = xr[c][2] + z[c][2] + bp[2][u];
          const float zo = xr[c][3] + z[c][3] + bp[3][u];
          const float ig = sigmoid_fd(zi + bp[4][u] * cp);
          const float fg = sigmoid_fd(zf + bp[5][u] * cp);
          const float cand = tanhf(zg);
          const float cn = fg * cp + ig * cand;
          const float og = sigmoid_fd(zo + bp[6][u] * cn);
          const float hn = og * tanhf(cn);
          rout[c] = valid ? hn : 0.f;
          hc[c] = valid ? hn : hc[c];
          cc[c] = valid ? cn : cp;
          rcs[c] = cc[c];
          rga[c][0] = ig;
          rga[c][1] = fg;
          rga[c][2] = cand;
          rga[c][3] = og;
        }
        // h_keep split into the next step's planes: frozen rows keep h
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = row_of(bt, hh);
          if (r < B && 2 * q < uu)
            put_pair(hout1, hout2, frag_word(r, j0 + 2 * q, nks),
                     hc[2 * hh], 2 * q + 1 < uu ? hc[2 * hh + 1] : 0.f);
        }
        {
          const int r = row_of(bt, cell_hh(4));
          const int k = j0 + cell_u(4);
          if (r < B && cell_u(4) < uu)
            put_one(hout1, hout2, frag_word(r, k & ~1, nks), k, hc[4]);
        }
        if (n_bt > 1) {
#pragma unroll
          for (int c = 0; c < kCells; ++c) {
            const int r = row_of(bt, cell_hh(c));
            if (r < B && cell_u(c) < uu) {
              const size_t s = (size_t)r * H + j0 + cell_u(c);
              hT[s] = hc[c];
              cT[s] = cc[c];
            }
          }
        }
        if (bt + 1 < n_bt) store_res(bt, t);
      }
    }
    // the others wait only for the planes: the next step's x4 loads and
    // the last tile's residuals go between arriving and waiting (the
    // loads first: issued behind the stores they reach the next step's
    // gate math later)
    grid_arrive(bar);
    if (Mode != 2 && Mode != 3) {
      if (t + 1 < t_end) load_x(0, t + 1);
      store_res(n_bt - 1, t);
    }
    grid_wait(bar, ++epoch);
  }
  if (Mode == 3 && sink == 0x9e3779b9u) hT[0] = 0.f;   // keeps the loads

  // final state from the carries
  if (n_bt == 1) {
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      const int r = row_of(0, cell_hh(c));
      if (r < B && cell_u(c) < uu) {
        const size_t s = (size_t)r * H + j0 + cell_u(c);
        hT[s] = hc[c];
        cT[s] = cc[c];
      }
    }
  }
  if (t_end == Tn) return;
  // the steps past the longest row: once every block's final c is in cT,
  // any block can write any (row, step) of them, so the grid writes them
  // a row at a time, whole rows of out, cseq and gates with 16-byte
  // stores (each block writing the 40-byte pieces of its own 10 units,
  // as the steps do, was several times slower)
  grid_sync(bar, ++epoch);
  const int tail = Tn - t_end;
  const bool vec = (H & 3) == 0;
  for (int i = blockIdx.x; i < B * tail; i += gridDim.x) {
    const int r = i / tail;
    const size_t srow = (size_t)r * Tn + t_end + (i - r * tail);
    const float* crow = cT + (size_t)r * H;
    if (vec) {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      float4* o = reinterpret_cast<float4*>(out + srow * H);
      for (int k = tid; k < H / 4; k += blockDim.x) o[k] = zero;
      if (res) {
        float4* cs = reinterpret_cast<float4*>(cseq + srow * H);
        const float4* cr = reinterpret_cast<const float4*>(crow);
        for (int k = tid; k < H / 4; k += blockDim.x) cs[k] = __ldcg(cr + k);
        float4* ga = reinterpret_cast<float4*>(gates + srow * H4);
        for (int k = tid; k < H; k += blockDim.x) ga[k] = zero;
      }
    } else {
      for (int k = tid; k < H; k += blockDim.x) out[srow * H + k] = 0.f;
      if (res) {
        for (int k = tid; k < H; k += blockDim.x)
          cseq[srow * H + k] = __ldcg(crow + k);
        for (int k = tid; k < 4 * H; k += blockDim.x)
          gates[srow * H4 + k] = 0.f;
      }
    }
  }
}

// ---- a check of the product on its own building blocks: a [64, K]
// float32 A split into the fragment-order planes by the kernel's writer
// (put_pair, into hs), W [K, 40] (gate stride 10) split into its
// resident halves by load_w_halves, the three passes over the k-steps as
// the kernel runs them (product_x3, ring depth 8); c3 gets the
// three-pass product and c1 h1 W1 alone, both at W's columns
__global__ void __launch_bounds__(128) lstm_fwd_bf16x3_product_check_kernel(
    const float* __restrict__ a, const float* __restrict__ w,
    float* __restrict__ c3, float* __restrict__ c1, uint32_t* hs, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  const int nchunk = n_chunks(K);
  const int nks = 4 * nchunk;
  uint8_t* w1s = smem;
  uint8_t* w2s = smem + (size_t)nchunk * kWTileBytes;
  load_w_halves(w1s, w2s, w, K, kCols, kUnits, 0, kUnits, nchunk);
  sm90::fence_proxy_async_shared();
  const size_t plane = (size_t)nks * kFrags;         // uint4 of a plane
  uint32_t* p2 = hs + plane * 4;
  const int kp = (K + 1) / 2;
  for (int p = threadIdx.x; p < 64 * kp; p += blockDim.x) {
    const int r = p / kp;
    const int k = 2 * (p - r * kp);
    put_pair(hs, p2, frag_word(r, k, nks), a[(size_t)r * K + k],
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
  const uint4* h = reinterpret_cast<const uint4*>(hs);
  sm90::fence_regs(acc_s);
  sm90::fence_regs(acc_b);
  product_x3<kDefaultRing>(acc_s, acc_b, h + fo, h + plane + fo, w1s, w2s,
                           nks);
  sm90::fence_regs(acc_s);
  sm90::fence_regs(acc_b);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    int g, u;
    col_gate_unit(sm90::frag_col(i, lane), g, u);
    const size_t at =
        (size_t)sm90::frag_row(i, w4, lane) * kCols + g * kUnits + u;
    c3[at] = acc_s[i] + acc_b[i];
    c1[at] = acc_b[i];
  }
}

template <int Mode, int S>
cudaError_t launch_mode(void** args, int grid, size_t smem,
                        cudaStream_t stream) {
  static size_t configured = 0;
  return coop_launch((const void*)lstm_fwd_bf16x3_kernel<Mode, S>, grid,
                     smem, configured, args, stream, kThreadsX3);
}

// the launch plan at H on `sms` SMs with ring depth `stages` (0: the
// default): false where it does not fit (more blocks than SMs, or the
// weight halves past the opt-in beside kStaticReserve)
bool plan_fits(int H, int sms, int& stages) {
  if (stages == 0) stages = kDefaultRing;
  if (H <= 0 || (stages != 4 && stages != 8)) return false;
  return (H + kUnits - 1) / kUnits <= sms &&
         dyn_smem(H) + kStaticReserve <= kMaxSmem;
}

}  // namespace

// x4 [B, T, 4H], w [H, 4H], out, cseq [B, T, H] and gates [B, T, 4H]
// float32 (cseq and gates null: no residuals); bias [4H], peep [3H], hT
// and cT [B, H] float32; hs the scratch of h's split planes, 2 parities
// x 2 halves x (2 ceil(B / 128) m-tiles x 4 n_chunks(H) k-steps x 512)
// words, zeroed (h_{-1} = 0); lens [B] int32; bar one zeroed uint32.
// `mode` 0 computes the function; 1, 2 and 3 are the floors of the file
// note. `stages` is the ring depth in k-steps, 4 or 8 (0: 8; no result
// depends on it). Returns the CUDA error of the launch (0 on success);
// the wrapper raises on anything else.
extern "C" int pt_lstm_fwd_bf16x3(const void* x4, const void* w,
                                  const void* bias, const void* peep,
                                  const void* lens, void* out, void* cseq,
                                  void* gates, void* hT, void* cT, void* hs,
                                  void* bar, int B, int Tn, int H, int mode,
                                  int stages, void* stream) {
  // the grid (one block per 10 units) must fit the SMs: the cooperative
  // launch refuses it otherwise
  if (B <= 0 || Tn <= 0 || mode < 0 || mode > 4 ||
      (cseq == nullptr) != (gates == nullptr) || !plan_fits(H, 1 << 30, stages))
    return (int)cudaErrorInvalidValue;
  const float* x4_ = static_cast<const float*>(x4);
  const float* w_ = static_cast<const float*>(w);
  const float* bias_ = static_cast<const float*>(bias);
  const float* peep_ = static_cast<const float*>(peep);
  const int* lens_ = static_cast<const int*>(lens);
  float* out_ = static_cast<float*>(out);
  float* cseq_ = static_cast<float*>(cseq);
  float* gates_ = static_cast<float*>(gates);
  float* hT_ = static_cast<float*>(hT);
  float* cT_ = static_cast<float*>(cT);
  uint32_t* hs_ = static_cast<uint32_t*>(hs);
  unsigned int* bar_ = static_cast<unsigned int*>(bar);
  void* args[] = {&x4_, &w_,   &bias_, &peep_, &lens_, &out_, &cseq_,
                  &gates_, &hT_, &cT_, &hs_, &bar_, &B, &Tn, &H};
  const int grid = (H + kUnits - 1) / kUnits;
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

// The plan of ops/fused_rnn.py lstm_fwd_bf16x3_plan, from this file's
// layout: out[0..5] = units a block, blocks, dynamic shared bytes, ring
// depth, k-steps of the product (4 n_chunks), and the kernel's static
// shared bytes. Returns 0, or cudaErrorInvalidValue where the plan does
// not fit (out untouched).
extern "C" int pt_lstm_fwd_bf16x3_plan(int H, int sms, int stages,
                                       int* out) {
  if (!plan_fits(H, sms, stages)) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(
      &attr, (const void*)lstm_fwd_bf16x3_kernel<0, kDefaultRing>);
  if (e != cudaSuccess) return (int)e;
  out[0] = kUnits;
  out[1] = (H + kUnits - 1) / kUnits;
  out[2] = (int)dyn_smem(H);
  out[3] = stages;
  out[4] = 4 * n_chunks(H);
  out[5] = (int)attr.sharedSizeBytes;
  return 0;
}

// a [64, K] and w [K, 40] float32 row-major (0 < K <= 1024); c3, c1 [64,
// 40] float32 (see the check kernel); hs a zeroed scratch of 2 x 4
// n_chunks(K) x 512 words
extern "C" int pt_lstm_fwd_bf16x3_product_check(const void* a, const void* w,
                                                void* c3, void* c1, void* hs,
                                                int K, void* stream) {
  if (K <= 0 || K > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = dyn_smem(K);
  const void* kern = (const void*)lstm_fwd_bf16x3_product_check_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  lstm_fwd_bf16x3_product_check_kernel<<<1, 128, smem,
                                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(w),
      static_cast<float*>(c3), static_cast<float*>(c1),
      static_cast<uint32_t*>(hs), K);
  return (int)cudaGetLastError();
}

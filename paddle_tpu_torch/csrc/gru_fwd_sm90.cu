// Fused GRU sequence forward for Hopper (sm_90a): batch rows split
// across blocks, or thread-block clusters, that hold the whole
// recurrent weight on chip. No grid barrier.
//
// Replaces: paddle_tpu/ops/pallas_rnn.py:_gru_kernel (launched by
// _gru_call, public gru_sequence when no gradient is taken). Same
// function as gru_fwd.cu, gates [z, r, c~]: for each step t
//   [zz, zr] = x3[:, t, :2H] + round(h) @ W[:, :2H] + b[:2H]
//   z = sig(zz), r = sig(zr)
//   c~ = x3[:, t, 2H:] + round(r*h) @ W[:, 2H:] + b[2H:]
//   h' = (1-z)*h + z*tanh(c~)
// with valid = t < lens[row] (an invalid step freezes h and writes 0;
// hT is the last valid state). round is to the product dtype T
// (float32 or bfloat16); the carries and all gate math are float32.
//
// Design. A GRU's batch rows are independent, so nothing needs a
// grid-wide barrier: a cluster of n blocks (n in 1, 2, 4, 8) owns R
// batch rows (R in 1, 2, 4; ops/fused_rnn.py gru_fwd_plan picks n and R
// by shape) and
// runs them through the whole sequence on its own. Block q of the
// cluster owns the U = ceil(H / n) (rounded up to 4) hidden units
// [q*U, q*U + U) and holds their z, r and c~ columns of W, a [H, 3U]
// slice in the product dtype, on chip for the whole launch: in shared
// memory, row-major, and the first rows of each thread's part again in
// registers (at the tagger's h 128 all of them). Every block keeps the
// R rows of round(h) and round(r*h) over all H units in shared memory.
// A product gives each thread a quad of 4 columns and one of S slices
// of k; the S lanes of a quad are one warp's and meet by shuffles, and
// the lane that holds a (row, column) sum does its gate math at once:
//   (A) z and r of the owned units from round(h); z stays in the block,
//       round(r*h) of the owned units goes into every block of the
//       cluster (distributed shared memory); a barrier: __syncthreads
//       when n is 1, the cluster's barrier otherwise;
//   (B) c~ of the owned units from round(r*h), the new h, out written
//       from registers, round(h) into every block of the cluster; the
//       second barrier.
// x3[:, t + 2] of the block's rows and units is staged by cp.async
// while step t computes. A cluster runs only to the longest length
// among its own rows, then writes the zero tail; hT is written once.
// Clusters are independent, so the launch is a plain one: they need
// not be resident at once.
//
// What bounds it on an H100: at the tagger's shapes (B 64, H 128, T
// 64, float32) the whole call is 3.5 us of float32 FMAs and 1.6 us of
// bytes, but the chain of T dependent steps sets its time, and with
// one 8-warp block a row a step is latency: the two products (register
// FMA chains, h broadcasts, shuffles), two rounds of gate math and two
// barriers, plus the issue of the staging copies. chip_smoke.py times
// the floors (mode 1, mode 2) and every (n, R) where the plan picks
// n > 1 or R > 1: a cluster's barrier costs more than the shared-memory
// traffic it divides, so at h 128 one block a row is fastest; a cluster
// shares its barrier among R rows, so there 2-4 rows pay, while at n 1
// rows take the registers that hold the weight.
//
// mode 0 computes the function; mode 1 stops after the weight load
// (the launch-and-load floor), mode 2 runs the steps without their
// products (barriers, gate math, x3 loads, out stores): floors that
// chip_smoke.py times, whose outputs are not the function.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (ops/_build.py); plain C entry, loaded by ctypes.

#include <cooperative_groups.h>

#include <atomic>

#include "rnn_common.cuh"

namespace cg = cooperative_groups;

namespace {

using rnn::round_to;
using rnn::round_up;
using rnn::sigmoid;
using rnn::to_f;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlices = 8;          // lanes a column quad's k is split in
constexpr int kStages = 3;             // x3 stage buffers: t, t+1, t+2
constexpr int kMaxSmem = 226 * 1024;   // under the opt-in beside static words

// Byte offsets of the block's shared memory (mirrored by
// ops/fused_rnn.py _gru_sm90_smem): the weight slice [kpad][3U] in T,
// round(h) and round(r*h) [R][kph] (skewed, see hpos), the owned units'
// exact h and z [R][U], the bias slice [3U], the x3 stages
// [kStages][R][3][wseg] 4-byte words, then the row lengths and the step
// count.
struct Layout {
  int U, kpad, kph, wseg;
  int w, hb, rb, hown, zs, bias, xs, lens, total;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout layout(int H, int n, int R, int esize) {
  Layout L;
  L.U = round_up((H + n - 1) / n, 4);
  L.kpad = round_up(H, 4);
  L.kph = L.kpad + 4 * ((L.kpad + 15) / 16);
  const int E = 4 / esize;                         // elements a word
  // + a leading straddle, rounded to 16 bytes
  L.wseg = round_up((L.U + E - 1) / E + (E - 1), 4);
  int off = 0;
  L.w = off;    off = align16(off + L.kpad * 3 * L.U * esize);
  L.hb = off;   off = align16(off + R * L.kph * 4);
  L.rb = off;   off = align16(off + R * L.kph * 4);
  L.hown = off; off = align16(off + R * L.U * 4);
  L.zs = off;   off = align16(off + R * L.U * 4);
  L.bias = off; off = align16(off + 3 * L.U * 4);
  L.xs = off;   off = align16(off + kStages * R * 3 * L.wseg * 4);
  L.lens = off; off = align16(off + (R + 1) * 4);
  L.total = off;
  return L;
}

// Where element k of a round(h) / round(r*h) row lies: 4 words of skew
// every 16, so that the k slices of one warp, which read the row at
// different k at once, start on different banks.
__device__ __forceinline__ int hpos(int k) { return k + ((k >> 4) << 2); }

// four consecutive weights as float32 (16 or 8 aligned bytes)
__device__ __forceinline__ float4 quad_f(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 quad_f(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// 4 bytes global -> shared, of which the first src_bytes are read and
// the rest zero-filled
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the barrier of the block's group: the block alone, or its cluster
__device__ __forceinline__ void group_sync(int n) {
  if (n > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// v into the same shared-memory word of every block of the cluster
__device__ __forceinline__ void bcast(float* local, float v, int n) {
  if (n == 1) {
    *local = v;
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  for (int q = 0; q < n; ++q) *cluster.map_shared_rank(local, q) = v;
}

// Lanes a column quad's k range is split in: the largest power of two
// up to kMaxSlices with quads * S <= kThreads (one quad a thread).
__host__ __device__ __forceinline__ int slices(int quads) {
  int s = 1;
  while (s < kMaxSlices && 2 * s * quads <= kThreads) s *= 2;
  return s;
}

// Weight rows a thread keeps in registers, per product (A: z and r,
// B: the candidate), a multiple of 4: the first ones of its k slice. At
// R = 1 that is 32 + 16 rows of 4 columns, 192 registers: at the
// tagger's h 128 the whole weight (the slices are 32 and 16 rows long),
// so its products read only h from shared memory. Fewer with more rows
// R, whose accumulators need the room.
template <int R>
struct RegRows {
  static_assert(R == 1 || R == 2 || R == 4, "1, 2 or 4 rows a cluster");
  static constexpr int A = 32 / R;
  static constexpr int B = A / 2;
};

// A thread's part of a product over `quads` column quads: warp w takes
// quads [w*L, w*L + L), L = 32 / S; lane l takes quad w*L + l % L and k
// slice s = l / L, rows [k0, k1). The S lanes of a quad are one warp's,
// so their sums meet by shuffles.
struct Item {
  int q, s, S, L, k0, k1;
  bool live;
};

__device__ __forceinline__ Item item_of(int quads, int kpad) {
  Item it;
  it.S = slices(quads);
  it.L = 32 / it.S;
  const int lane = threadIdx.x & 31;
  it.s = lane / it.L;
  it.q = (threadIdx.x >> 5) * it.L + lane - it.s * it.L;
  it.live = it.q < quads;
  const int kc = round_up((kpad + it.S - 1) / it.S, 4);
  it.k0 = min(kpad, it.s * kc);
  it.k1 = it.live ? min(kpad, it.k0 + kc) : it.k0;
  return it;
}

// the item's first KR weight rows (zero past k1), from shared memory
template <typename T, int KR>
__device__ __forceinline__ void load_rows(const T* Ws, int P, int c0,
                                          const Item& it,
                                          float (&wr)[KR][4]) {
#pragma unroll
  for (int kk = 0; kk < KR; ++kk) {
    const float4 v = it.k0 + kk < it.k1
                         ? quad_f(Ws + (size_t)(it.k0 + kk) * P + c0 +
                                  4 * it.q)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    wr[kk][0] = v.x;
    wr[kk][1] = v.y;
    wr[kk][2] = v.z;
    wr[kk][3] = v.w;
  }
}

// acc[r][.] += src[r, k .. k+3] (a float4 at hpos(k)) times 4 weight rows
template <int R>
__device__ __forceinline__ void fma_rows(float (&acc)[R][4], const float* hp,
                                         int kph, const float4& w0,
                                         const float4& w1, const float4& w2,
                                         const float4& w3) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float4 h = *reinterpret_cast<const float4*>(hp + r * kph);
    acc[r][0] = fmaf(h.x, w0.x, acc[r][0]);
    acc[r][1] = fmaf(h.x, w0.y, acc[r][1]);
    acc[r][2] = fmaf(h.x, w0.z, acc[r][2]);
    acc[r][3] = fmaf(h.x, w0.w, acc[r][3]);
    acc[r][0] = fmaf(h.y, w1.x, acc[r][0]);
    acc[r][1] = fmaf(h.y, w1.y, acc[r][1]);
    acc[r][2] = fmaf(h.y, w1.z, acc[r][2]);
    acc[r][3] = fmaf(h.y, w1.w, acc[r][3]);
    acc[r][0] = fmaf(h.z, w2.x, acc[r][0]);
    acc[r][1] = fmaf(h.z, w2.y, acc[r][1]);
    acc[r][2] = fmaf(h.z, w2.z, acc[r][2]);
    acc[r][3] = fmaf(h.z, w2.w, acc[r][3]);
    acc[r][0] = fmaf(h.w, w3.x, acc[r][0]);
    acc[r][1] = fmaf(h.w, w3.y, acc[r][1]);
    acc[r][2] = fmaf(h.w, w3.z, acc[r][2]);
    acc[r][3] = fmaf(h.w, w3.w, acc[r][3]);
  }
}

// acc[r][c] = sum over all k of src[r, k] * W[k, c0 + 4q + c] in every
// lane of quad q: the item's first KR rows from registers (wr), the rest
// from the shared slice (consecutive lanes of a slice on consecutive
// quads: conflict-free), then the S slices' sums added across lanes.
// With `skip` the rows are left out (the no-product floor).
template <typename T, int R, int KR>
__device__ __forceinline__ void product(const T* Ws, int P, int c0,
                                        const Item& it,
                                        const float (&wr)[KR][4],
                                        const float* src, int kph, bool skip,
                                        float (&acc)[R][4]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  if (!skip && it.k1 - it.k0 >= KR) {
    // all KR register rows live: no guards, so the loads issue together
#pragma unroll
    for (int kk = 0; kk < KR; kk += 4)
      fma_rows<R>(
          acc, src + hpos(it.k0 + kk), kph,
          make_float4(wr[kk][0], wr[kk][1], wr[kk][2], wr[kk][3]),
          make_float4(wr[kk + 1][0], wr[kk + 1][1], wr[kk + 1][2],
                      wr[kk + 1][3]),
          make_float4(wr[kk + 2][0], wr[kk + 2][1], wr[kk + 2][2],
                      wr[kk + 2][3]),
          make_float4(wr[kk + 3][0], wr[kk + 3][1], wr[kk + 3][2],
                      wr[kk + 3][3]));
  } else if (!skip) {
#pragma unroll
    for (int kk = 0; kk < KR; kk += 4)
      if (it.k0 + kk < it.k1)
        fma_rows<R>(
            acc, src + hpos(it.k0 + kk), kph,
            make_float4(wr[kk][0], wr[kk][1], wr[kk][2], wr[kk][3]),
            make_float4(wr[kk + 1][0], wr[kk + 1][1], wr[kk + 1][2],
                        wr[kk + 1][3]),
            make_float4(wr[kk + 2][0], wr[kk + 2][1], wr[kk + 2][2],
                        wr[kk + 2][3]),
            make_float4(wr[kk + 3][0], wr[kk + 3][1], wr[kk + 3][2],
                        wr[kk + 3][3]));
  }
  if (!skip) {
    const T* wp = Ws + (size_t)(it.k0 + KR) * P + c0 + 4 * it.q;
#pragma unroll 2
    for (int k = it.k0 + KR; k < it.k1; k += 4, wp += 4 * P)
      fma_rows<R>(acc, src + hpos(k), kph, quad_f(wp), quad_f(wp + P),
                  quad_f(wp + 2 * P), quad_f(wp + 3 * P));
  }
  for (int off = it.L; off < 32; off <<= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
}

// acc[i / 4][i % 4] by selects (no local memory)
template <int R>
__device__ __forceinline__ float pick(const float (&acc)[R][4], int i) {
  float v = acc[0][0];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (r * 4 + c == i) v = acc[r][c];
  return v;
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads, 1) gru_fwd_sm90_kernel(
    const T* __restrict__ x3, const T* __restrict__ w,
    const float* __restrict__ bias, const int* __restrict__ lens,
    float* __restrict__ out, float* __restrict__ hT, int B, int Tn, int H,
    int n, int mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int E = 4 / (int)sizeof(T);
  const Layout L = layout(H, n, R, (int)sizeof(T));
  const int U = L.U, kpad = L.kpad, kph = L.kph, wseg = L.wseg, P = 3 * U;
  T* Ws = reinterpret_cast<T*>(smem + L.w);
  float* hb = reinterpret_cast<float*>(smem + L.hb);
  float* rb = reinterpret_cast<float*>(smem + L.rb);
  float* hown = reinterpret_cast<float*>(smem + L.hown);
  float* zs = reinterpret_cast<float*>(smem + L.zs);
  float* bs = reinterpret_cast<float*>(smem + L.bias);
  unsigned* xs = reinterpret_cast<unsigned*>(smem + L.xs);
  int* ls = reinterpret_cast<int*>(smem + L.lens);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rank = n > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int row0 = (blockIdx.x / n) * R;
  const int j0 = rank * U;
  const int uu = max(0, min(U, H - j0));          // owned units below H
  const int uw = (uu + E - 1) / E;                // owned words a row
  const size_t H3 = 3 * (size_t)H;
  // rows of W and x3 are 16-byte aligned, in 4-word copies
  const bool quads = H % (4 * E) == 0 && U % (4 * E) == 0 &&
                     reinterpret_cast<uintptr_t>(x3) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
  // bfloat16 with H odd: a row's words start an element early at odd
  // element offsets
  const bool odd = E == 2 && H % 2 == 1;

  // the weight slice, row k and gate g at a time (a warp a row): the
  // words of W[k, g*H + j0 + j] by cp.async, 16 bytes a copy where
  // aligned, 4 where the words are (always in float32; bfloat16 with H
  // even), one element at a time otherwise; zero past H and uu
  {
    const int wpg = U / E;                        // words a gate row
    unsigned* Wwords = reinterpret_cast<unsigned*>(Ws);
    for (int kg = warp; kg < kpad * 3; kg += kWarps) {
      const int k = kg / 3;
      const int g = kg - 3 * k;
      unsigned* dst = Wwords + (size_t)k * (P / E) + g * wpg;
      const T* src = w + (size_t)k * H3 + (size_t)g * H + j0;
      const int have = k < H ? uw : 0;
      for (int v = (quads ? 4 : 1) * lane; v < wpg;
           v += (quads ? 128 : 32)) {
        if (quads && v + 4 <= have) {
          cp_async16(dst + v, src + (size_t)v * E);
          continue;
        }
        for (int u = v; u < v + (quads ? 4 : 1) && u < wpg; ++u) {
          if (u >= have) {
            dst[u] = 0u;
          } else if (!odd) {
            cp_async4(dst + u, src + (size_t)u * E,
                      min(E, uu - u * E) * (int)sizeof(T));
          } else {
            T* d = reinterpret_cast<T*>(dst + u);
            for (int e = 0; e < E; ++e)
              d[e] = u * E + e < uu ? src[u * E + e] : rnn::from_f<T>(0.f);
          }
        }
      }
    }
  }
  // everything past the weights starts at zero
  for (int off = L.hb + 16 * tid; off < L.total; off += 16 * kThreads)
    *reinterpret_cast<float4*>(smem + off) = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  for (int c = tid; c < 3 * U; c += kThreads) {
    const int g = c / U;
    const int j = c - g * U;
    bs[c] = j < uu ? bias[g * H + j0 + j] : 0.f;
  }
  if (tid < R) ls[tid] = row0 + tid < B ? max(0, lens[row0 + tid]) : 0;
  if (tid == 0) {
    int m = 0;
    for (int r = 0; r < R; ++r)
      if (row0 + r < B) m = max(m, lens[row0 + r]);
    ls[R] = min(m, Tn);                          // steps this cluster runs
  }
  __syncthreads();
  const int t_end = ls[R];

  // x3[row, tt] of the block's units into stage tt % kStages, a warp a
  // (row, gate), the last warps first: the words covering
  // [g*H + j0, g*H + j0 + uu), in 4-word copies where aligned; otherwise
  // word by word, the first one starting an element early when that
  // start is odd (bfloat16, H odd), bytes past the owned units
  // zero-filled, never read
  auto prefetch = [&](int tt) {
    unsigned* buf = xs + (size_t)(tt % kStages) * R * 3 * wseg;
    for (int rg = kWarps - 1 - warp; rg < R * 3; rg += kWarps) {
      const int r = rg / 3;
      const int g = rg - 3 * r;
      if (row0 + r >= B) continue;
      const size_t lo =
          ((size_t)(row0 + r) * Tn + tt) * H3 + (size_t)g * H + j0;
      unsigned* dst = buf + (size_t)rg * wseg;
      if (quads) {
        for (int v = 4 * lane; v < uw; v += 128)
          cp_async16(dst + v, x3 + lo + (size_t)v * E);
      } else {
        const size_t end = lo + uu;
        for (int v = lane; v < wseg; v += 32) {
          const size_t e0 = (lo / E + v) * E;      // the word's first element
          if (e0 >= end) break;
          const size_t left = end - e0;
          cp_async4(dst + v, x3 + e0,
                    left >= (size_t)E ? 4 : (int)left * (int)sizeof(T));
        }
      }
    }
  };
  // element jj of gate g of row r at step tt, from stage st
  auto xval = [&](int st, int tt, int r, int g, int jj) -> float {
    const T* seg = reinterpret_cast<const T*>(
        xs + ((size_t)(st * R + r) * 3 + g) * wseg);
    // the element offset of the stage's first word: (row*Tn + tt)*3H +
    // g*H + j0 is odd (H odd), by parity alone
    const int off =
        odd ? (int)(((unsigned)(row0 + r) * (unsigned)Tn + (unsigned)tt +
                     (unsigned)g + (unsigned)j0) & 1u)
            : 0;
    return to_f(seg[off + jj]);
  };

  if (t_end > 0) prefetch(0);
  cp_async_commit();
  if (t_end > 1) prefetch(1);
  cp_async_commit();
  cp_async_wait<1>();                              // the weights, stage 0
  // every block of the cluster is running (distributed shared memory is
  // written only after this) and its weights and stage 0 are in place
  group_sync(n);
  if (mode == 1) {
    cp_async_wait<0>();            // no copy lands after the block has gone
    return;
  }

  // each thread's product items, and their first weight rows held in
  // registers for the whole launch
  constexpr int KA = RegRows<R>::A, KB = RegRows<R>::B;
  const Item ia = item_of(U / 2, kpad), ib = item_of(U / 4, kpad);
  float wa[KA][4], wb[KB][4];
  load_rows<T, KA>(Ws, P, 0, ia, wa);
  load_rows<T, KB>(Ws, P, 2 * U, ib, wb);
  const bool skip = mode == 2;
  int st = 0;                                      // t % kStages
  for (int t = 0; t < t_end; ++t) {
    float acc[R][4];
    // (A) z and r of the owned units; the lanes of a quad share its 4R
    // (row, column) sums out
    product<T, R, KA>(Ws, P, 0, ia, wa, hb, kph, skip, acc);
    if (ia.live) {
      for (int i = ia.s; i < 4 * R; i += ia.S) {
        const int r = i >> 2;
        const int col = 4 * ia.q + (i & 3);
        const int g = col < U ? 0 : 1;
        const int j = col - g * U;
        if (j >= uu) continue;
        const float v = sigmoid(xval(st, t, r, g, j) + pick<R>(acc, i) +
                                bs[g * U + j]);
        if (g == 0)
          zs[r * U + j] = v;
        else
          bcast(rb + r * kph + hpos(j0 + j),
                round_to<T>(v * hown[r * U + j]), n);
      }
    }
    group_sync(n);
    // (B) the candidate and the new h of the owned units
    product<T, R, KB>(Ws, P, 2 * U, ib, wb, rb, kph, skip, acc);
    if (ib.live) {
      for (int i = ib.s; i < 4 * R; i += ib.S) {
        const int r = i >> 2;
        const int j = 4 * ib.q + (i & 3);
        if (j >= uu) continue;
        const float cand =
            xval(st, t, r, 2, j) + pick<R>(acc, i) + bs[2 * U + j];
        const float hp = hown[r * U + j];
        const float z = zs[r * U + j];
        const float hn = (1.f - z) * hp + z * tanhf(cand);
        const bool valid = t < ls[r];
        const float hk = valid ? hn : hp;
        hown[r * U + j] = hk;
        if (row0 + r < B)
          out[((size_t)(row0 + r) * Tn + t) * H + j0 + j] = valid ? hn : 0.f;
        bcast(hb + r * kph + hpos(j0 + j), round_to<T>(hk), n);
      }
    }
    // stage t + 2 into the buffer step t - 1 read; stage t + 1 landed
    if (t + 2 < t_end) prefetch(t + 2);
    cp_async_commit();
    cp_async_wait<1>();
    st = st + 1 == kStages ? 0 : st + 1;
    group_sync(n);
  }

  // the final state and the zero tail past the cluster's longest row
  for (int it = tid; it < R * U; it += kThreads) {
    const int r = it / U;
    const int j = it - r * U;
    const int row = row0 + r;
    if (j >= uu || row >= B) continue;
    hT[(size_t)row * H + j0 + j] = hown[r * U + j];
    for (int t = t_end; t < Tn; ++t)
      out[((size_t)row * Tn + t) * H + j0 + j] = 0.f;
  }
}

// lets an instantiation take `bytes` of dynamic shared memory on the
// current device: the attribute is set once per instantiation and
// device, not per call
template <typename T, int R>
cudaError_t allow_smem(int bytes) {
  static std::atomic<int> granted[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::atomic<int>& have = granted[dev & 63];
  if (bytes <= 48 * 1024 || bytes <= have.load()) return cudaSuccess;
  e = cudaFuncSetAttribute(gru_fwd_sm90_kernel<T, R>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) have.store(bytes);
  return e;
}

// the launch's own refusals, apart from CUDA's error codes
constexpr cudaError_t kBadShape = static_cast<cudaError_t>(-1);
constexpr cudaError_t kSmemTooLarge = static_cast<cudaError_t>(-3);

template <typename T, int R>
cudaError_t launch(const void* x3, const void* w, const float* bias,
                   const int* lens, float* out, float* hT, int B, int Tn,
                   int H, int n, int mode, cudaStream_t stream) {
  const Layout L = layout(H, n, R, (int)sizeof(T));
  if (L.U > 2 * kThreads) return kBadShape;     // one product item a thread
  const int smem = L.total;
  if (smem > kMaxSmem) return kSmemTooLarge;
  cudaError_t e = allow_smem<T, R>(smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * ((B + R - 1) / R));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = n > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, gru_fwd_sm90_kernel<T, R>,
                         static_cast<const T*>(x3), static_cast<const T*>(w),
                         bias, lens, out, hT, B, Tn, H, n, mode);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x3, const void* w, const float* bias,
                     const int* lens, float* out, float* hT, int B, int Tn,
                     int H, int n, int R, int mode, cudaStream_t st) {
  switch (R) {
    case 1:
      return launch<T, 1>(x3, w, bias, lens, out, hT, B, Tn, H, n, mode, st);
    case 2:
      return launch<T, 2>(x3, w, bias, lens, out, hT, B, Tn, H, n, mode, st);
    case 4:
      return launch<T, 4>(x3, w, bias, lens, out, hT, B, Tn, H, n, mode, st);
    default:
      return kBadShape;
  }
}

}  // namespace

// The dynamic shared memory of a launch (the plan's mirror of it,
// ops/fused_rnn.py _gru_sm90_smem, is held against this on the card).
extern "C" int pt_gru_fwd_sm90_smem(int H, int n, int R, int esize) {
  return layout(H, n, R, esize).total;
}

// x3 [B, T, 3H] and w [H, 3H] in the product dtype (0 float32,
// 1 bfloat16; x3 4-byte aligned); bias [3H], out [B, T, H], hT [B, H]
// float32; lens [B] int32. n blocks a cluster (1, 2, 4, 8), R batch rows
// a cluster (1, 2, 4): ops/fused_rnn.py gru_fwd_plan. mode 0 the
// function, 1 and 2 the floors above. Returns cudaGetLastError() after
// the launch (0 on success), -1 for arguments the kernel does not take,
// -3 for a plan past the shared memory; the wrapper raises on anything
// but 0.
extern "C" int pt_gru_fwd_sm90(const void* x3, const void* w,
                               const void* bias, const void* lens, void* out,
                               void* hT, int B, int Tn, int H, int n, int R,
                               int dtype, int mode, void* stream) {
  // this library's runtime reports only its own calls; a refusal left
  // pending by an earlier call must not be read as this launch's
  (void)cudaGetLastError();
  if (B <= 0 || Tn <= 0 || H <= 0 || mode < 0 || mode > 2 ||
      !(n == 1 || n == 2 || n == 4 || n == 8) ||
      reinterpret_cast<uintptr_t>(x3) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 4 != 0)
    return (int)kBadShape;
  const float* b = static_cast<const float*>(bias);
  const int* ln = static_cast<const int*>(lens);
  float* o = static_cast<float*>(out);
  float* ht = static_cast<float*>(hT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch<float>(x3, w, b, ln, o, ht, B, Tn, H, n, R, mode, st);
  else if (dtype == 1)
    e = dispatch<__nv_bfloat16>(x3, w, b, ln, o, ht, B, Tn, H, n, R, mode,
                                st);
  else
    e = kBadShape;
  return (int)e;
}

// Paged window attention for Hopper (sm_90a) — the serving engine's
// per-layer attention over the paged KV pool, float and int8 pages.
//
// Replaces: paddle_tpu/ops/pallas_decode.py:_paged_window_kernel (the
// allocated-pages Pallas kernel, launched by paged_window_attention)
// and, with int8 pages, its dequant-fused twin
// _paged_window_dequant_kernel. Same function: for slot s and window
// token w, attention of the query heads over the slot's pages, token
// w seeing absolute positions c < kv_lens[s, w] (the ragged-length
// mask and the in-window causal mask in one), grouped-query heads
// (query head g*rep + r reads kv group g), online softmax in base 2
// with scale*log2(e), and the finalize division by max(l, 1e-30). A row
// with kv_len 0 returns what the TPU kernel returns for it: the mean of
// V over every column of the slot's used pages (its masked weights are
// exp2(NEG_INF - NEG_INF) = 1 there). int8 pages carry float32 scales
// [N, PS, G]; each element is dequantized in float32 right after it
// lands in shared memory, k = float(int8) * scale[row], the TPU
// kernel's rounding points, and everything after stays in float32.
//
// What bounds it on an H100: latency. A call must read the K and V of
// each slot's used pages, 2 * sum_s used_s * ps * g * dh * esize bytes
// (int8: dh + 4 bytes a row), against ~4 * sum_s len_s * h * dh flops:
// under one flop per byte, so the tensor cores buy nothing and the
// floor is bytes — a few MB at the serving shapes, about a microsecond
// at 3.35 TB/s. What a call pays beyond that is the chain of dependent
// steps each block makes and how many of them run at once. The TPU
// kernel walks a slot's pages along a sequential grid axis and carries
// (m, l, acc) from one grid step to the next; on Hopper that walk
// inside one block per (slot, group), in rounds of copies, grew with
// the window (W 3) and the context. So here the walk is split across
// blocks (flash-decoding) and merged in the same launch:
//
//   - the grid runs over (chunk, kv group g, slot s), chunk slowest, so
//     the live chunks of every slot are dispatched first. A chunk is TR
//     key rows (ops/paged_decode.py window_plan: 8 whole pages, fewer
//     in a narrower table, fewer rows only when they would not fit in
//     shared memory). Every block of a slot computes the same
//     used = clamp(ceil(max_w kv_lens[s, w] / ps), 1, P)
//     (pallas_decode.py:448); a block whose chunk starts at or past
//     used * ps returns at once, so pages past a slot's allocation are
//     never read (the allocated-pages traffic contract; an idle slot
//     reads only the null page 0, as on the TPU);
//   - prologue in parallel: distinct threads load the W lengths, the
//     chunk's table entries and the group's W*rep q rows (as float32)
//     into shared memory, all in one round trip; a table entry inside
//     the used pages that is out of range is never dereferenced — it
//     flags the block (__syncthreads_or), and the slot's rows come out
//     NaN while every other slot's stay as they are;
//   - one gather round trip: every 16-byte piece of the chunk's K and
//     V rows of group g (8-byte pieces for int8 rows with dh % 16 ==
//     8) and, for int8 pages, their 4-byte scales are in flight at once
//     (cp.async). One group's scales are strided by G * 4 bytes, which
//     TMA does not take below G = 4; K and V rows would take TMA, but
//     its tensor maps would have to be encoded on the host for each
//     call of a host-bound engine, for one round trip either way;
//   - scores with one key per lane: K rows sit in shared memory padded
//     to an odd multiple of 16 bytes, so the 8 lanes of each 16-byte
//     load phase hit 8 different bank groups; q rows are read as
//     broadcasts, and at dh 64 and 128 the dot products are unrolled at
//     compile time. A unit of work is (query row, 32 keys), spread over
//     the block's four warps; then one warp max and one warp sum per 32
//     keys of a row, in place of a five-step shuffle per key. For P.V
//     the lanes span dh, a unit is (query row, 32 columns of dh), and a
//     row's keys are split over the warps such units leave idle. All
//     W*rep rows of the group read the same tile, so K and V come from
//     device memory once per group. Float32 pages stay in float32
//     throughout (TF32 would miss the rtol 2e-4 the kernel is held to);
//   - merge in the same launch: a slot whose used rows fit in one chunk
//     writes out directly. Otherwise each live block writes its partial
//     (m, l, acc[dh]) per query row and a corrupt-entry flag to a
//     float32 workspace, __threadfence()s, and adds one to the arrival
//     counter of its (slot, group); the block that arrives last (the
//     thread-fence reduction pattern) loads up to 32 chunks' partials
//     in one round trip and folds them with the online-softmax algebra,
//     factor exp2(m_c - max_c m_c) — for a kv_len-0 row every m_c is
//     NEG_INF, every factor 1, and the sums give the mean of V over the
//     used pages — writes out (NaN for the whole slot when any chunk
//     was flagged: fmaxf would drop a NaN, so the flag carries it) and
//     sets the counter back to 0. The counters live across calls (the
//     wrapper zeroes them once per device), so no memset runs per call
//     and CUDA-graph replay works.
//
// On the card (chip_smoke.py phases 4, 22 and 23; PERF.md) a block's
// chain is launch and the prologue's round trip (~2.6-2.9 us by
// themselves), the gather (~1 us at the engine's lengths), the chunk's
// arithmetic and stores (~2-3 us), and, for a split slot, the merge's
// store, fence, atomic and load (~2 us). More, shorter chunks did not
// pay at the engine's lengths: the merge costs more than the walk the
// blocks would share, so a chunk is 8 pages and a slot of up to 128
// tokens takes one block; the split pays at W 3 and at full context.
// Shared memory per block: q rows, one chunk's K and V rows (and
// scales), the R x TR probabilities and a few words — 70,736 bytes at
// the engine's float32 shapes (TR 128, W 1), 22,608 with int8 pages.
// The attribute for more than 48 KB is set only when a launch needs
// more than the instantiation was granted on its device, not per call.
// mode 1-3 stop a launch early: the floors the timings above come from.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared
// -Xcompiler -fPIC (paddle_tpu_torch/ops/_build.py); bound with ctypes
// through the plain C functions at the bottom.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxHeadDim = 256;
constexpr int kMaxRows = 32;        // W * rep query rows of one group
// dynamic shared memory a block may take: the card's 227 KB opt-in
// less room for the static words and the block's reserved 1 KB
constexpr int kMaxSmem = 226 * 1024;
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// asynchronous global -> shared copies (sm_80+): 16 bytes bypassing L1,
// 8 and 4 bytes through it (cp.async.cg takes only 16)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__host__ __device__ __forceinline__ int align16(int n) {
  return (n + 15) & ~15;
}

// Bytes of one K/V row in shared memory: the row rounded up to 16
// bytes, then to an odd multiple of 16, so the 8 lanes of a 16-byte
// load phase, reading 8 consecutive rows, hit 8 different bank groups.
__host__ __device__ __forceinline__ int row_stride(int DH, int esize) {
  const int b = align16(DH * esize);
  return (b / 16) % 2 == 0 ? b + 16 : b;
}

// P.V splits each row's keys kq ways when the (row, 32 columns) units
// alone would leave warps idle: kq * units <= kWarps
__host__ __device__ __forceinline__ int pv_split(int R, int DH) {
  const int units = R * ((DH + kWarp - 1) / kWarp);
  return units < kWarps ? kWarps / units : 1;
}

// Byte offsets of a block's shared memory, each region 16-byte
// aligned (ops/paged_decode.py window_smem_bytes mirrors the total).
// The q rows' region later holds the P.V sums, [kq][R][DH].
struct Layout {
  int q, k, v, ks, vs, prob, stats, pages, lens, total;
};
__host__ __device__ __forceinline__ Layout layout(int R, int W, int DH,
                                                  int TR, int PS,
                                                  int esize, bool quant) {
  Layout o;
  int at = 0;
  o.q = at;     at += align16(pv_split(R, DH) * R * DH * 4);
  const int tile = TR * row_stride(DH, esize);
  o.k = at;     at += tile;                          // [TR] K rows
  o.v = at;     at += tile;                          // [TR] V rows
  o.ks = at;    at += quant ? align16(TR * 4) : 0;   // their scales
  o.vs = at;    at += quant ? align16(TR * 4) : 0;
  o.prob = at;  at += align16(R * TR * 4);           // [R][TR] scores
  o.stats = at; at += align16(R * 2 * 4);            // [R] (m, l)
  o.pages = at; at += align16((TR / PS + 2) * 4);    // chunk's pages
  o.lens = at;  at += align16(W * 4);
  o.total = at;
  return o;
}

// 16 bytes of pool elements as float32
template <typename TKV> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* o) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* o) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 b;
      *reinterpret_cast<unsigned*>(&b) = w[i];
      const float2 f = __bfloat1622float2(b);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};
__device__ __forceinline__ void bytes_to_f32(unsigned w, float* o) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = static_cast<float>(static_cast<int8_t>((w >> (8 * i)) & 0xff));
}
template <> struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ static void load(const int8_t* p, float* o) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    bytes_to_f32(x.x, o);
    bytes_to_f32(x.y, o + 4);
    bytes_to_f32(x.z, o + 8);
    bytes_to_f32(x.w, o + 12);
  }
  // the 8-byte tail of a row with dh % 16 == 8
  __device__ static void load8(const int8_t* p, float* o) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    bytes_to_f32(x.x, o);
    bytes_to_f32(x.y, o + 4);
  }
};

// q . k over dh for one key row in shared memory; int8 rows are
// dequantized element by element (k * scale, then the product). DHC is
// the head dim when known at compile time (every load of the row then
// issues at once), else 0
template <typename TKV, int DHC>
__device__ __forceinline__ float dot_row(const float* qrow, const TKV* krow,
                                         int dh, float ksc) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  using V = Vec<TKV>;
  const int DH = DHC ? DHC : dh;
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int d = 0; d + V::N <= DH; d += V::N) {
    float kv[V::N];
    V::load(krow + d, kv);
#pragma unroll
    for (int i = 0; i < V::N; i += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + d + i);
      float k0 = kv[i], k1 = kv[i + 1], k2 = kv[i + 2], k3 = kv[i + 3];
      if constexpr (kQuant) {
        k0 *= ksc; k1 *= ksc; k2 *= ksc; k3 *= ksc;
      }
      a0 = fmaf(qv.x, k0, a0);
      a1 = fmaf(qv.y, k1, a1);
      a0 = fmaf(qv.z, k2, a0);
      a1 = fmaf(qv.w, k3, a1);
    }
  }
  if constexpr (kQuant) {
    const int d = DH / V::N * V::N;
    if (d < DH) {                    // dh % 16 == 8: one 8-byte piece
      float kv[8];
      V::load8(krow + d, kv);
#pragma unroll
      for (int i = 0; i < 8; i += 2) {
        a0 = fmaf(qrow[d + i], kv[i] * ksc, a0);
        a1 = fmaf(qrow[d + i + 1], kv[i + 1] * ksc, a1);
      }
    }
  }
  return a0 + a1;
}

// grid (n_chunks * G * S), chunk slowest; block kThreads; dynamic
// shared memory layout(...).total. T is q's and out's type; TKV the
// pages' (T, or int8_t with float32 scales); DHC the head dim if fixed
// at compile time, else 0.
// Layouts (all contiguous): q, out [S, W, H, DH]; k_pages, v_pages
// [N, PS, G, DH]; k_scales, v_scales [N, PS, G] (int8 pages only);
// tables [S, P] int32; kv_lens [S, W] int32; ws [S, G, n_chunks, R,
// 2 + DH] float32 partials (m, l, acc); flags [S, G, n_chunks] int32;
// arrivals [S, G] int32, 0 between calls. ws, flags and arrivals are
// read only when n_chunks > 1. mode 0 computes the function; 1, 2 and
// 3 stop after the prologue, the gather and the chunk's own outputs
// (no merge): the floors chip_smoke.py times, whose outputs are not
// the function.
template <typename T, typename TKV, int DHC>
__global__ void __launch_bounds__(kThreads) paged_window_kernel(
    const T* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ tables,
    const int* __restrict__ kv_lens, T* __restrict__ out,
    float* __restrict__ ws, int* __restrict__ flags,
    int* __restrict__ arrivals, int S, int W, int H, int G, int dh,
    int n_pages, int PS, int P, int TR, int n_chunks, float scale_log2,
    int mode) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int kE = sizeof(TKV);
  const int DH = DHC ? DHC : dh;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  const int rep = H / G;
  const int R = W * rep;
  const Layout lay = layout(R, W, DH, TR, PS, kE, kQuant);
  float* qs = reinterpret_cast<float*>(smem + lay.q);
  unsigned char* kt = smem + lay.k;
  unsigned char* vt = smem + lay.v;
  float* kss = reinterpret_cast<float*>(smem + lay.ks);
  float* vss = reinterpret_cast<float*>(smem + lay.vs);
  float* prob = reinterpret_cast<float*>(smem + lay.prob);
  float* stat = reinterpret_cast<float*>(smem + lay.stats);
  int* pg = reinterpret_cast<int*>(smem + lay.pages);
  int* ln = reinterpret_cast<int*>(smem + lay.lens);

  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int chunk = blockIdx.x / (S * G);
  const int gs = blockIdx.x - chunk * (S * G);
  const int g = gs / S;
  const int s = gs - g * S;
  const int kst = row_stride(DH, kE);
  const int c0 = chunk * TR;         // first key row (slot column)
  const int p0 = c0 / PS;            // its page
  const int np = (c0 + TR - 1) / PS - p0 + 1;

  // prologue, one round trip: lengths, the chunk's table entries (all
  // inside the table; none is dereferenced yet) and the q rows
  if (tid < W) ln[tid] = kv_lens[s * W + tid];
  for (int i = tid; i < np; i += kThreads)
    pg[i] = p0 + i < P ? tables[(size_t)s * P + p0 + i] : 0;
  for (int i = tid; i < R * DH; i += kThreads) {
    const int r = i / DH;
    const int d = i - r * DH;
    const int w = r / rep;
    const int hq = g * rep + r % rep;
    qs[i] = to_f32(q[((size_t)(s * W + w) * H + hq) * DH + d]);
  }
  __syncthreads();

  // pages holding live KV for the slot, >= 1 so an idle slot still
  // reads the null page (reference: pallas_decode.py:448)
  int max_len = 0;
  for (int i = 0; i < W; ++i) max_len = max(max_len, ln[i]);
  const int used = min(max((max_len + PS - 1) / PS, 1), P);
  const int rows_used = used * PS;
  if (c0 >= rows_used || mode == 1) return;    // block-uniform
  const int nk = min(TR, rows_used - c0);      // key rows of this chunk
  const int n_live = (rows_used + TR - 1) / TR;
  const int last = (c0 + nk - 1) / PS - p0;    // chunk's last page slot
  int bad = 0;
  for (int i = tid; i <= last; i += kThreads)
    bad |= pg[i] < 0 || pg[i] >= n_pages;
  bad = __syncthreads_or(bad);

  const size_t rec = (size_t)DH + 2;           // one partial record
  const size_t base = (size_t)(s * G + g) * n_chunks;
  if (!bad) {
    // the gather: every piece of the chunk's rows in flight at once
    const int cbytes = (DH * kE) % 16 == 0 ? 16 : 8;
    const int cpr = DH * kE / cbytes;
    const unsigned char* kg = reinterpret_cast<const unsigned char*>(k_pages);
    const unsigned char* vg = reinterpret_cast<const unsigned char*>(v_pages);
    for (int i = tid; i < nk * cpr; i += kThreads) {
      const int j = i / cpr;
      const int e = i - j * cpr;
      const int col = c0 + j;
      const int page = pg[col / PS - p0];
      const size_t goff =
          (((size_t)page * PS + col % PS) * G + g) * (size_t)(DH * kE) +
          (size_t)e * cbytes;
      const int soff = j * kst + e * cbytes;
      if (cbytes == 16) {
        cp_async16(kt + soff, kg + goff);
        cp_async16(vt + soff, vg + goff);
      } else {
        cp_async8(kt + soff, kg + goff);
        cp_async8(vt + soff, vg + goff);
      }
    }
    if constexpr (kQuant) {
      for (int j = tid; j < nk; j += kThreads) {
        const int col = c0 + j;
        const size_t goff =
            ((size_t)pg[col / PS - p0] * PS + col % PS) * G + g;
        cp_async4(kss + j, k_scales + goff);
        cp_async4(vss + j, v_scales + goff);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if (mode == 2) return;

    // scores, one key per lane: units (query row, 32 keys)
    const int KG = (nk + kWarp - 1) / kWarp;
    for (int u = warp; u < R * KG; u += kWarps) {
      const int r = u / KG;
      const int j = (u - r * KG) * kWarp + lane;
      const int len = ln[r / rep];
      if (j < nk) {
        float sc = kNegInf;
        if (j < len - c0)            // len > 0 here: a live column
          sc = dot_row<TKV, DHC>(qs + r * DH,
                                 reinterpret_cast<const TKV*>(kt + j * kst),
                                 DH, kQuant ? kss[j] : 1.f) * scale_log2;
        prob[r * TR + j] = sc;
      }
    }
    __syncthreads();

    // the chunk's online-softmax state of each row: one warp a row
    for (int r = warp; r < R; r += kWarps) {
      const int len = ln[r / rep];
      float m = kNegInf;
      float l = 0.f;
      float* pr = prob + r * TR;
      if (len <= 0) {
        // a row that sees no column: the TPU kernel does not zero its
        // masked weights, exp2(NEG_INF - NEG_INF) = 1 for every column
        // of the used pages, and m stays NEG_INF
        for (int j = lane; j < nk; j += kWarp) pr[j] = 1.f;
        l = (float)nk;
      } else {
        const int live = min(nk, len - c0);
        if (live > 0) {
          float mx = kNegInf;
          for (int j = lane; j < live; j += kWarp) mx = fmaxf(mx, pr[j]);
          m = warp_max(mx);
          float sum = 0.f;
          for (int j = lane; j < live; j += kWarp) {
            const float p = exp2f(pr[j] - m);
            pr[j] = p;
            sum += p;
          }
          l = warp_sum(sum);
        }
      }
      if (lane == 0) {
        stat[2 * r] = m;
        stat[2 * r + 1] = l;
      }
    }
    __syncthreads();

    // P.V, lanes across dh: units (key part kq, query row, 32 columns),
    // the keys of a row split KQ ways when rows are few; masked columns
    // of a live row are skipped (their weight is exactly 0). The sums
    // go to the q rows' region, free since the scores.
    const int ND = (DH + kWarp - 1) / kWarp;
    const int KQ = pv_split(R, DH);
    float* pv = qs;                                // [KQ][R][DH]
    for (int u = warp; u < R * ND * KQ; u += kWarps) {
      const int kq = u / (R * ND);
      const int ru = u - kq * (R * ND);
      const int r = ru / ND;
      const int d = (ru - r * ND) * kWarp + lane;
      const int len = ln[r / rep];
      const int jend = len <= 0 ? nk : max(0, min(nk, len - c0));
      const int j1 = (kq + 1) * jend / KQ;
      const float* pr = prob + r * TR;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      if (d < DH) {
        int j = kq * jend / KQ;
        for (; j + 4 <= j1; j += 4) {
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            float vv = to_f32(
                reinterpret_cast<const TKV*>(vt + (j + t) * kst)[d]);
            if constexpr (kQuant) vv *= vss[j + t];
            a[t] = fmaf(pr[j + t], vv, a[t]);
          }
        }
        for (; j < j1; ++j) {
          float vv = to_f32(reinterpret_cast<const TKV*>(vt + j * kst)[d]);
          if constexpr (kQuant) vv *= vss[j];
          a[0] = fmaf(pr[j], vv, a[0]);
        }
        pv[(kq * R + r) * DH + d] = (a[0] + a[1]) + (a[2] + a[3]);
      }
    }
    __syncthreads();

    // the chunk's outputs: the result itself when the slot has one
    // chunk, else its partial records, by every thread
    for (int i = tid; i < R * DH; i += kThreads) {
      const int r = i / DH;
      const int d = i - r * DH;
      float acc = pv[r * DH + d];
      for (int kq = 1; kq < KQ; ++kq) acc += pv[(kq * R + r) * DH + d];
      if (n_live == 1) {
        const int w = r / rep;
        const int hq = g * rep + r % rep;
        out[((size_t)(s * W + w) * H + hq) * DH + d] =
            from_f32<T>(acc / fmaxf(stat[2 * r + 1], 1e-30f));
      } else {
        float* rp = ws + ((base + chunk) * R + r) * rec;
        rp[2 + d] = acc;
        if (d == 0) {
          rp[0] = stat[2 * r];
          rp[1] = stat[2 * r + 1];
        }
      }
    }
  } else if (n_live == 1) {
    // a corrupt table entry: the slot's rows are NaN
    for (int i = tid; i < R * DH; i += kThreads) {
      const int r = i / DH;
      const int w = r / rep;
      const int hq = g * rep + r % rep;
      out[((size_t)(s * W + w) * H + hq) * DH + (i - r * DH)] =
          from_f32<T>(__int_as_float(0x7fc00000));
    }
  }
  if (n_live == 1 || mode == 3) return;

  // the merge: the last block of this (slot, group) to arrive folds
  // every live chunk's partial (thread-fence reduction)
  if (tid == 0) flags[base + chunk] = bad;
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(&arrivals[s * G + g], 1) == n_live - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int ND = (DH + kWarp - 1) / kWarp;
  const size_t cstep = (size_t)R * rec;      // from one chunk's record on
  for (int u = warp; u < R * ND; u += kWarps) {
    const int r = u / ND;
    const int d = (u - r * ND) * kWarp + lane;
    const float* rp = ws + (base * R + r) * rec;
    float m_all = kNegInf;
    float l = 0.f;
    float acc = 0.f;
    int any_bad = 0;
    for (int cb = 0; cb < n_live; cb += kWarp) {
      // one round trip a batch of up to 32 chunks: lane k loads chunk
      // cb + k's (m, l, flag), every lane its column of all of them
      const int nb = min(kWarp, n_live - cb);
      float av[kWarp];
#pragma unroll
      for (int k = 0; k < kWarp; ++k)
        av[k] = k < nb && d < DH ? __ldcg(rp + (cb + k) * cstep + 2 + d)
                                 : 0.f;
      float mc = kNegInf;
      float lc = 0.f;
      int fc = 0;
      if (lane < nb) {
        mc = __ldcg(rp + (cb + lane) * cstep);
        lc = __ldcg(rp + (cb + lane) * cstep + 1);
        fc = __ldcg(flags + base + cb + lane);
      }
      // fold the batch into the running state: the online-softmax
      // algebra (a kv_len-0 row keeps m = NEG_INF, every factor 1)
      const float m_new = fmaxf(m_all, warp_max(mc));
      const float alpha = exp2f(m_all - m_new);
      const float f = exp2f(mc - m_new);
      l = l * alpha + warp_sum(lc * f);
      acc *= alpha;
#pragma unroll
      for (int k = 0; k < kWarp; ++k)
        acc = fmaf(av[k], __shfl_sync(0xffffffffu, f, k), acc);
      m_all = m_new;
      any_bad |= __any_sync(0xffffffffu, fc);
    }
    if (d < DH) {
      const int w = r / rep;
      const int hq = g * rep + r % rep;
      out[((size_t)(s * W + w) * H + hq) * DH + d] = from_f32<T>(
          any_bad ? __int_as_float(0x7fc00000) : acc / fmaxf(l, 1e-30f));
    }
  }
  if (tid == 0) arrivals[s * G + g] = 0;
}

// lets an instantiation take `bytes` of dynamic shared memory on the
// current device: the attribute is set only when a launch needs more
// than it has been granted there
template <typename T, typename TKV, int DHC>
cudaError_t allow_smem(int bytes) {
  static std::atomic<int> granted[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::atomic<int>& have = granted[dev & 63];
  if (bytes <= 48 * 1024 || bytes <= have.load()) return cudaSuccess;
  e = cudaFuncSetAttribute(paged_window_kernel<T, TKV, DHC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) have.store(bytes);
  return e;
}

bool shape_ok(int S, int W, int H, int G, int DH, int PS, int P, int TR,
              int n_chunks) {
  if (!(S > 0 && W > 0 && G > 0 && H % G == 0 && DH > 0 && DH % 8 == 0 &&
        DH <= kMaxHeadDim && W * (H / G) <= kMaxRows && PS > 0 && P > 0 &&
        TR > 0 && TR <= (1 << 16) && n_chunks > 0))
    return false;
  const long long rows = (long long)P * PS;
  return n_chunks == (rows + TR - 1) / TR &&
         (long long)n_chunks * S * G <= 0x7fffffffLL;
}

// the launch's own refusals, apart from CUDA's error codes
constexpr cudaError_t kBadShape = static_cast<cudaError_t>(-1);
constexpr cudaError_t kNoWorkspace = static_cast<cudaError_t>(-2);
constexpr cudaError_t kSmemTooLarge = static_cast<cudaError_t>(-3);

template <typename T, typename TKV, int DHC>
cudaError_t launch_dh(const void* q, const void* k_pages,
                      const void* v_pages, const float* k_scales,
                      const float* v_scales, const int* tables,
                      const int* kv_lens, void* out, float* ws, int* flags,
                      int* arrivals, int S, int W, int H, int G, int DH,
                      int n_pages, int PS, int P, int TR, int n_chunks,
                      float scale, int mode, int smem, cudaStream_t stream) {
  const cudaError_t e = allow_smem<T, TKV, DHC>(smem);
  if (e != cudaSuccess) return e;
  paged_window_kernel<T, TKV, DHC><<<n_chunks * S * G, kThreads, smem,
                                     stream>>>(
      static_cast<const T*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), k_scales, v_scales, tables, kv_lens,
      static_cast<T*>(out), ws, flags, arrivals, S, W, H, G, DH, n_pages, PS,
      P, TR, n_chunks, scale * kLog2e, mode);
  return cudaGetLastError();
}

template <typename T, typename TKV>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const float* k_scales, const float* v_scales,
                   const int* tables, const int* kv_lens, void* out,
                   float* ws, int* flags, int* arrivals, int S, int W, int H,
                   int G, int DH, int n_pages, int PS, int P, int TR,
                   int n_chunks, float scale, int mode,
                   cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  // this library's runtime reports only its own calls; a refusal left
  // pending by an earlier call must not be read as this launch's
  (void)cudaGetLastError();
  if (!shape_ok(S, W, H, G, DH, PS, P, TR, n_chunks) || mode < 0 ||
      mode > 3)
    return kBadShape;
  if (n_chunks > 1 && (ws == nullptr || flags == nullptr ||
                       arrivals == nullptr))
    return kNoWorkspace;
  const int smem = layout(W * (H / G), W, DH, TR, PS, (int)sizeof(TKV),
                          kQuant).total;
  if (smem > kMaxSmem) return kSmemTooLarge;
  if (DH == 64)
    return launch_dh<T, TKV, 64>(q, k_pages, v_pages, k_scales, v_scales,
                                 tables, kv_lens, out, ws, flags, arrivals, S,
                                 W, H, G, DH, n_pages, PS, P, TR, n_chunks,
                                 scale, mode, smem, stream);
  if (DH == 128)
    return launch_dh<T, TKV, 128>(q, k_pages, v_pages, k_scales, v_scales,
                                  tables, kv_lens, out, ws, flags, arrivals,
                                  S, W, H, G, DH, n_pages, PS, P, TR,
                                  n_chunks, scale, mode, smem, stream);
  return launch_dh<T, TKV, 0>(q, k_pages, v_pages, k_scales, v_scales,
                              tables, kv_lens, out, ws, flags, arrivals, S, W,
                              H, G, DH, n_pages, PS, P, TR, n_chunks, scale,
                              mode, smem, stream);
}

}  // namespace

// Float pages of q's dtype. dtype: 0 float32, 1 bfloat16. TR key rows
// a block, n_chunks = ceil(P * PS / TR) (ops/paged_decode.py
// window_plan); ws, flags and arrivals as above (null when n_chunks is
// 1); mode as above. Returns cudaGetLastError() after the launch (0 on
// success), or -1 for shapes the kernel does not take, -2 for a missing
// workspace, -3 for a plan past the shared memory; the wrapper raises
// on anything but 0.
extern "C" int pt_paged_window_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* kv_lens, void* out, void* ws,
    void* flags, void* arrivals, int S, int W, int H, int G, int DH,
    int n_pages, int PS, int P, int TR, int n_chunks, float scale,
    int dtype, int mode, void* stream) {
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(kv_lens);
  float* wsp = static_cast<float*>(ws);
  int* fl = static_cast<int*>(flags);
  int* ar = static_cast<int*>(arrivals);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch<float, float>(q, k_pages, v_pages, nullptr, nullptr, tb, ln,
                             out, wsp, fl, ar, S, W, H, G, DH, n_pages, PS,
                             P, TR, n_chunks, scale, mode, st);
  else if (dtype == 1)
    e = launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, tb, ln, out, wsp, fl, ar, S,
        W, H, G, DH, n_pages, PS, P, TR, n_chunks, scale, mode, st);
  else
    e = kBadShape;
  return (int)e;
}

// int8 pages with float32 scales [N, PS, G]; dtype is q's (and out's):
// 0 float32, 1 bfloat16.
extern "C" int pt_paged_window_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* kv_lens, void* out, void* ws, void* flags, void* arrivals,
    int S, int W, int H, int G, int DH, int n_pages, int PS, int P, int TR,
    int n_chunks, float scale, int dtype, int mode, void* stream) {
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(kv_lens);
  float* wsp = static_cast<float*>(ws);
  int* fl = static_cast<int*>(flags);
  int* ar = static_cast<int*>(arrivals);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch<float, int8_t>(q, k_pages, v_pages, ks, vs, tb, ln, out, wsp,
                              fl, ar, S, W, H, G, DH, n_pages, PS, P, TR,
                              n_chunks, scale, mode, st);
  else if (dtype == 1)
    e = launch<__nv_bfloat16, int8_t>(q, k_pages, v_pages, ks, vs, tb, ln,
                                      out, wsp, fl, ar, S, W, H, G, DH,
                                      n_pages, PS, P, TR, n_chunks, scale,
                                      mode, st);
  else
    e = kBadShape;
  return (int)e;
}

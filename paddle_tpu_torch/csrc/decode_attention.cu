// Dense-cache decode attention for Hopper (sm_90a): one query per row
// over a [b, g, dh, T] cache.
//
// Replaces: paddle_tpu/ops/pallas_decode.py:_decode_kernel (launched by
// decode_attention; the decode path reaches it through
// paged_attention(use_kernel=True), which gathers the paged view and
// transposes it to this layout). Same function: for row b and query
// head h = g*rep + r, float32 scores sum_d q[b,h,d] k[b,g,d,t] scaled by
// scale*log2(e), positions t >= kv_len masked to NEG_INF (kv_len one
// length shared by every row, or per row), an exp2 softmax and the
// float32 sum over t of p_t v[b,g,d,t], divided by the sum of p, written
// in q's dtype. A row with kv_len 0 returns what the TPU kernel returns
// for it: every score is NEG_INF, so every weight is exp2(0) = 1 and the
// row is the mean of V over T.
//
// What bounds it on an H100: bytes, and the latency of the few round
// trips a block makes. A call must read each row's live columns of K and
// V once (2 * g * dh * kv_len elements a row; a kv_len-0 row needs all T
// of V and no K) against 4 * h * dh * kv_len flops: h / (2 g) flops a
// byte in float32, 0.5 at g 8 and 4 at g 1, far below the ~20 of even
// the SIMT units' ridge. So the tensor cores buy nothing here and this
// kernel issues no wgmma: the design is about keeping many blocks busy
// with one memory round trip each. The TPU kernel holds a whole group's
// [b, dh, T] blocks in VMEM and walks its grid over the kv groups; on
// Hopper one block per (row, group) was 64 blocks on 132 SMs, each a
// chain of dependent loads over all of its columns. Here instead:
//
//   - split each row's columns across blocks (flash-decoding): the grid
//     runs over (chunk, kv group g, row b), chunk slowest, and a chunk
//     is C columns, a multiple of 32 (ops/paged_decode.py decode_plan: 128,
//     swept on the card; fewer only when the tiles would not fit). The
//     live columns of a row are its first kv_len (all T for a kv_len-0
//     row: their mean); a block whose chunk starts at or past them
//     returns at once, so no column past kv_len is read;
//   - one asynchronous round trip per tile: the group's rep q rows are
//     put in flight before the length is read (cp.async, 16-byte
//     pieces; bfloat16 rows land as they are and are widened to float32
//     in shared memory), then every 16-byte piece of the chunk's [dh, C]
//     K and V tiles at once. The cache keeps T contiguous, so each of
//     the dh rows of a tile is one contiguous run of columns (rows that
//     are not 16-byte aligned, T * esize % 16 != 0, go in 8- or 4-byte
//     pieces, and bfloat16 rows of odd T element by element). A kv_len-0
//     row loads no K. Tried on the card and dropped: each tile row as
//     one bulk copy (the TMA, no tensor map) on an mbarrier, slower
//     than the pieces; chunk 0's tiles issued before the length is
//     known, no faster;
//   - scores from shared memory, a 32-column group a warp and a column a
//     lane: lane t reads K[d][t] (32 consecutive columns a warp, no bank
//     conflict) and the q rows as broadcasts (every lane the same word,
//     so they need no padding); each lane computes all rep heads of its
//     column, branch-free (rep rounded up to a power of two; the rows
//     past rep are never stored), so K is read from device memory once
//     per group, not once per query head, and the heads' FMA chains
//     interleave. Each warp then takes its group's softmax state per
//     head in registers: one warp max and one warp sum per 32 columns,
//     the weights exp2(s - m_g) on the group's own max m_g;
//   - P.V with the lanes across dh: lane d reads V[d][j..j+3] (j..j+7 in
//     bfloat16) as one 16-byte word and the weights p[r][j..] as
//     broadcasts, for every rep head at once, and scales each group's
//     sum by exp2(m_g - m) onto the chunk's max m; V rows sit in shared
//     memory padded to an odd multiple of 16 bytes, so the 8 lanes of
//     each 16-byte phase, on 8 consecutive rows, hit 8 different bank
//     groups. Whole groups of columns go to warps that dh leaves idle
//     (pv_split);
//   - merge in the same launch: a (row, group) whose live columns fit in
//     one chunk writes out directly. Otherwise each live block writes
//     its partial (m, l, acc[dh]) per query head to a float32 workspace,
//     __threadfence()s, and adds one to the arrival counter of its
//     (row, group); the block that arrives last loads the partials of up
//     to 32 chunks into shared memory in one round trip and folds them
//     with the online-softmax algebra, factor exp2(m_c - max_c m_c) (for
//     a kv_len-0 row every m_c is NEG_INF and every factor 1: the sums
//     are the mean of V), writes out and sets its counter back to 0.
//     The counters are the window kernel's (paged_window_attention.cu):
//     one int32 per (row, group) per device, shared by both kernels,
//     zeroed when allocated (ops/paged_decode.py _arrival_counters),
//     never memset per call, so CUDA-graph replay works; calls on one
//     device run one at a time on one stream.
//
// float32 stays float32 throughout: TF32 would miss the rtol 2e-4 /
// atol 2e-5 the kernel is held to. Shared memory per block: float32 q
// rows (later the P.V sums), bfloat16 q rows as loaded, the K and V
// tiles (later the merge's records), the weights, (m, l) per group and
// per head — 68,656 bytes at b 8, h 8, g 8, dh 64, float32, C 128. The
// floors chip_smoke.py times: mode 5 returns at once (the launch), 1
// stops after the tile loads, 3 after the scores, 4 after P.V, 2 before
// the merge; their outputs are not the function.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared
// -Xcompiler -fPIC (paddle_tpu_torch/ops/_build.py); bound with ctypes
// through the plain C functions at the bottom.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxRep = 32;
// dynamic shared memory a block may take: the card's 227 KB opt-in
// less room for the static words and the block's reserved 1 KB
constexpr int kMaxSmem = 226 * 1024;
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// Bytes of one tile row of C columns in shared memory: the row rounded
// up to 16 bytes, then to an odd multiple of 16, so the 8 lanes of a
// 16-byte load phase, reading 8 consecutive rows, hit 8 different bank
// groups.
__host__ __device__ __forceinline__ int row_stride(int C, int esize) {
  const int b = align16(C * esize);
  return (b / 16) % 2 == 0 ? b + 16 : b;
}

// P.V splits a chunk's columns kq ways when dh's groups of 32 lanes
// alone would leave warps idle.
__host__ __device__ __forceinline__ int pv_split(int DH) {
  const int nd = (DH + kWarp - 1) / kWarp;
  return nd < kWarps ? kWarps / nd : 1;
}

// The heads a block computes: rep rounded up to a power of two (the
// kernel's MAXR). Every lane computes all of them with no branch, so the
// FMA chains of different heads interleave; the rows past rep hold
// whatever shared memory held, and their sums are never stored.
__host__ __device__ __forceinline__ int max_rep(int rep) {
  int r = 1;
  while (r < rep) r <<= 1;
  return r;
}

// Floats of one partial record: (m, l), two words of padding, acc[DH];
// a multiple of 4, so the merge loads records in 16-byte pieces.
__host__ __device__ __forceinline__ int record_floats(int DH) {
  return DH + 4;
}

// Byte offsets of a block's shared memory, each region 16-byte aligned
// (ops/paged_decode.py decode_smem_bytes mirrors the total; phase 1 of
// chip_smoke.py holds the two against each other). The tiles' region
// holds at least one chunk's partial records of all rep heads, which
// the merge loads there.
struct Layout {
  int q, qraw, k, v, sc, gst, stats, total;
};
__host__ __device__ __forceinline__ Layout layout(int rep, int DH, int C,
                                                  int esize) {
  const int mr = max_rep(rep);
  Layout o;
  int at = 0;
  o.q = at;     at += align16(pv_split(DH) * mr * DH * 4);   // [KQ][mr][DH]
  o.qraw = at;  at += esize == 4 ? 0 : align16(rep * DH * esize);
  const int tile = DH * row_stride(C, esize);
  const int recs = rep * record_floats(DH) * 4;
  const int tiles = 2 * tile > recs ? 2 * tile : recs;
  o.k = at;                                                  // [DH][C]
  o.v = at + tile;
  at += tiles;
  o.sc = at;    at += align16(mr * C * 4);                  // [mr][C] weights
  o.gst = at;   at += align16(2 * (C / kWarp) * mr * 4);    // [C/32][2][mr]
  o.stats = at; at += align16(rep * 3 * 4);           // [rep] (m, l, alpha)
  o.total = at;
  return o;
}

// Chunks' records the merge loads in one round trip: as many as the
// tiles' region holds (at least 1).
__host__ __device__ __forceinline__ int merge_batch(int rep, int DH, int C,
                                                    int esize) {
  const Layout o = layout(rep, DH, C, esize);
  return (o.sc - o.k) / (rep * record_floats(DH) * 4);
}

// 16 bytes of cache elements as float32
template <typename T> struct Vec;
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

// Puts the first ncols columns of a [DH, TL] K and V tile pair (from
// element kv0 on, rows TL apart) in flight into shared memory rows rs
// bytes apart: every piece at once, 16 bytes where the rows are 16-byte
// aligned (T * esize % 16 == 0), else 8 or 4, and element by element
// for bfloat16 rows of odd T. K only when with_k.
template <typename T>
__device__ __forceinline__ void load_tiles(unsigned char* kt,
                                           unsigned char* vt, const T* k,
                                           const T* v, size_t kv0, int DH,
                                           int TL, int rs, int ncols,
                                           bool with_k) {
  constexpr int kE = sizeof(T);
  const int rb = TL * kE;                        // bytes of a cache row
  const int cb = rb % 16 == 0 ? 16 : rb % 8 == 0 ? 8 : rb % 4 == 0 ? 4 : kE;
  const int epp = cb / kE;                       // elements a piece
  const int ppr = (ncols + epp - 1) / epp;       // pieces a tile row
  const unsigned char* kg = reinterpret_cast<const unsigned char*>(k);
  const unsigned char* vg = reinterpret_cast<const unsigned char*>(v);
  // piece i = d * ppr + p of this thread, then every kThreads-th, with
  // (d, p) stepped rather than divided out
  const int dstep = kThreads / ppr;
  const int pstep = kThreads - dstep * ppr;
  int d = threadIdx.x / ppr;
  int p = threadIdx.x - d * ppr;
  for (; d < DH; d += dstep, p += pstep) {
    if (p >= ppr) {
      p -= ppr;
      ++d;
      if (d >= DH) break;
    }
    const size_t go = (kv0 + (size_t)d * TL + (size_t)p * epp) * kE;
    const int so = d * rs + p * cb;
    if (cb == 16) {
      if (with_k) cp_async16(kt + so, kg + go);
      cp_async16(vt + so, vg + go);
    } else if (cb == 8) {
      if (with_k) cp_async8(kt + so, kg + go);
      cp_async8(vt + so, vg + go);
    } else if (cb == 4) {
      if (with_k) cp_async4(kt + so, kg + go);
      cp_async4(vt + so, vg + go);
    } else {
      if (with_k)
        *reinterpret_cast<T*>(kt + so) = *reinterpret_cast<const T*>(kg + go);
      *reinterpret_cast<T*>(vt + so) = *reinterpret_cast<const T*>(vg + go);
    }
  }
}

// grid (n_chunks * G * B), chunk slowest; block kThreads; dynamic shared
// memory layout(...).total. MAXR = max_rep(rep): the heads every lane
// computes, their sums kept in registers. Layouts (all contiguous): q,
// out [B, H, DH]; k, v [B, G, DH, TL]; lens [n_lens] int32, n_lens 1
// (shared) or B; ws [B, G, n_chunks, rep, 4 + DH] float32 partials (m,
// l, 2 words of padding, acc); arrivals [B, G] int32, 0 between calls.
// ws and arrivals are read only when n_chunks > 1. mode 0 computes the
// function; 1-5 are the floors above.
template <typename T, int MAXR>
__global__ void __launch_bounds__(kThreads, 1) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ lens,
    T* __restrict__ out, float* __restrict__ ws, int* __restrict__ arrivals,
    int B, int H, int G, int DH, int TL, int C, int n_chunks, int n_lens,
    float scale_log2, int mode) {
  constexpr int kE = sizeof(T);
  constexpr int kVec = Vec<T>::N;
  // two sums a head (alternate products) where few heads would leave
  // the FMA chains long; one where the heads' chains interleave enough
  constexpr int kSums = MAXR < 8 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  const int rep = H / G;
  const Layout lay = layout(rep, DH, C, kE);
  float* qs = reinterpret_cast<float*>(smem + lay.q);
  T* qraw = reinterpret_cast<T*>(smem + lay.qraw);
  unsigned char* kt = smem + lay.k;
  unsigned char* vt = smem + lay.v;
  float* sc = reinterpret_cast<float*>(smem + lay.sc);
  float* gst = reinterpret_cast<float*>(smem + lay.gst);    // groups' (m, l)
  float* stat = reinterpret_cast<float*>(smem + lay.stats);

  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int chunk = blockIdx.x / (B * G);
  const int gb = blockIdx.x - chunk * (B * G);
  const int g = gb / B;
  const int b = gb - g * B;
  const int rs = row_stride(C, kE);
  const int c0 = chunk * C;                      // first column
  const int RD = rep * DH;
  const size_t q0 = ((size_t)b * H + (size_t)g * rep) * DH;

  if (mode == 5) return;
  // the q rows go first: they do not wait for the length (RD and q0 are
  // multiples of 8 elements, so every piece is 16 bytes and aligned)
  {
    T* dst = kE == 4 ? reinterpret_cast<T*>(qs) : qraw;
    for (int i = tid * kVec; i < RD; i += kThreads * kVec)
      cp_async16(dst + i, q + q0 + i);
  }
  const int len = lens[n_lens == 1 ? 0 : b];
  const bool blind = len <= 0;                   // sees no column
  const int n = blind ? TL : min(len, TL);       // the row's live columns
  if (c0 >= n) {                                 // block-uniform
    cp_async_wait_all();
    return;
  }
  const int nk = min(C, n - c0);                 // columns of this chunk
  const int n_live = (n + C - 1) / C;
  load_tiles(kt, vt, k, v, ((size_t)b * G + g) * DH * (size_t)TL + c0, DH,
             TL, rs, nk, !blind);
  cp_async_wait_all();
  __syncthreads();
  if (mode == 1) return;
  if (kE != 4) {                                 // widen the q rows
    for (int i = tid; i < RD; i += kThreads) qs[i] = to_f32(qraw[i]);
    __syncthreads();
  }

  // scores and the softmax state of each 32-column group, a group a
  // warp and a column a lane; every lane computes all heads of its
  // column. A group's weights are exp2(s - m_g) with m_g its own max
  // (rescaled in P.V); columns past nk weigh 0; a kv_len-0 row sees no
  // column: every score NEG_INF, m_g NEG_INF and every weight 1.
  const int KG = (nk + kWarp - 1) / kWarp;
  for (int u = warp; u < KG; u += kWarps) {
    const int j = u * kWarp + lane;
    const bool live = j < nk;
    float a[kSums][MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) a[0][r] = a[kSums - 1][r] = 0.f;
    if (live && !blind) {
#pragma unroll 2
      for (int d = 0; d < DH; d += 8) {
        float kk[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          kk[i] = to_f32(reinterpret_cast<const T*>(kt + (d + i) * rs)[j]);
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          const float4 qa = *reinterpret_cast<const float4*>(qs + r * DH + d);
          const float4 qb =
              *reinterpret_cast<const float4*>(qs + r * DH + d + 4);
          a[0][r] = fmaf(qa.x, kk[0], a[0][r]);
          a[0][r] = fmaf(qa.y, kk[1], a[0][r]);
          a[0][r] = fmaf(qa.z, kk[2], a[0][r]);
          a[0][r] = fmaf(qa.w, kk[3], a[0][r]);
          a[kSums - 1][r] = fmaf(qb.x, kk[4], a[kSums - 1][r]);
          a[kSums - 1][r] = fmaf(qb.y, kk[5], a[kSums - 1][r]);
          a[kSums - 1][r] = fmaf(qb.z, kk[6], a[kSums - 1][r]);
          a[kSums - 1][r] = fmaf(qb.w, kk[7], a[kSums - 1][r]);
        }
      }
    }
    float sv[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      const float dot = kSums == 2 ? a[0][r] + a[kSums - 1][r] : a[0][r];
      sv[r] = live && !blind ? dot * scale_log2 : kNegInf;
    }
    float m[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) m[r] = warp_max(sv[r]);
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      sv[r] = live ? exp2f(sv[r] - m[r]) : 0.f;
      if (r < rep && live) sc[r * C + j] = sv[r];
    }
#pragma unroll
    for (int r = 0; r < MAXR; ++r) sv[r] = warp_sum(sv[r]);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < rep) {
          gst[(2 * u) * MAXR + r] = m[r];
          gst[(2 * u + 1) * MAXR + r] = sv[r];
        }
      }
    }
  }
  __syncthreads();
  if (mode == 3) return;

  // P.V, lanes across dh: units (column part kq, 32 d), every head at
  // once; a part is whole 32-column groups, each group's sum scaled by
  // exp2(m_g - m) onto the chunk's max m. The sums go to the q rows'
  // region, free since the scores.
  const int ND = (DH + kWarp - 1) / kWarp;
  const int KQ = pv_split(DH);
  const int gpp = (KG + KQ - 1) / KQ;            // groups a part
  float* pv = qs;                                // [KQ][MAXR][DH]
  for (int u = warp; u < ND * KQ; u += kWarps) {
    const int kq = u / ND;
    const int d = (u - kq * ND) * kWarp + lane;
    if (d < DH) {
      const T* vrow = reinterpret_cast<const T*>(vt + d * rs);
      float mx[MAXR], acc[MAXR];
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        mx[r] = kNegInf;
        acc[r] = 0.f;
      }
      for (int gi = 0; gi < KG; ++gi) {
#pragma unroll
        for (int r = 0; r < MAXR; ++r)
          mx[r] = fmaxf(mx[r], gst[(2 * gi) * MAXR + r]);
      }
      for (int gi = kq * gpp; gi < min(KG, (kq + 1) * gpp); ++gi) {
        const int j0 = gi * kWarp;
        const int j1 = min(nk, j0 + kWarp);
        float ag[kSums][MAXR];
#pragma unroll
        for (int r = 0; r < MAXR; ++r) ag[0][r] = ag[kSums - 1][r] = 0.f;
        int j = j0;
#pragma unroll 4
        for (; j + kVec <= j1; j += kVec) {
          float vv[kVec];
          Vec<T>::load(vrow + j, vv);
#pragma unroll
          for (int r = 0; r < MAXR; ++r) {
#pragma unroll
            for (int i = 0; i < kVec; i += 4) {
              const float4 p4 =
                  *reinterpret_cast<const float4*>(sc + r * C + j + i);
              ag[0][r] = fmaf(p4.x, vv[i], ag[0][r]);
              ag[kSums - 1][r] = fmaf(p4.y, vv[i + 1], ag[kSums - 1][r]);
              ag[0][r] = fmaf(p4.z, vv[i + 2], ag[0][r]);
              ag[kSums - 1][r] = fmaf(p4.w, vv[i + 3], ag[kSums - 1][r]);
            }
          }
        }
        for (; j < j1; ++j) {
          const float vv = to_f32(vrow[j]);
#pragma unroll
          for (int r = 0; r < MAXR; ++r)
            ag[0][r] = fmaf(sc[r * C + j], vv, ag[0][r]);
        }
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          const float sum =
              kSums == 2 ? ag[0][r] + ag[kSums - 1][r] : ag[0][r];
          acc[r] = fmaf(exp2f(gst[(2 * gi) * MAXR + r] - mx[r]), sum, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
        if (r < rep) pv[(kq * MAXR + r) * DH + d] = acc[r];
    }
  }
  // the chunk's (m, l) per head from its groups'
  for (int r = tid; r < rep; r += kThreads) {
    float mc = kNegInf;
    for (int gi = 0; gi < KG; ++gi) mc = fmaxf(mc, gst[(2 * gi) * MAXR + r]);
    float lc = 0.f;
    for (int gi = 0; gi < KG; ++gi)
      lc = fmaf(exp2f(gst[(2 * gi) * MAXR + r] - mc),
                gst[(2 * gi + 1) * MAXR + r], lc);
    stat[2 * r] = mc;
    stat[2 * r + 1] = lc;
  }
  __syncthreads();
  if (mode == 4) return;

  // the chunk's outputs: the result itself when the row has one chunk,
  // else its partial records
  const int rec = record_floats(DH);
  const size_t base = (size_t)(b * G + g) * n_chunks;
  for (int i = tid; i < RD; i += kThreads) {
    const int r = i / DH;
    const int d = i - r * DH;
    float acc = pv[i];
    for (int kq = 1; kq < KQ; ++kq) acc += pv[kq * MAXR * DH + i];
    if (n_live == 1) {
      out[q0 + i] = from_f32<T>(__fdividef(acc, stat[2 * r + 1]));
    } else {
      float* rp = ws + ((base + chunk) * rep + r) * rec;
      rp[4 + d] = acc;
      if (d == 0) {
        rp[0] = stat[2 * r];
        rp[1] = stat[2 * r + 1];
      }
    }
  }
  if (n_live == 1 || mode == 2) return;

  // the merge: the last block of this (row, group) to arrive folds every
  // live chunk's partial (thread-fence reduction)
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&arrivals[b * G + g], 1) == n_live - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // running state: sums [rep][DH] in the q rows' region, (m, l, factor
  // of the old sums) per head in the stats; the records of a batch of
  // chunks land in the tiles' region in one round trip (cp.async.cg
  // reads L2, where the other blocks' fenced stores are), their factors
  // exp2(m_c - m) in the scores' region
  float* msum = qs;
  float* mst = stat;
  float* buf = reinterpret_cast<float*>(smem + lay.k);
  float* fac = sc;
  const int nbm = min(kWarp, merge_batch(rep, DH, C, kE));
  for (int i = tid; i < RD; i += kThreads) msum[i] = 0.f;
  for (int r = tid; r < rep; r += kThreads) {
    mst[r] = kNegInf;
    mst[rep + r] = 0.f;
  }
  for (int cb = 0; cb < n_live; cb += nbm) {
    const int nb = min(nbm, n_live - cb);
    const float* src = ws + (base + cb) * rep * rec;
    for (int i = tid; i < nb * rep * rec / 4; i += kThreads)
      cp_async16(buf + 4 * i, src + 4 * i);
    cp_async_wait_all();
    __syncthreads();
    // the online-softmax algebra, one thread a head (a kv_len-0 row
    // keeps m = NEG_INF: every factor 1, and the sums give the mean of V)
    for (int r = tid; r < rep; r += kThreads) {
      const float m_old = mst[r];
      float m = m_old;
      for (int c = 0; c < nb; ++c) m = fmaxf(m, buf[(c * rep + r) * rec]);
      const float alpha = exp2f(m_old - m);
      float l = mst[rep + r] * alpha;
      for (int c = 0; c < nb; ++c) {
        const float* rp = buf + (c * rep + r) * rec;
        const float f = exp2f(rp[0] - m);
        fac[c * rep + r] = f;
        l = fmaf(rp[1], f, l);
      }
      mst[r] = m;
      mst[rep + r] = l;
      mst[2 * rep + r] = alpha;
    }
    __syncthreads();
    for (int i = tid; i < RD; i += kThreads) {
      const int r = i / DH;
      const int d = i - r * DH;
      float acc = msum[i] * mst[2 * rep + r];
      for (int c = 0; c < nb; ++c)
        acc = fmaf(fac[c * rep + r], buf[(c * rep + r) * rec + 4 + d], acc);
      msum[i] = acc;
    }
    __syncthreads();
  }
  for (int i = tid; i < RD; i += kThreads)
    out[q0 + i] = from_f32<T>(__fdividef(msum[i], mst[rep + i / DH]));
  if (tid == 0) arrivals[b * G + g] = 0;
}

// lets an instantiation take `bytes` of dynamic shared memory on the
// current device: the attribute is set only when a launch needs more
// than it has been granted there
template <typename T, int MAXR>
cudaError_t allow_smem(int bytes) {
  static std::atomic<int> granted[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::atomic<int>& have = granted[dev & 63];
  if (bytes <= 48 * 1024 || bytes <= have.load()) return cudaSuccess;
  e = cudaFuncSetAttribute(decode_kernel<T, MAXR>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) have.store(bytes);
  return e;
}

// the launch's own refusals, apart from CUDA's error codes
constexpr cudaError_t kBadShape = static_cast<cudaError_t>(-1);
constexpr cudaError_t kNoWorkspace = static_cast<cudaError_t>(-2);
constexpr cudaError_t kSmemTooLarge = static_cast<cudaError_t>(-3);

bool shape_ok(int B, int H, int G, int DH, int TL, int C, int n_chunks,
              int n_lens) {
  if (!(B > 0 && G > 0 && H % G == 0 && H / G <= kMaxRep && DH > 0 &&
        DH % 8 == 0 && TL > 0 && C > 0 && C % kWarp == 0 &&
        (n_lens == 1 || n_lens == B)))
    return false;
  return n_chunks == (TL + C - 1) / C &&
         (long long)n_chunks * B * G <= 0x7fffffffLL;
}

template <typename T, int MAXR>
cudaError_t launch_r(const void* q, const void* k, const void* v,
                     const int* lens, void* out, float* ws, int* arrivals,
                     int B, int H, int G, int DH, int TL, int C, int n_chunks,
                     int n_lens, float scale, int mode, int smem,
                     cudaStream_t stream) {
  const cudaError_t e = allow_smem<T, MAXR>(smem);
  if (e != cudaSuccess) return e;
  decode_kernel<T, MAXR><<<n_chunks * G * B, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, static_cast<T*>(out), ws, arrivals, B,
      H, G, DH, TL, C, n_chunks, n_lens, scale * kLog2e, mode);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lens, void* out, float* ws, int* arrivals,
                   int B, int H, int G, int DH, int TL, int C, int n_chunks,
                   int n_lens, float scale, int mode, cudaStream_t stream) {
  // this library's runtime reports only its own calls; a refusal left
  // pending by an earlier call must not be read as this launch's
  (void)cudaGetLastError();
  if (!shape_ok(B, H, G, DH, TL, C, n_chunks, n_lens) || mode < 0 ||
      mode > 5)
    return kBadShape;
  if (n_chunks > 1 && (ws == nullptr || arrivals == nullptr))
    return kNoWorkspace;
  const int rep = H / G;
  const int smem = layout(rep, DH, C, (int)sizeof(T)).total;
  if (smem > kMaxSmem) return kSmemTooLarge;
#define PT_DECODE_LAUNCH(R)                                                 \
  return launch_r<T, R>(q, k, v, lens, out, ws, arrivals, B, H, G, DH, TL, \
                        C, n_chunks, n_lens, scale, mode, smem, stream)
  if (rep <= 1) PT_DECODE_LAUNCH(1);
  if (rep <= 2) PT_DECODE_LAUNCH(2);
  if (rep <= 4) PT_DECODE_LAUNCH(4);
  if (rep <= 8) PT_DECODE_LAUNCH(8);
  if (rep <= 16) PT_DECODE_LAUNCH(16);
  PT_DECODE_LAUNCH(kMaxRep);
#undef PT_DECODE_LAUNCH
}

}  // namespace

// dtype (q, k, v and out): 0 float32, 1 bfloat16. n_lens: 1 (one length
// for every row) or B. C columns a block, n_chunks = ceil(TL / C)
// (ops/paged_decode.py decode_plan); ws and arrivals as above (null when
// n_chunks is 1); mode as above. Returns cudaGetLastError() after the
// launch (0 on success), or -1 for shapes the kernel does not take, -2
// for a missing workspace, -3 for a chunk past the shared memory; the
// wrapper raises on anything but 0.
extern "C" int pt_decode_attention(const void* q, const void* k,
                                   const void* v, const void* lens,
                                   void* out, void* ws, void* arrivals,
                                   int B, int H, int G, int DH, int TL,
                                   int C, int n_chunks, int n_lens,
                                   float scale, int dtype, int mode,
                                   void* stream) {
  const int* ln = static_cast<const int*>(lens);
  float* wsp = static_cast<float*>(ws);
  int* ar = static_cast<int*>(arrivals);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(q, k, v, ln, out, wsp, ar, B, H, G, DH, TL, C,
                      n_chunks, n_lens, scale, mode, st);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(q, k, v, ln, out, wsp, ar, B, H, G, DH, TL, C,
                              n_chunks, n_lens, scale, mode, st);
  else
    e = kBadShape;
  return (int)e;
}

// A block's dynamic shared memory for rep query heads a group, head dim
// DH, C columns a chunk and esize-byte elements: the kernel's own layout,
// which ops/paged_decode.py decode_smem_bytes must equal.
extern "C" int pt_decode_smem(int rep, int DH, int C, int esize) {
  return layout(rep, DH, C, esize).total;
}

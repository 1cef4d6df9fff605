// Shared pieces of the float32 LSTM kernels for Hopper's tensor cores
// (lstm_fwd_bf16x3_sm90.cu, lstm_bwd_bf16x3_sm90.cu): a float32 product
// as three bf16 wgmma passes,
//   A B ~= (A1 B2 + A2 B1) + A1 B1,
//   A1 = bf16(A), A2 = bf16(A - A1), B1 = bf16(B), B2 = bf16(B - B1)
// (round to nearest even), with float32 accumulation; the two small
// passes go into an accumulator of their own, so that the tensor cores'
// rounding of each k-step's sum toward zero happens at the small
// passes' magnitude, not the product's.
//
// Both kernels hold their B operand (40 columns of W: the forward's
// columns of 10 units x 4 gates, the backward's rows of 40 units) whole
// on chip as B1 and B2, each as K-major [40 n x 64 k] tiles in the
// 128-byte swizzle, and take A from registers (wgmma m64n40k16 RS): its
// two halves live in global scratch planes written by their owners in
// the A fragment order (frag_word), double-buffered by step parity, and
// each consumer thread loads its fragments into a ring of S k-steps in
// registers (product_x3).

#pragma once

#include "rnn_common.cuh"
#include "sm90_pipeline.cuh"

namespace bf16x3 {

constexpr int kUnits = 10;                 // hidden units a block owns
constexpr int kCols = 4 * kUnits;          // wgmma N
constexpr int kAcc = kCols / 2;            // accumulator floats a thread
constexpr int kChunk = 64;                 // k (rows of B) a weight tile
constexpr int kConsumers = 2;              // warpgroups: 128 batch rows
constexpr int kBatchTile = 64 * kConsumers;
constexpr int kThreadsX3 = 128 * kConsumers;
constexpr uint32_t kWTileBytes = kCols * kChunk * 2;      // 5120
constexpr int kFrags = 128;                // uint4 fragments of an m64k16 A
constexpr int kCells = 5;                  // (row, unit) cells a thread
constexpr int kDefaultRing = 8;            // k-steps of fragments in flight
// the static shared memory the plans reserve beside the dynamic part
// (bias and peepholes, steps_to_run's word: under 300 bytes)
constexpr size_t kStaticReserve = 1024;

// weight tiles a half: ceil(K / 64) rounded up to even, so that the
// k-steps (4 a tile) are a multiple of either ring depth (4, 8); the
// tiles past K are zero
__host__ __device__ inline int n_chunks(int K) {
  return ((K + kChunk - 1) / kChunk + 1) / 2 * 2;
}

__host__ __device__ inline size_t dyn_smem(int K) {
  return 1024 + 2 * (size_t)n_chunks(K) * kWTileBytes;
}

// byte offset of element (n, kc) (column n < 40, k offset kc < 64) in a
// [40, 64] bf16 K-major tile with the 128-byte swizzle: 8-row atoms of
// 1024 bytes, the 16-byte chunk c of row n at chunk c ^ (n % 8)
__device__ __forceinline__ uint32_t wtile_off(int n, int kc) {
  const int r = n & 7;
  return (n >> 3) * 1024 + r * 128 + ((((kc >> 3) ^ r) & 7) << 4) +
         (kc & 7) * 2;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// eight float32 values of one tile row as their two bf16 halves (16
// bytes each) at byte `off` of the W1 and W2 tile sets
__device__ __forceinline__ void put_w8(uint8_t* w1s, uint8_t* w2s,
                                       uint32_t off, const float (&v)[8]) {
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = sm90::pack_bf16(v[2 * i], v[2 * i + 1]);
    lo[i] = sm90::pack_bf16(v[2 * i] - bf16_round(v[2 * i]),
                            v[2 * i + 1] - bf16_round(v[2 * i + 1]));
  }
  *reinterpret_cast<uint4*>(w1s + off) = make_uint4(hi[0], hi[1], hi[2],
                                                    hi[3]);
  *reinterpret_cast<uint4*>(w2s + off) = make_uint4(lo[0], lo[1], lo[2],
                                                    lo[3]);
}

// The 32-bit word of a fragment-order plane ([m-tile][k-step][warp]
// [lane][4 words], nks k-steps) that holds row r's bf16 pair (k, k + 1),
// k even: register hi + 2 (kk / 8) of lane 4 (r % 8) + (kk % 8) / 2 of
// warp (r / 16) % 4, with hi = (r / 8) % 2 and kk = k % 16 (the m64k16
// A fragment map of sm90_pipeline.cuh).
__device__ __forceinline__ size_t frag_word(int r, int k, int nks) {
  const int kk = k & 15;
  const int lane = (r & 7) * 4 + ((kk & 7) >> 1);
  const int reg = ((r >> 3) & 1) + 2 * (kk >> 3);
  return ((((size_t)(r >> 6) * nks + (k >> 4)) * 4 + ((r >> 4) & 3)) * 32 +
          lane) * 4 + reg;
}

// values a (at k, k even) and b (at k + 1) of one row into both halves'
// planes at word `word`
__device__ __forceinline__ void put_pair(uint32_t* p1, uint32_t* p2,
                                         size_t word, float a, float b) {
  p1[word] = sm90::pack_bf16(a, b);
  p2[word] = sm90::pack_bf16(a - bf16_round(a), b - bf16_round(b));
}

// one value at k into both halves' planes (half k % 2 of its word)
__device__ __forceinline__ void put_one(uint32_t* p1, uint32_t* p2,
                                        size_t word, int k, float a) {
  const __nv_bfloat16 a1 = __float2bfloat16_rn(a);
  const __nv_bfloat16 a2 = __float2bfloat16_rn(a - __bfloat162float(a1));
  reinterpret_cast<__nv_bfloat16*>(p1 + word)[k & 1] = a1;
  reinterpret_cast<__nv_bfloat16*>(p2 + word)[k & 1] = a2;
}

// d (+)= A B, m64n40k16 bf16 -> f32, A from registers (the m64k16
// fragment a), B K-major from shared memory
__device__ __forceinline__ void wgmma_n40(float (&d)[kAcc], const uint4& a,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "l"(db), "r"(1));
}

// acc_s (+)= A1 B2 + A2 B1 and acc_b (+)= A1 B1 over the nks k-steps of
// one 64-row m-tile. p1, p2: the thread's fragments of k-step 0 in the
// A1 and A2 planes (a k-step further is kFrags uint4 on); w1s, w2s: the
// resident halves. The ring of S k-steps of fragments: the loads of
// k-step ks + S - 1 go out as soon as the products of k-step ks - 1 are
// done (one commit group in flight), through L2 (ld.global.cg: other
// blocks wrote the planes in this launch). nks is a multiple of S.
// Without `Stream` the first S k-steps' fragments are loaded once and
// used over and over: the products alone (a floor).
template <int S, bool Stream = true>
__device__ __forceinline__ void product_x3(float (&acc_s)[kAcc],
                                           float (&acc_b)[kAcc],
                                           const uint4* p1, const uint4* p2,
                                           const uint8_t* w1s,
                                           const uint8_t* w2s, int nks) {
  uint4 f1[S], f2[S];
#pragma unroll
  for (int s = 0; s < (Stream ? S - 1 : S); ++s) {
    f1[s] = __ldcg(p1 + s * kFrags);
    f2[s] = __ldcg(p2 + s * kFrags);
  }
  for (int k0 = 0; k0 < nks; k0 += S) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int ks = k0 + s;
      const uint32_t off = (ks >> 2) * kWTileBytes;
      const uint64_t d1 = sm90::desc_k(w1s + off, ks & 3);
      const uint64_t d2 = sm90::desc_k(w2s + off, ks & 3);
      sm90::wgmma_fence();
      wgmma_n40(acc_s, f1[s], d2);
      wgmma_n40(acc_s, f2[s], d1);
      wgmma_n40(acc_b, f1[s], d1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();           // k-step ks - 1 is done: its slot
      const int kn = ks + S - 1;       // takes k-step ks + S - 1
      if (Stream && kn < nks) {
        f1[(s + S - 1) % S] = __ldcg(p1 + (size_t)kn * kFrags);
        f2[(s + S - 1) % S] = __ldcg(p2 + (size_t)kn * kFrags);
      }
    }
  }
  sm90::wgmma_wait<0>();
}

// The same loads, S k-steps at a time, folded into a word so that they
// are not dropped: the stream alone (a floor)
template <int S>
__device__ __forceinline__ uint32_t stream_only(const uint4* p1,
                                                const uint4* p2, int nks) {
  uint32_t x = 0u;
  for (int k0 = 0; k0 < nks; k0 += S) {
    uint4 f1[S], f2[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      f1[s] = __ldcg(p1 + (size_t)(k0 + s) * kFrags);
      f2[s] = __ldcg(p2 + (size_t)(k0 + s) * kFrags);
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
      x ^= f1[s].x ^ f1[s].y ^ f1[s].z ^ f1[s].w ^ f2[s].x ^ f2[s].y ^
           f2[s].z ^ f2[s].w;
  }
  return x;
}

// two adjacent float32 values at p (a thread's unit pair): one 8-byte
// access when `pair` (both owned, 8-byte aligned), else one by one for
// the first n
__device__ __forceinline__ float2 ld_pair(const float* p, int n, bool pair) {
  if (pair) return __ldg(reinterpret_cast<const float2*>(p));
  return make_float2(n > 0 ? __ldg(p) : 0.f, n > 1 ? __ldg(p + 1) : 0.f);
}

__device__ __forceinline__ void st_pair(float* p, float a, float b, int n,
                                        bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    if (n > 0) p[0] = a;
    if (n > 1) p[1] = b;
  }
}

// 1 / (1 + e^-x) through __fdividef, as lstm_fwd_sm90.cu (the form that
// was built free of C7518 there)
__device__ __forceinline__ float sigmoid_fd(float x) {
  return __fdividef(1.f, 1.f + expf(-x));
}

}  // namespace bf16x3

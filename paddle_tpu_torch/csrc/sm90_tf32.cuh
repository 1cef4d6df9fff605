// Hopper (sm_90a) building blocks of the float32 flash-attention
// kernels on the tensor cores (flash_fwd_tf32_sm90.cu,
// flash_dq_tf32_sm90.cu, flash_dkv_tf32_sm90.cu): float32-accurate
// products as three TF32 wgmma products (3xTF32), all inline PTX, no
// library.
//
// The split. Each float32 operand x is held as two TF32 values,
//   hi = rna_tf32(x),  lo = rna_tf32(x - hi)  (to_tf32 below),
// and a product a.b as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b on a float32
// accumulator (lo_a.lo_b, ~2^-22 of a.b, is dropped): about float32
// accuracy at a third of the tensor cores' TF32 rate, still above the
// SIMT float32 units'. A tile is split once, when it lands in shared
// memory (split_tile: hi and lo at the same offsets of two buffers,
// hi in place where the tile stays put); an operand that comes from an
// accumulator is split in registers.
//
// Tiles. A float32 tile is the bf16 kernels' tile (sm90_pipeline.cuh)
// at half the columns: rows of 128 bytes, 32 floats, written by the TMA
// with the 128-byte swizzle (16-byte chunk c of row r at chunk
// c ^ (r % 8)) at a 1024-byte-aligned address; a head dim above 32
// takes more such panels, a panel every 32 columns. Rows past T and
// columns past d arrive as zeros. The K-major descriptor (desc_k) is
// the bf16 one: a TF32 k-step of 8 floats is 32 bytes, as a bf16 one
// of 16 values is.
//
// TF32 wgmma takes both shared-memory operands K-major only: the
// transpose bits exist for 16-bit types. So a product that contracts
// over tokens (O = P V, dQ = dS K, dV = P^T dO, dK = dS^T Q) reads a
// transposed copy of the token tile, rows = d, one 128-byte row holding
// the tile's tokens (transpose_tile). TMA cannot transpose a 32-bit
// tile; the copy is written from the tile the TMA loaded, split on the
// way.
//
// Register A operands. The m64k8 TF32 A fragment of lane l (g = l / 4,
// t = l % 4) holds a0 (row g, k t), a1 (row g + 8, k t), a2 (row g,
// k t + 4), a3 (row g + 8, k t + 4) of its warp's 16 rows; an f32
// accumulator's d[4j + 2h + e] holds (row g + 8h, column 8j + 2t + e).
// They do not map onto each other, but the order of the contraction
// does not matter: column 8j + 2t of the accumulator goes to a0 / a1
// (k t) and column 8j + 2t + 1 to a2 / a3 (k t + 4), so k-step j reads
// tokens 8j + 0, 2, 4, 6, 1, 3, 5, 7 at k 0..7, and the transposed B
// copy stores its tokens in that order (transpose_tile). No shuffle,
// no staging through shared memory.

#pragma once

#include "sm90_pipeline.cuh"

namespace tf32 {

using namespace sm90;

constexpr int kCols = 32;                   // float32 columns of a panel
constexpr uint32_t kRowBytes = 128;

// The map of a float32 [B, T, H, D] tensor, innermost first (d, h, t,
// b), box 32 x 1 x rows x 1, 128-byte swizzle, zero fill out of bounds
// (D % 8 == 0 keeps every stride a multiple of 16 bytes).
inline bool make_bthd_map_f32(CUtensorMap* map, const void* ptr, int B,
                              int T, int H, int D, int rows) {
  EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 4, (cuuint64_t)H * D * 4,
                                 (cuuint64_t)T * H * D * 4};
  const cuuint32_t box[4] = {kCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// byte offset of (row r, column c < 32) in a swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)r * kRowBytes + ((((uint32_t)c >> 2) ^ (r & 7)) << 4) +
         (((uint32_t)c & 3) << 2);
}

// x rounded to TF32, to nearest with ties away from zero: what
// cvt.rna.tf32.f32 computes for a finite x, in two integer operations
// on the bit pattern, which the SM issues at a higher rate than the
// conversion instruction
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// barrier over `count` threads (a warpgroup), not the whole block; the
// non-aligned form, so lanes that diverged before it need not reconverge
__device__ __forceinline__ void group_sync(int id, int count) {
  asm volatile("barrier.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Split a tile of PANELS panels of ROWS rows, as the TMA wrote it at
// `src`, into hi and lo at the same offsets from `hi` and `lo` (`src`
// may be `hi`: in place). Thread t of n. The split is elementwise, so
// the swizzle does not matter here.
template <int ROWS, int PANELS>
__device__ __forceinline__ void split_tile(const uint8_t* src, uint8_t* hi,
                                           uint8_t* lo, int t, int n) {
  constexpr int kChunks = PANELS * ROWS * (kRowBytes / 16);
  for (int i = t; i < kChunks; i += n) {
    const float4 v = *reinterpret_cast<const float4*>(src + 16 * i);
    uint4 h, l;
    split(v.x, h.x, l.x);
    split(v.y, h.y, l.y);
    split(v.z, h.z, l.z);
    split(v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + 16 * i) = h;
    *reinterpret_cast<uint4*>(lo + 16 * i) = l;
  }
}

// The transposed copy, split, of a token tile as the TMA wrote it at
// `src` (ROWS tokens x PANELS panels of d): row n of `tr` is column n
// of the tile (n < 32 PANELS; rows continue across panels at 128 bytes
// each), its tokens in the k order of the header note. hi and lo go to
// columns which*ROWS .. of the copy: with ROWS 32 the lo copy is the
// next panel of `panel_bytes` (64 rows a 64-column output panel), with
// ROWS 16 it shares hi's rows, at columns 16..31. Lanes run along n:
// the 8 strided reads of a lane and the float4 writes of a quarter warp
// fall on distinct banks.
template <int ROWS, int PANELS>
__device__ __forceinline__ void transpose_tile(const uint8_t* src,
                                               uint8_t* tr,
                                               uint32_t panel_bytes, int t,
                                               int n) {
  static_assert(ROWS == 16 || ROWS == 32, "token tiles of 16 or 32 rows");
  constexpr int kD = kCols * PANELS;
  constexpr int kItems = kD * (ROWS / 8);
  for (int i = t; i < kItems; i += n) {
    const int d = i % kD;
    const int grp = i / kD;                  // tokens 8 grp .. 8 grp + 7
    const uint8_t* s = src + (uint32_t)(d / kCols) * ROWS * kRowBytes;
    const int c = d % kCols;
    uint32_t e[2][8];                        // hi, lo
#pragma unroll
    for (int m = 0; m < 8; ++m)
      split(*reinterpret_cast<const float*>(s + swz(8 * grp + m, c)),
            e[0][m], e[1][m]);
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const int colw = which * ROWS;
      uint8_t* dst = tr + (colw / kCols) * panel_bytes;
      const int col = colw % kCols + 8 * grp;
      const uint32_t* x = e[which];
      *reinterpret_cast<uint4*>(dst + swz(d, col)) =
          make_uint4(x[0], x[2], x[4], x[6]);
      *reinterpret_cast<uint4*>(dst + swz(d, col + 4)) =
          make_uint4(x[1], x[3], x[5], x[7]);
    }
  }
}

// The start of the hi (which 0) or lo (1) copy in a transposed tile
// of ROWS tokens written by transpose_tile at `tr`; output panel pn
// (64 rows of d) of it. desc_k(.., kk) then steps 8 tokens.
template <int ROWS>
__device__ __forceinline__ const uint8_t* tr_part(const uint8_t* tr,
                                                  uint32_t panel_bytes,
                                                  int which, int pn) {
  const int colw = which * ROWS;
  return tr + (colw / kCols) * panel_bytes + pn * 64 * kRowBytes +
         4 * (colw % kCols);
}

// The accumulator's 8-column chunk j as the TF32 A fragment of k-step
// j (the header note), split: hi[4j + r], lo[4j + r]
template <int N>
__device__ __forceinline__ void split_a(const float (&d)[N],
                                        uint32_t (&hi)[N],
                                        uint32_t (&lo)[N]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    split(d[4 * j + 0], hi[4 * j + 0], lo[4 * j + 0]);
    split(d[4 * j + 2], hi[4 * j + 1], lo[4 * j + 1]);
    split(d[4 * j + 1], hi[4 * j + 2], lo[4 * j + 2]);
    split(d[4 * j + 3], hi[4 * j + 3], lo[4 * j + 3]);
  }
}

// d += A B, m64n16k8 / m64n32k8 / m64n64k8 TF32, both operands K-major
// in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d += A B, m64n64k8 TF32, A from registers (a[0..3], the fragment of
// the header note), B K-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The two small passes of a 3xTF32 k-step, d += lo_a.hi_b + hi_a.lo_b
// (A and B split in shared memory: descriptors of hi and lo); the
// large pass is wgmma_ss(d, a_hi, b_hi). The tensor cores round each
// accumulation toward zero at the accumulator's magnitude, so a
// product issues all its small passes first and its large ones last:
// the small ones then add to a small sum.
template <int N>
__device__ __forceinline__ void mma_small_ss(float (&d)[N], uint64_t a_hi,
                                             uint64_t a_lo, uint64_t b_hi,
                                             uint64_t b_lo) {
  wgmma_ss(d, a_lo, b_hi);
  wgmma_ss(d, a_hi, b_lo);
}

// the same with A split in registers (split_a)
__device__ __forceinline__ void mma_small_rs(float (&d)[32],
                                             const uint32_t* a_hi,
                                             const uint32_t* a_lo,
                                             uint64_t b_hi, uint64_t b_lo) {
  wgmma_rs(d, a_lo, b_hi);
  wgmma_rs(d, a_hi, b_lo);
}

}  // namespace tf32

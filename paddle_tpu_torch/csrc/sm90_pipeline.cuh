// Hopper (sm_90a) building blocks of the tensor-core kernels
// (flash_fwd_sm90.cu, flash_dq_sm90.cu, flash_dkv_sm90.cu,
// lstm_fwd_sm90.cu, lstm_bwd_sm90.cu), all inline PTX, no library:
//
//   - a 4-D TMA tensor map over the layer's [b, T, h, d] bf16 layout,
//     encoded on the host through cudaGetDriverEntryPoint (no -lcuda);
//   - a 3-D one over the LSTM kernels' [planes, rows, cols] state scratch;
//   - mbarrier init / arrive / expect-tx / parity wait;
//   - cp.async.bulk.tensor 3-D and 4-D loads that complete on an
//     mbarrier, and the proxy fences that order generic stores before
//     them (another block's global stores, this block's shared ones);
//   - shared-memory matrix descriptors for the 128-byte swizzle,
//     K-major and MN-major;
//   - wgmma fence / commit / wait, m64n64k16 bf16 -> f32 in SS and RS
//     form, and m64n16k16 SS (the LSTM's narrow product);
//   - the accumulator-fragment <-> (row, col) map, and packing an f32
//     accumulator into bf16 A-register fragments.
//
// Tiles. Every operand tile is one box of the tensor map: 64 rows (T)
// x 64 columns (d) of bf16, 128 bytes a row, 8 KB, written by the TMA
// with the 128-byte swizzle (the 16-byte chunk c of row r lands at
// chunk c ^ (r % 8)) at a 1024-byte-aligned address. A head dim above
// 64 takes a second such panel (columns 64..127). Rows past T (per
// batch row: the map has its own b axis) and columns past d read as
// zeros, so a ragged T or d % 64 != 0 needs no bounds check and adds
// nothing to a product.
//
// Descriptors over such a panel (PTX ISA "matrix descriptor"; the
// canonical layouts of CUTLASS's make_gmma_desc):
//   - K-major (the contraction runs along d, contiguous): 8-row groups
//     1024 B apart (SBO), LBO unused (1); the k-th 16-column step adds
//     32 B to the start address inside the swizzled row.
//   - MN-major (the contraction runs along the rows, T): 64 columns of
//     one panel are one swizzle atom along N; groups of 8 rows 1024 B
//     apart (SBO); the k-th 16-row step adds 2048 B to the start.
//     Products never span two panels in N, so LBO is never read.
//
// Fragments of an m64nN f32 accumulator d[N/2] in the warpgroup's
// thread t (warp w = t / 32, lane l): d[4j + 2h + e] holds row
// 16w + l/4 + 8h, column 8j + 2(l%4) + e. Its 16-column chunk kk,
// d[8kk .. 8kk+7], is exactly the A fragment of an m64k16 RS product
// over those 16 columns: pack d[8kk + 2r], d[8kk + 2r + 1] into
// register r (r < 4) with __floats2bfloat162_rn.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int kRows = 64;                    // rows of a tile (one box)
constexpr int kPanel = 64;                   // bf16 columns of a panel
constexpr uint32_t kTileBytes = kRows * kPanel * 2;   // 8192

// ------------------------------------------------------------ host side
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime (at the
// first launch, outside any graph capture).
inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The map of a bf16 [B, T, H, D] tensor, innermost first: (d, h, t, b)
// with strides (2, 2D, 2HD, 2THD) bytes, box 64 x 1 x 64 x 1, 128-byte
// swizzle, zero fill out of bounds. D % 8 == 0 keeps every stride a
// multiple of 16 bytes, as the TMA requires.
inline bool make_bthd_map(CUtensorMap* map, const void* ptr, int B, int T,
                          int H, int D) {
  EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)T * H * D * 2};
  const cuuint32_t box[4] = {kPanel, 1, kRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of a bf16 [planes, rows, cols] buffer with a row pitch of
// `pitch` elements (pitch % 8 == 0: 16-byte strides, as the TMA needs),
// innermost first (cols, rows, planes); box 64 columns x 64 rows x 1
// plane, 128-byte swizzle, zero fill past cols and rows. The LSTM
// kernels' state streams (lstm_fwd_sm90.cu, lstm_bwd_sm90.cu).
inline bool make_rows_map(CUtensorMap* map, const void* ptr, int cols,
                          int rows, int planes, int pitch) {
  EncodeTiledFn encode = encode_fn();
  if (encode == nullptr || pitch % 8 != 0) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)pitch * 2,
                                 (cuuint64_t)rows * pitch * 2};
  const cuuint32_t box[3] = {kPanel, kRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------- device side
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after p (the swizzle atom's
// alignment); callers size dynamic shared memory with 1024 B of slack
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async (TMA) proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one arrival that also announces `bytes` of TMA traffic for the phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed. A phase that
// never completes (bytes or arrivals miscounted) traps after ~2^35
// cycles (over 10 s) rather than hang the card: the launch then fails
// with an error the wrapper raises.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  do {
    if (clock64() - start > (1ll << 35)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of `map` at element coordinates (d0, h, t0, b) into the
// 1024-byte-aligned tile `dst`; completes kTileBytes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d0, int h,
                                         int t0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(h), "r"(t0), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

// one box of a 3-D `map` at element coordinates (c0, c1, c2) into the
// 1024-byte-aligned `dst`; completes the box's bytes on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// order this thread's generic-proxy global accesses against async-proxy
// (TMA) accesses: on the writer after its stores, on the reader between
// the acquire that made them visible and its TMA loads
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// the same for shared memory written with generic stores and then read
// by wgmma (which reads shared memory through the async proxy)
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// 128-byte-swizzle descriptor: start >> 4 in bits 0-13, LBO >> 4 in
// 16-29, SBO >> 4 in 32-45, base offset 0 (1024-aligned atoms), layout
// type 1 (128B swizzle) in bits 62-63
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

// K-major operand: 16-column step kk (< 4) of a panel at `tile`
__device__ __forceinline__ uint64_t desc_k(const void* tile, int kk) {
  return desc_sw128(smem_u32(tile) + 32u * kk, 16u, 1024u);
}

// MN-major operand: 16-row step kk (< 4) of a panel at `tile`
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int kk) {
  return desc_sw128(smem_u32(tile) + 2048u * kk, kTileBytes, 1024u);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A B, m64n64k16, A and B from shared memory (A K-major; B
// K-major when TransB == 0, MN-major when 1); scale_d == 0 overwrites d
template <int TransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TransB));
}

// d (+)= A B, m64n64k16, A from registers (a[0..3], the fragment map
// above), B from shared memory (K-major when TransB == 0, MN-major 1)
template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TransB));
}

// d (+)= A B, m64n16k16, A and B from shared memory, both K-major (the
// fragment map below with j < 2: d[8])
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// (row, col) of accumulator register i for lane l of warp w of the
// warpgroup: the map of the header note
__device__ __forceinline__ int frag_row(int i, int w, int l) {
  return 16 * w + l / 4 + 8 * ((i >> 1) & 1);
}

__device__ __forceinline__ int frag_col(int i, int l) {
  return 8 * (i >> 2) + 2 * (l % 4) + (i & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the 64-column accumulator d as four m64k16 A fragments: a[4kk + r]
__device__ __forceinline__ void pack_a(const float (&d)[32],
                                       uint32_t (&a)[16]) {
#pragma unroll
  for (int r = 0; r < 16; ++r) a[r] = pack_bf16(d[2 * r], d[2 * r + 1]);
}

}  // namespace sm90

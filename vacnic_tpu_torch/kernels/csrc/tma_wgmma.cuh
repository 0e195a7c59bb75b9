// Device and host pieces of the TMA-fed wgmma kernels (gemm_bf16.cu,
// lm_head.cu): both operands of a wgmma product in shared memory, tiles
// brought in by the Tensor Memory Accelerator (cp.async.bulk.tensor) and
// paced by mbarriers, the tensor maps encoded on the host and cached.
//
// Tiles are the 128-byte-swizzled [rows][64] bf16 tiles of attn_tiles.cuh:
// a TMA box of 64 columns x `rows` with CU_TENSOR_MAP_SWIZZLE_128B lands in
// exactly that layout, and wgmma_tile_desc describes it as the K-major
// operand.

#pragma once

#include <dlfcn.h>
#include <stdint.h>
#include <mutex>
#include <cuda.h>
#include <cuda_runtime.h>

namespace tma_wgmma {

// Waits until at most N committed wgmma groups of the warpgroup are running.
template <int N>
__device__ __forceinline__ void wgmma_wait_pending() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The compiler may not move a use of the accumulators across this point.
template <int J>
__device__ __forceinline__ void pin(float (&acc)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[j][e])::"memory");
  }
}

// One asynchronous m64n64k16 step of the warpgroup, d (+)= a * b, both
// operands through shared-memory descriptors: a [64 x 16] K-major (rows = m,
// 16 k contiguous); b [16 x 64] K-major (TRANS_B 0: rows = n, 16 k
// contiguous) or MN-major (TRANS_B 1: rows = k, n contiguous; the
// instruction transposes it). d[j] is the D-layout tile (attn_tiles.cuh) of
// columns 8j..8j+7 of the warp's 16 rows. With accumulate == 0 the old d is
// ignored.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t adesc, uint64_t bdesc,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(adesc), "l"(bdesc), "r"(accumulate), "n"(TRANS_B));
}

// The same step with n = 128: d[j] covers columns 8j..8j+7, j < 16.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t adesc, uint64_t bdesc,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(adesc), "l"(bdesc), "r"(accumulate), "n"(TRANS_B));
}

// ---- mbarriers ----

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Spins until the barrier's phase of parity `parity` has completed. A wait
// that outlasts every honest one (seconds) traps: a lost arrival then fails
// the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (unsigned spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1u << 28)) __trap();
  }
}

// The producer's arrival on a full barrier, announcing `bytes` of TMA data.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// An arrival on a barrier of this block.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrives on the barrier at the same shared-memory offset in block `rank` of
// the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, int rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

// ---- TMA ----

// One TMA box (coordinates c0 = fastest dimension, c1) into this block's
// shared memory at `dst`; the barrier `bar` is credited with the box's bytes
// (what lies outside the tensor arrives as zeros and counts too).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The same box into shared memory at the same offset of every block of the
// cluster whose bit is set in `mask`; each receiver's barrier at the offset
// of `bar` is credited with the bytes.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map, int c0,
                                                   int c1, uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar), "h"(mask)
      : "memory");
}

// ---- host ----

// Tensor maps of a row-major bf16 matrix [rows, cols] cut into boxes of
// box_rows x 64 columns with the 128-byte swizzle, kept by (pointer, shape,
// box): encoding is host work, and weights and activations come back at the
// same addresses launch after launch. What lies outside the matrix reads as 0.
// Each source that includes this header keeps its own cache.
struct MapCache {
  struct Entry {
    const void* ptr = nullptr;
    int rows = 0, cols = 0, box_rows = 0;
    CUtensorMap map;
  };
  static constexpr int SIZE = 256;
  Entry entries[SIZE];
  std::mutex lock;
  using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  EncodeFn encode = nullptr;

  cudaError_t get(const void* ptr, int rows, int cols, int box_rows, CUtensorMap* out) {
    std::lock_guard<std::mutex> guard(lock);
    if (encode == nullptr) {  // from the libcuda that the CUDA runtime has already loaded
      void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
      void* fn = lib ? dlsym(lib, "cuTensorMapEncodeTiled") : nullptr;
      if (fn == nullptr) return cudaErrorNotSupported;
      encode = reinterpret_cast<EncodeFn>(fn);
    }
    const size_t h = (reinterpret_cast<size_t>(ptr) >> 9) * 31 + rows * 7 + cols + box_rows;
    Entry& en = entries[h % SIZE];
    if (en.ptr != ptr || en.rows != rows || en.cols != cols || en.box_rows != box_rows) {
      const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
      const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
      const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
      const cuuint32_t elem[2] = {1, 1};
      CUresult r = encode(&en.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                          dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
      if (r != CUDA_SUCCESS) {
        en.ptr = nullptr;
        return cudaErrorInvalidValue;
      }
      en.ptr = ptr;
      en.rows = rows;
      en.cols = cols;
      en.box_rows = box_rows;
    }
    *out = en.map;
    return cudaSuccess;
  }
};

}  // namespace tma_wgmma

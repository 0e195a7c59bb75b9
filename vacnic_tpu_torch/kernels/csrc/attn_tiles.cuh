// Device-side building blocks of the tensor-core attention kernels
// (flash_attn.cu, enc_attention.cu): bf16 products of one warpgroup (four
// warps, 64 query rows, 16 a warp) on 64-wide tiles, with every score,
// probability and output element in registers.
//
// Taken: wgmma.mma_async m64n64k16 with A from registers and B from shared
// memory, for both products. A first version used mma.sync.m16n8k16 with
// ldmatrix: there each warp fetched its own copy of every K and V tile
// (32 KB of shared-memory reads per 8 KB tile and block) and issued eight
// mma per k-step; wgmma reads a tile once per block, takes one instruction
// per k-step and runs while the warp does something else. Its register
// layouts per warp are those of mma.sync m16n8k16, so a row's softmax
// statistics live in one quad of lanes and the accumulator of Q K^T is,
// element for element, the A operand of P V.
//
// Lane naming used below: g = lane / 4 (0..7), t = lane % 4 (0..3).
//
// Register layouts of wgmma m64nNk16, per warp (its 16 of the 64 rows; each
// 32-bit register holds two bf16, the lower index in the low half):
//   A [16 x 16]:  a0 = (row g,     k 2t, 2t+1)   a1 = (row g + 8, k 2t, 2t+1)
//                 a2 = (row g,     k 2t+8, +9)   a3 = (row g + 8, k 2t+8, +9)
//   D [16 x 8] tile j (columns 8j..8j+7), f32:
//                 d0, d1 = (row g,     col 8j + 2t, + 1)
//                 d2, d3 = (row g + 8, col 8j + 2t, + 1)
// So two neighbouring 8-key score tiles (D layout), rounded to bf16 pairs,
// are exactly a0..a3 of the 16-key A operand of P V: probabilities never
// pass through shared memory.
//
// Shared-memory tiles are [rows][64] bf16: 128 bytes, eight 16-byte chunks,
// a row. Chunk c of row r is stored at chunk c ^ (r & 7): this is wgmma's
// 128-byte swizzle (a tile is both its "K-major" operand, rows = n, and,
// transposed, its "MN-major" operand, rows = k), and a row written by eight
// neighbouring cp.async lanes is free of bank conflicts.
//
// ptxas (CUDA 12.8) has been seen to give the A registers of one wgmma
// sequence to another that sits in a branch of the same loop; keep every
// sequence in straight-line loop bodies (see enc_attention.cu).

#pragma once

#include <stdint.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_state.cuh"

namespace attn_tiles {

constexpr int TILE_BYTES_PER_ROW = 128;  // 64 bf16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma's 128-byte swizzle works on address bits, so a tile starts on a
// 1024-byte boundary. Dynamic shared memory promises less: a kernel asks for
// TILE_ALIGN bytes more than it uses and rounds the base up.
constexpr int TILE_ALIGN = 1024;

__device__ __forceinline__ unsigned char* align_tiles(unsigned char* smem) {
  return smem + ((TILE_ALIGN - smem_u32(smem)) & (TILE_ALIGN - 1));
}

// Byte offset of 16-byte chunk `chunk` (0..7) of row `row` in a swizzled tile.
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return static_cast<uint32_t>(row * TILE_BYTES_PER_ROW + ((chunk ^ (row & 7)) << 4));
}

// 16-byte asynchronous copy global -> shared, through L2 only (.cg): the
// tiles are read once per block. Both addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One thread's share of the copies of 64 x 64 bf16 tiles (global rows
// `stride` elements apart) into swizzled shared tiles, THREADS threads
// together: the thread copies chunk tid % 8 of rows tid / 8 + i THREADS / 8.
// The global address and the swizzled offset are worked out once; a copy
// then costs an add per chunk, and the walk to the next tile one more.
// THREADS / 8 is a multiple of 8, so every row of a thread swizzles alike.
template <int THREADS>
struct TileLoader {
  static_assert(THREADS % 64 == 0 && THREADS <= 512, "a whole number of 8-row groups");
  const __nv_bfloat16* src;  // the thread's first chunk of the next tile to copy
  long long row_step;        // elements between the thread's consecutive chunks
  uint32_t dst;              // swizzled byte offset of its first chunk in a tile

  __device__ __forceinline__ void init(const __nv_bfloat16* tile0, long long stride, int tid) {
    src = tile0 + (tid >> 3) * stride + (tid & 7) * 8;
    row_step = (THREADS / 8) * stride;
    dst = swz(tid >> 3, tid & 7);
  }
  // Starts the copy of the tile at `src` into shared address `tile`.
  __device__ __forceinline__ void copy(uint32_t tile) const {
#pragma unroll
    for (int i = 0; i < 512 / THREADS; ++i)
      cp_async16(tile + dst + i * (THREADS / 8) * TILE_BYTES_PER_ROW, src + i * row_step);
  }
};

// Shared-memory matrix descriptor of wgmma for one swizzled [rows][64] bf16
// tile at shared address `tile` (1024-byte aligned): start address / 16 in
// bits 0-13, leading byte offset / 16 in bits 16-29 (not used by a tile one
// swizzle atom wide; 1), stride byte offset / 16 in bits 32-45 (the next
// group of eight rows, 1024 bytes on), layout type 1 = 128-byte swizzle in
// bits 62-63. The hardware's swizzle XORs address bits 4-6 with bits 7-9,
// which is swz() above.
__device__ __forceinline__ uint64_t wgmma_tile_desc(uint32_t tile) {
  return static_cast<uint64_t>((tile & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Orders earlier register and shared-memory accesses of the warpgroup before
// the wgmma that follow.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits for every committed wgmma group of the warpgroup, then pins the
// accumulators: the compiler may not move a use of them above the wait.
__device__ __forceinline__ void wgmma_wait(float (&acc)[8][4]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[j][e])::"memory");
  }
}

// Makes shared memory written by cp.async (generic proxy) visible to wgmma,
// which reads it through the asynchronous proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One asynchronous m64n64k16 step of the warpgroup: d (+)= a * b. Each warp
// gives the A fragment of its 16 rows in registers (the layout above) and
// receives d[j] = the D-layout tile of columns 8j..8j+7 of those rows; B
// [16 x 64] is read from shared memory through `bdesc`, either "K-major"
// (TRANS_B 0: rows are the 64 n, 16 k contiguous in a row, the col-major B
// of Q K^T) or "MN-major" (TRANS_B 1: rows are the 16 k, 64 n contiguous,
// the row-major B of P V). With accumulate == 0 the old d is ignored.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[8][4], const uint32_t (&a)[4],
                                                uint64_t bdesc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(accumulate), "n"(TRANS_B));
}

// Two floats -> one register of two bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// exp(x) for the softmax: one multiply and one MUFU.EX2. The .ftz form
// flushes results under 2^-126 to zero, which spares the range fix-up that
// the compiler wraps around the non-ftz form (__expf); exp(0) is
// exactly 1 and exp(-inf), like exp of any x below about -87.3, is 0.
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// A row of a D-layout tile is spread over the four lanes of a quad.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The A operand of a warp's 16 query rows x 64, straight from global memory
// into registers: qf[kk] is the fragment of head-dim columns 16kk..16kk+15.
// `q` points at the first of the 16 rows; rows are `stride` elements apart and
// 4-byte aligned. Each quad reads 16 contiguous bytes of a row per load.
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[4][4], const __nv_bfloat16* q,
                                             long long stride, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* r0 = q + g * stride + 2 * t;
  const __nv_bfloat16* r1 = r0 + 8 * stride;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    qf[kk][0] = __ldg(reinterpret_cast<const unsigned int*>(r0 + 16 * kk));
    qf[kk][1] = __ldg(reinterpret_cast<const unsigned int*>(r1 + 16 * kk));
    qf[kk][2] = __ldg(reinterpret_cast<const unsigned int*>(r0 + 16 * kk + 8));
    qf[kk][3] = __ldg(reinterpret_cast<const unsigned int*>(r1 + 16 * kk + 8));
  }
}

// Starts s = Q K^T for the warpgroup's 64 rows (16 a warp) against the 64
// keys of the swizzled tile `ktile` ([key][64]); s[j] will be the D-layout
// tile of keys 8j..8j+7 once wgmma_wait has returned. K is the K-major B
// operand; head-dim step kk starts 32 bytes further into the rows.
__device__ __forceinline__ void qk_tile(float (&s)[8][4], const uint32_t (&qf)[4][4],
                                        uint32_t ktile) {
  const uint64_t desc = wgmma_tile_desc(ktile);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16<0>(s, qf[kk], desc + 2 * kk, kk != 0);
  wgmma_commit();
}

// Starts o += P V for the warpgroup's 64 rows: pf[kk] is a warp's A fragment
// of keys 16kk..16kk+15 (see the header), `vtile` the swizzled [key][64]
// tile; o[j] is the D-layout tile of head-dim columns 8j..8j+7. V is the
// MN-major B operand; key step kk starts 16 rows (2048 bytes) further on.
__device__ __forceinline__ void pv_tile(float (&o)[8][4], const uint32_t (&pf)[4][4],
                                        uint32_t vtile) {
  const uint64_t desc = wgmma_tile_desc(vtile);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16<1>(o, pf[kk], desc + 128 * kk, 1);
  wgmma_commit();
}

// D-layout probabilities p (16 rows x 64 keys) -> the four A fragments of P V.
__device__ __forceinline__ void pack_p_frags(uint32_t (&pf)[4][4], const float (&p)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pf[kk][0] = pack_bf16x2(p[2 * kk][0], p[2 * kk][1]);
    pf[kk][1] = pack_bf16x2(p[2 * kk][2], p[2 * kk][3]);
    pf[kk][2] = pack_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pf[kk][3] = pack_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
}

// Writes a 16 x 64 f32 D-layout tile, each row scaled, as bf16: every lane
// stores bf16 pairs and a quad covers 16 contiguous bytes of a row. `out`
// points at the first of the 16 rows; rows are `stride` elements apart.
__device__ __forceinline__ void store_o_tile(__nv_bfloat16* out, long long stride,
                                             const float (&o)[8][4], float scale0, float scale1,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
  __nv_bfloat16* r0 = out + g * stride + 2 * t;
  __nv_bfloat16* r1 = r0 + 8 * stride;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(r0 + 8 * j) =
        __floats2bfloat162_rn(o[j][0] * scale0, o[j][1] * scale0);
    *reinterpret_cast<__nv_bfloat162*>(r1 + 8 * j) =
        __floats2bfloat162_rn(o[j][2] * scale1, o[j][3] * scale1);
  }
}

// ---- host ----

using device_state::allow_smem;
using device_state::sm_count;

}  // namespace attn_tiles

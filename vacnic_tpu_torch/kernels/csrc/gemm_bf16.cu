// bf16 x bf16 -> f32-accumulate matrix product with a fused epilogue, in two
// kernels: one for many rows (the encoder) and one for few (the decoder).
//
// Replaces: the matrix products inside the two TPU kernels' bodies --
//   vacnic_tpu/kernels/encoder_stack.py:_kernel (fused QKV, self out-proj,
//   cross q, cross out-proj, fc1, fc2) and
//   vacnic_tpu/kernels/decode_layer.py:_kernel (the same six per layer).
// Computes C[M,N] = epilogue(A[M,K] @ W[K,N]) with A and W bf16 row-major
// (W in the JAX [in, out] layout), epilogue = + bias[N] (f32), optional
// exact erf gelu, optional + residual[M,N] (f32), stored as f32 or bf16.
// Takes K % 32 == 0 and N % 64 == 0 and any M >= 1: rows past M, columns
// past N and the k past K of a last tile read as zero and are never stored.
//
// Bound on the H100 at the main-path shapes:
//   encoder, M = 32*512 = 16384: 2*M*N*K operations against a few tens of MB
//     -- operations bound (fc1: 137 GFLOP, ~0.14 ms at 989 TFLOP/s); only the
//     d x d products with an f32 residual in and out (170 MB for 34 GFLOP)
//     are bytes bound (~0.05 ms);
//   decoder, M = 5*32 = 160: the weight matrix dominates the bytes (fc1 reads
//     8 MB for 1.3 GFLOP) -- bytes bound (~2.5 us at 3.35 TB/s), and so
//     short that the chain load -> product -> store is what is felt.
//
// Shared by both kernels: wgmma.mma_async m64n64k16 / m64n128k16 with both
// operands in shared memory and the accumulator in registers, one warpgroup
// per 64 rows (mma_step). A tiles are [rows][64 k] (the K-major operand), W
// tiles [64 k][64 n] side by side (the MN-major operand, transposed by the
// instruction), both in the 128-byte-swizzle layout of attn_tiles.cuh, in a
// ring of STAGES slots in dynamic shared memory. One wgmma group stays in
// flight while the next slot is waited for, so the tensor cores always have a
// queued step.
//
// Kernel 1, gemm_large_kernel (operations bound): block tile 256 x 128, four
// consumer warpgroups and one producer warp, a four-slot ring (192 KB, one
// block per SM). The producer's one thread fills the ring with TMA
// (cp.async.bulk.tensor, the tensor maps cached on the host by pointer and
// shape), full/empty mbarriers pace it against the consumers, and there is no
// __syncthreads in the loop. Blocks form clusters of CLUSTER_N = 2: the two
// compute neighbouring column tiles of the same rows, each fetches half of
// the A tile and multicasts it to both, which takes a third of the L2
// traffic away. A consumer hands a slot back to every producer of its
// cluster, since each of them writes into it.
// The epilogue is what the first version lost most on: stored straight from
// the accumulator layout, a warp's instruction writes 16 bytes to each of
// eight rows, half a sector each, and 40% of the kernel's time went there. So
// each warp turns its 16 x 64 columns around through 4 KB of its warpgroup's
// own, finished A rows in the ring and then moves bias, residual and output
// as whole 128- and 256-byte rows. Column tiles are the fastest grid index,
// so the blocks that run together share their A rows and all of W in L2.
//
// Kernel 2, gemm_small_kernel (bytes bound): one block covers all M <= 256
// rows of a 64-column slab, so every weight byte is fetched once, and
// a thread-block cluster splits K (split-K) so that the card's SMs stream
// disjoint weight slabs, each with up to six slots of its slab in flight at
// once (cp.async from every thread, STAGES - 2 slots ahead, one
// __syncthreads a k-step). The partial sums are combined deterministically:
// every block writes its f32 partial tile to its own shared memory, the
// cluster synchronises, and block r sums rows [r BM/split, (r+1) BM/split)
// over the blocks in rank order through distributed shared memory, then
// applies bias, gelu, residual and the rounding (the gelu is not linear: it
// comes after the sum) and stores whole 16-byte pieces. No atomics, no
// workspace, and the reduction and the epilogue are spread over the cluster.
//
// Which kernel and split a shape takes is decided in Python
// (kernels/primitives.gemm_plan) and passed down.

#include <dlfcn.h>
#include <stdint.h>
#include <mutex>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>

#include "attn_tiles.cuh"

namespace cg = cooperative_groups;
using namespace attn_tiles;

namespace {

constexpr int BK = 64;                  // k per tile: one 128-byte swizzled row
constexpr int ATOM_BYTES = 64 * TILE_BYTES_PER_ROW;  // one [64][64] bf16 tile
constexpr int MAX_SMEM = 232448;        // 227 KB a block
constexpr int CLUSTER_N = 2;            // large M: column tiles that share their A tile

// 16-byte asynchronous copy global -> shared through L2; with pred false
// nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool pred) {
  const int sz = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(sz)
               : "memory");
}

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

// ---- mbarrier and TMA (cp.async.bulk.tensor) pieces of the large-M kernel ----

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

// One TMA box (coordinates c0 = fastest dimension, c1) into shared memory at
// the same offset of every block of the cluster whose bit is set in `mask`;
// each receiver's barrier at the offset of `bar` is credited with the bytes.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map, int c0,
                                                   int c1, uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar), "h"(mask)
      : "memory");
}

// Descriptor of the W operand: NA swizzled [64 k][64 n] tiles side by side,
// ATOM_BYTES apart. MN-major: the leading byte offset (bits 16-29) is the
// step to the next 64 columns, the stride byte offset (bits 32-45) the step
// to the next eight k rows (1024 bytes).
__device__ __forceinline__ uint64_t w_tile_desc(uint32_t tile) {
  return static_cast<uint64_t>((tile & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(ATOM_BYTES >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// One asynchronous m64nNk16 step of the warpgroup, d (+)= a * b, both
// operands through shared-memory descriptors: a [64 x 16] K-major (rows = m,
// 16 k contiguous), b [16 x N] MN-major (rows = k, n contiguous; the
// instruction transposes it). d[j] is the D-layout tile (attn_tiles.cuh) of
// columns 8j..8j+7 of the warp's 16 rows. With accumulate == 0 the old d is
// ignored.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t adesc, uint64_t bdesc,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(adesc), "l"(bdesc), "r"(accumulate));
}

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
      "%64, %65, p, 1, 1, 0, 1;\n"
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
      : "l"(adesc), "l"(bdesc), "r"(accumulate));
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

// Block tile of WGS warpgroups: 64 WGS rows x 64 NA columns, STAGES ring slots.
template <int WGS, int NA, int STAGES>
struct Tile {
  static_assert(WGS >= 1 && WGS <= 4 && (NA == 1 || NA == 2) && STAGES >= 3, "tile shape");
  static constexpr int THREADS = WGS * 128;
  static constexpr int BM = WGS * 64, BN = NA * 64;
  static constexpr int A_BYTES = WGS * ATOM_BYTES, W_BYTES = NA * ATOM_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + W_BYTES;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + TILE_ALIGN;
  static_assert(SMEM_BYTES <= MAX_SMEM, "ring too large");
};

// One thread's share of the cp.async copies that fill a ring slot: the A tile
// [64 WGS rows][64 k] and NA W tiles [64 k][64 n] of one k-step. Thread tid
// copies chunk tid % 8 of rows tid / 8 + i THREADS / 8; what lies past M, N
// or K is zero-filled.
template <int WGS, int NA, int STAGES>
struct SlotLoader {
  using T = Tile<WGS, NA, STAGES>;
  static constexpr int ROW_STEP = T::THREADS / 8;  // a multiple of 8: one swizzle for all rows
  static constexpr int W_CHUNKS = 512 * NA;
  static constexpr int W_ITERS = (W_CHUNKS + T::THREADS - 1) / T::THREADS;
  const __nv_bfloat16* A;
  const __nv_bfloat16* W;
  int M, N, K, tid;
  // of the output tile being loaded
  const __nv_bfloat16* a_src;
  int a_valid;  // bit i: row r0 + i ROW_STEP of the tile exists
  int n0;

  __device__ __forceinline__ void set_tile(int m0, int n0_) {
    const int ch = tid & 7, r0 = tid >> 3;
    a_src = A + (size_t)(m0 + r0) * K + ch * 8;
    a_valid = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) a_valid |= (m0 + r0 + i * ROW_STEP < M) << i;
    n0 = n0_;
  }

  __device__ __forceinline__ void load(uint32_t slot, int kt) const {
    const int ch = tid & 7, r0 = tid >> 3;
    const int k0 = kt * BK;
    const bool k_ok = k0 + ch * 8 < K;
    const uint32_t a_dst = slot + swz(r0, ch);
    const long long a_step = (long long)ROW_STEP * K;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = k_ok && ((a_valid >> i) & 1);
      cp_async16_zfill(a_dst + i * ROW_STEP * TILE_BYTES_PER_ROW,
                       ok ? a_src + i * a_step + k0 : A, ok);
    }
#pragma unroll
    for (int j = 0; j < W_ITERS; ++j) {
      const int c = tid + j * T::THREADS;
      if (W_CHUNKS % T::THREADS == 0 || c < W_CHUNKS) {
        const int atom = c >> 9, r = (c >> 3) & 63;
        const bool ok = k0 + r < K && n0 + atom * 64 < N;
        cp_async16_zfill(slot + T::A_BYTES + atom * ATOM_BYTES + swz(r, ch),
                         ok ? W + (size_t)(k0 + r) * N + n0 + atom * 64 + ch * 8 : W, ok);
      }
    }
  }
};

// The warpgroup's share of one 64-wide k-step on the tiles of ring slot
// `slot`: four wgmma, committed as one group. `first` starts a new sum.
template <int WGS, int NA>
__device__ __forceinline__ void mma_step(float (&acc)[NA * 8][4], uint32_t slot, int tid,
                                         int first) {
  const uint64_t adesc = wgmma_tile_desc(slot + (tid >> 7) * ATOM_BYTES);  // its 64 rows
  const uint64_t bdesc = w_tile_desc(slot + WGS * ATOM_BYTES);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)  // 16 k: 32 bytes along A's rows, 16 rows down W
    wgmma_ss(acc, adesc + 2 * kk, bdesc + 128 * kk, (first == 0) | (kk != 0));
  wgmma_commit();
}

// acc = A[m0.., k tiles kt0..kt0+nkt) @ W[same k, n0..): kernel 2's pipelined
// loop for one output tile. Every thread of the block calls it.
template <int WGS, int NA, int STAGES>
__device__ __forceinline__ void gemm_mainloop(float (&acc)[NA * 8][4],
                                              SlotLoader<WGS, NA, STAGES>& ld, int kt0, int nkt,
                                              uint32_t smem0) {
  using T = Tile<WGS, NA, STAGES>;
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < nkt) ld.load(smem0 + s * T::STAGE_BYTES, kt0 + s);
    cp_async_commit();
  }
  int slot = 0, pf_slot = STAGES - 2;
  pin(acc);
  for (int it = 0; it < nkt; ++it) {
    cp_async_wait<STAGES - 3>();  // tile `it` of this thread has landed
    fence_proxy_async();
    __syncthreads();  // ... and everyone's; the group of step it - 2 is done everywhere
    if (it + STAGES - 2 < nkt) ld.load(smem0 + pf_slot * T::STAGE_BYTES, kt0 + it + STAGES - 2);
    cp_async_commit();
    mma_step<WGS, NA>(acc, smem0 + slot * T::STAGE_BYTES, ld.tid, it == 0);
    wgmma_wait_pending<1>();  // step it - 1 is done; step it runs on
    slot = slot + 1 == STAGES ? 0 : slot + 1;
    pf_slot = pf_slot + 1 == STAGES ? 0 : pf_slot + 1;
  }
  wgmma_wait_pending<0>();
  pin(acc);
}

// The bias of columns gc..gc+3, zeros where there is none.
__device__ __forceinline__ float4 load_bias4(const float* __restrict__ bias, int gc, int N) {
  return bias && gc < N ? __ldg(reinterpret_cast<const float4*>(bias + gc))
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// + bias -> gelu -> + residual -> rounding -> one 16- or 8-byte store, for
// four neighbouring columns gc.. of row `row` (gc % 4 == 0).
__device__ __forceinline__ void finish4(float4 v, float4 b, const float* __restrict__ res,
                                        void* __restrict__ C, int row, int gc, int N, int act,
                                        int out_bf16) {
  v.x += b.x;
  v.y += b.y;
  v.z += b.z;
  v.w += b.w;
  if (act == 1) {
    v.x = gelu_erf(v.x);
    v.y = gelu_erf(v.y);
    v.z = gelu_erf(v.z);
    v.w = gelu_erf(v.w);
  }
  const size_t o = (size_t)row * N + gc;
  if (res) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(res + o));
    v.x += r.x;
    v.y += r.y;
    v.z += r.z;
    v.w += r.w;
  }
  if (out_bf16) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&lo);
    packed.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(C) + o) = packed;
  } else {
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(C) + o) = v;
  }
}

// Kernel 1. Threads 0 .. 128 WGS - 1 are the consumer warpgroups; lane 0 of
// the last warp is the producer.
template <int WGS, int NA, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__(WGS * 128 + 32, MIN_BLOCKS)
gemm_large_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_w, const float* __restrict__ bias,
                  const float* __restrict__ res, void* __restrict__ C, int M, int N, int K,
                  int act, int out_bf16) {
  using T = Tile<WGS, NA, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t smem0 = smem_u32(align_tiles(smem_raw));
  const uint32_t full0 = smem0 + STAGES * T::STAGE_BYTES;  // STAGES full, then STAGES empty
  const uint32_t empty0 = full0 + STAGES * 8;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  // The cluster is cn blocks along x: neighbouring column tiles, one A tile.
  constexpr int cn = CLUSTER_N;
  const int cx = cluster.block_rank();
  const int n0 = blockIdx.x * T::BN, m0 = blockIdx.y * T::BM;
  const int nkt = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);                  // the producer's expect_tx
      mbar_init(empty0 + 8 * s, cn * WGS);          // every warpgroup of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every block's barriers exist before a peer writes or arrives

  if (tid >= WGS * 128) {
    if (tid == WGS * 128) {
      // producer: 1/cn of the A rows for every block of the cluster, and its
      // own W tiles
      constexpr int a_rows = T::BM / cn;
      const uint16_t everyone = (1u << cn) - 1, self = 1u << cx;
      int slot = 0, parity = 1;  // a fresh barrier counts as released
      for (int kt = 0; kt < nkt; ++kt) {
        mbar_wait(empty0 + 8 * slot, parity);
        const uint32_t full = full0 + 8 * slot, st = smem0 + slot * T::STAGE_BYTES;
        mbar_expect_tx(full, T::STAGE_BYTES);
        tma_load_multicast(st + cx * a_rows * TILE_BYTES_PER_ROW, &map_a, kt * BK,
                           m0 + cx * a_rows, full, everyone);
        for (int a = 0; a < NA; ++a)
          tma_load_multicast(st + T::A_BYTES + a * ATOM_BYTES, &map_w, n0 + a * 64, kt * BK,
                             full, self);
        if (++slot == STAGES) {
          slot = 0;
          parity ^= 1;
        }
      }
    }
  } else {
    float acc[NA * 8][4];
#pragma unroll
    for (int j = 0; j < NA * 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    const bool elected = (tid & 127) == 0;
    int slot = 0, parity = 0, prev = 0;
    pin(acc);
    for (int kt = 0; kt < nkt; ++kt) {
      mbar_wait(full0 + 8 * slot, parity);  // the step's tiles have landed (TMA: async proxy)
      mma_step<WGS, NA>(acc, smem0 + slot * T::STAGE_BYTES, tid, kt == 0);
      wgmma_wait_pending<1>();  // the step before is done; this one runs on
      if (elected && kt > 0)    // hand its slot back to every producer that fills it
        for (int r = 0; r < cn; ++r) mbar_arrive_cluster(empty0 + 8 * prev, r);
      prev = slot;
      if (++slot == STAGES) {
        slot = 0;
        parity ^= 1;
      }
    }
    wgmma_wait_pending<0>();
    pin(acc);

    // Epilogue. A warp's accumulators hold, per instruction, 16 bytes of
    // eight different rows: stored like that, every write is half a sector.
    // So the warp first turns its 16 x 64 columns around in shared memory --
    // 4 KB of its warpgroup's own A rows in the ring, which nothing reads or
    // fills any more (XOR-swizzled by row, conflict-free both ways) -- and
    // then handles whole rows: 16 lanes cover 64 neighbouring columns, so
    // bias, residual and output move in full 128- and 256-byte lines.
    const int lane = tid & 31, g = lane >> 2, t = lane & 3, q = (tid >> 5) & 3;
    unsigned char* stage = align_tiles(smem_raw) + (q >> 1) * T::STAGE_BYTES +
                           (tid >> 7) * ATOM_BYTES + (q & 1) * 4096;
    const int row0 = m0 + (tid >> 5) * 16;
#pragma unroll
    for (int h = 0; h < NA; ++h) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = 2 * jj + (t >> 1);  // 16-byte chunk of the 64 columns
        unsigned char* p = stage + g * 256 + (((c & 8) | ((c ^ g) & 7)) << 4) + (t & 1) * 8;
        *reinterpret_cast<float2*>(p) = make_float2(acc[8 * h + jj][0], acc[8 * h + jj][1]);
        *reinterpret_cast<float2*>(p + 8 * 256) =
            make_float2(acc[8 * h + jj][2], acc[8 * h + jj][3]);
      }
      __syncwarp();
      const int c = lane & 15, gc = n0 + 64 * h + 4 * c;
      const float4 b = load_bias4(bias, gc, N);
#pragma unroll 2  // more rows in flight spill the other half's accumulators and gain nothing
      for (int i = 0; i < 8; ++i) {
        const int r = 2 * i + (lane >> 4);
        const float4 v = *reinterpret_cast<const float4*>(
            stage + r * 256 + (((c & 8) | ((c ^ r) & 7)) << 4));
        if (row0 + r < M && gc < N) finish4(v, b, res, C, row0 + r, gc, N, act, out_bf16);
      }
      __syncwarp();
    }
  }
  __syncwarp();    // the producer's warp is whole again
  cluster.sync();  // no block leaves while a peer may still write to it or arrive on it
}

template <int WGS, int NA, int STAGES>
__global__ void __launch_bounds__(WGS * 128, 1)
gemm_small_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
                  const float* __restrict__ bias, const float* __restrict__ res,
                  void* __restrict__ C, int M, int N, int K, int act, int out_bf16) {
  using T = Tile<WGS, NA, STAGES>;
  constexpr int LD = T::BN + 8;  // floats a row of the partial tile: conflict-free both ways
  static_assert(T::BM * LD * 4 <= STAGES * T::STAGE_BYTES, "the partial tile reuses the ring");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_tiles(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * T::BN;
  const int rank = blockIdx.y, split = gridDim.y;  // the cluster is the grid's y extent

  // this block's slab of k tiles
  const int nkt_all = (K + BK - 1) / BK;
  const int per = (nkt_all + split - 1) / split;
  const int kt0 = rank * per;
  const int nkt = max(0, min(per, nkt_all - kt0));

  float acc[NA * 8][4];
#pragma unroll
  for (int j = 0; j < NA * 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  SlotLoader<WGS, NA, STAGES> ld = {A, W, M, N, K, tid};
  ld.set_tile(0, n0);
  gemm_mainloop<WGS, NA, STAGES>(acc, ld, kt0, nkt, smem_u32(smem));
  __syncthreads();  // every warpgroup has read its last tile: the ring is free

  float* part = reinterpret_cast<float*>(smem);
  {
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
    float* pa = part + ((tid >> 5) * 16 + g) * LD + 2 * t;
    float* pb = pa + 8 * LD;
#pragma unroll
    for (int j = 0; j < NA * 8; ++j) {
      *reinterpret_cast<float2*>(pa + 8 * j) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(pb + 8 * j) = make_float2(acc[j][2], acc[j][3]);
    }
  }
  cluster.sync();  // every block's partial tile is written

  const int rows = T::BM / split;  // this block finishes rows [rank rows, (rank + 1) rows)
  constexpr int C4 = T::BN / 4;
  for (int i = tid; i < rows * C4; i += T::THREADS) {
    const int row = rank * rows + i / C4, col = (i % C4) * 4;
    const int gc = n0 + col;
    if (row >= M || gc >= N) continue;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int q = 0; q < split; ++q) {  // always in rank order
      const float4 p = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, q) + row * LD + col);
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    finish4(v, load_bias4(bias, gc, N), res, C, row, gc, N, act, out_bf16);
  }
  cluster.sync();  // nobody's shared memory goes away while a peer still reads it
}

struct GemmArgs {
  const __nv_bfloat16* a;
  const __nv_bfloat16* w;
  const float* bias;
  const float* res;
  void* c;
  int M, N, K, act, out_bf16;
  cudaStream_t stream;
};

// Raises the kernel's dynamic shared-memory limit once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int* configured_device) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev == *configured_device) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *configured_device = dev;
  return e;
}

// Tensor maps of a row-major bf16 matrix [rows, cols] cut into boxes of
// box_rows x 64 columns with the 128-byte swizzle, kept by (pointer, shape,
// box): encoding is host work, and weights and activations come back at the
// same addresses launch after launch. What lies outside the matrix reads as 0.
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

MapCache map_cache;

// Dynamic shared memory of a large-M block: the ring and its full/empty barriers.
template <int WGS, int NA, int STAGES>
constexpr int large_smem() {
  constexpr int bytes = Tile<WGS, NA, STAGES>::SMEM_BYTES + 2 * STAGES * 8;
  static_assert(bytes <= MAX_SMEM, "ring and barriers too large");
  return bytes;
}

template <int WGS, int NA, int STAGES, int MIN_BLOCKS>
int launch_large(const GemmArgs& g) {
  using T = Tile<WGS, NA, STAGES>;
  constexpr int SMEM = large_smem<WGS, NA, STAGES>();
  constexpr int cn = CLUSTER_N;
  static_assert(T::BM % (8 * cn) == 0, "the A box a block fetches is whole 8-row groups");
  static int configured_device = -1;
  auto kernel = gemm_large_kernel<WGS, NA, STAGES, MIN_BLOCKS>;
  cudaError_t e = allow_smem(kernel, SMEM, &configured_device);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap map_a, map_w;
  e = map_cache.get(g.a, g.M, g.K, T::BM / cn, &map_a);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = map_cache.get(g.w, g.K, g.N, 64, &map_w);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_n = (g.N + T::BN - 1) / T::BN, tiles_m = (g.M + T::BM - 1) / T::BM;
  cudaLaunchConfig_t cfg = {};
  // whole clusters: a block past the last tile loads zeros and stores nothing
  cfg.gridDim = dim3((tiles_n + cn - 1) / cn * cn, tiles_m, 1);
  if (cfg.gridDim.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cfg.blockDim = dim3(T::THREADS + 32, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = g.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cn;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, map_a, map_w, g.bias, g.res, g.c, g.M, g.N, g.K, g.act,
                         g.out_bf16);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

constexpr int small_stages(int wgs, int na) {
  const int fit = (MAX_SMEM - TILE_ALIGN) / ((wgs + na) * ATOM_BYTES);
  return fit > 8 ? 8 : fit;
}

template <int WGS, int NA>
int launch_small(const GemmArgs& g, int split) {
  constexpr int STAGES = small_stages(WGS, NA);
  using T = Tile<WGS, NA, STAGES>;
  static int configured_device = -1;
  auto kernel = gemm_small_kernel<WGS, NA, STAGES>;
  cudaError_t e = allow_smem(kernel, T::SMEM_BYTES, &configured_device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((g.N + T::BN - 1) / T::BN, split, 1);
  cfg.blockDim = dim3(T::THREADS, 1, 1);
  cfg.dynamicSmemBytes = T::SMEM_BYTES;
  cfg.stream = g.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, g.a, g.w, g.bias, g.res, g.c, g.M, g.N, g.K, g.act,
                         g.out_bf16);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A [M,K] bf16, W [K,N] bf16, bias [N] f32 or NULL, res [M,N] f32 or NULL,
// C [M,N] f32 (out_bf16 = 0) or bf16 (out_bf16 = 1); act 0 = none, 1 = gelu.
// Needs K % 32 == 0 and N % 64 == 0. The plan comes from
// kernels/primitives.gemm_plan:
//   variant 1 (large M): 256 x 128 tiles in clusters of two neighbouring
//     column tiles; split = 1;
//   variant 2 (small M <= 256): ceil(M / 64) warpgroups cover every row of a
//     64-column slab, split = 1, 2 or 4 blocks of a cluster along K.
// Any other plan is refused with cudaErrorInvalidValue.
extern "C" int vt_gemm_bf16(const void* A, const void* W, const void* bias, const void* res,
                            void* C, int M, int N, int K, int act, int out_bf16, int variant,
                            int split, void* stream) {
  const GemmArgs g = {reinterpret_cast<const __nv_bfloat16*>(A),
                      reinterpret_cast<const __nv_bfloat16*>(W),
                      reinterpret_cast<const float*>(bias),
                      reinterpret_cast<const float*>(res),
                      C, M, N, K, act, out_bf16, reinterpret_cast<cudaStream_t>(stream)};
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (M < 1 || K < 32 || K % 32 || N < 64 || N % 64) return invalid;
  if (variant == 1) {
    if (split != 1) return invalid;
    // TMA reads 16-byte aligned rows
    if (reinterpret_cast<uintptr_t>(A) % 16 || reinterpret_cast<uintptr_t>(W) % 16) return invalid;
    return launch_large<4, 2, 4, 1>(g);
  }
  if (variant == 2) {
    if (split != 1 && split != 2 && split != 4) return invalid;
    switch ((M + 63) / 64) {
      case 1: return launch_small<1, 1>(g, split);
      case 2: return launch_small<2, 1>(g, split);
      case 3: return launch_small<3, 1>(g, split);
      case 4: return launch_small<4, 1>(g, split);
      default: return invalid;
    }
  }
  return invalid;
}

// Dynamic shared memory, in bytes a block, of the kernel that variant and M
// select in vt_gemm_bf16; 0 where it would refuse them.
extern "C" int vt_gemm_smem_bytes(int variant, int M) {
  if (variant == 1) return large_smem<4, 2, 4>();
  if (variant != 2) return 0;
  switch ((M + 63) / 64) {
    case 1: return Tile<1, 1, small_stages(1, 1)>::SMEM_BYTES;
    case 2: return Tile<2, 1, small_stages(2, 1)>::SMEM_BYTES;
    case 3: return Tile<3, 1, small_stages(3, 1)>::SMEM_BYTES;
    case 4: return Tile<4, 1, small_stages(4, 1)>::SMEM_BYTES;
    default: return 0;
  }
}

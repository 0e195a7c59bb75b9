// bf16 x bf16 -> f32-accumulate matrix product with a fused epilogue, in three
// kernels: one for many rows (the encoder at batch 8 and up), one for few (the
// decoder up to 256 rows) and one for the range between (257 to a bound of a
// few thousand rows: the decoder at batch 64-256 or past 8 beams, the
// encoder at batch 1-4).
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
// shape; tma_wgmma.cuh, shared with lm_head.cu), full/empty mbarriers pace it
// against the consumers, and there is no
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
// Kernel 3, gemm_mid_kernel (between the two): at 257-2048 rows the product
// is neither kernel 1's operations-bound tile nor kernel 2's weight stream.
// At M 320 the weight bytes set the bound, at M 1280 the two nearly balance
// (fc1: 10.7 GFLOP, 10.9 us, against 21 MB, 6.3 us); what lost time there on
// kernel 1 was its grid (M 320 x N 1024 is 16 blocks of 256 x 128 on 132
// SMs) and its serial K loop. So: block tiles of 128 rows (two consumer
// warpgroups) by 64 or 128 columns, chosen with the split by gemm_plan to
// fill the card; a warpgroup whose 64 rows all lie past M fetches, computes
// and stores nothing (M 320 wastes 64 rows of 384, not 192 of 512). K is
// split over a cluster of 1, 2 or 4 blocks, reduced as kernel 2 does it:
// each block writes its f32 partial tile into its own ring, the cluster
// synchronises, block r sums its share of the rows over the ranks in rank
// order through distributed shared memory and applies bias, gelu, residual
// and the rounding -- no atomics, no workspace, bit-identical from call to
// call. The partial tile is also the epilogue's turnaround (kernel 1 lost 40%
// of its first version's time storing straight from the accumulators): the
// bias, residual and output move as whole rows, even at split 1. Tiles come
// by TMA, as in kernel 1, one producer warp and full/empty mbarriers, into a
// ring of 96 KB, small enough that two blocks share an SM where the grid has
// more blocks than SMs. Neither a deeper ring for a block alone on its SM
// nor kernel 1's multicast of the A rows to clusters of 2 or 4 column tiles
// measured faster (PERF.md), so the kernel has neither.
//
// Which kernel, split and tile width a shape takes is decided in Python
// (kernels/primitives.gemm_plan) and passed down.
//
// Kernel 4, cross_kv_gemm_kernel: the decoder's cross K and V of one layer,
// computed once a batch before the beam search (infer/decode_fast.
// build_decode_cache). Replaces no TPU kernel: the JAX package leaves the
// product to XLA's einsum, bf16 operands with f32 accumulation, + the f32
// bias, rounded to bf16 (vacnic_tpu/infer/decode_fast.py:267-280); the port
// ran it as f32 library products of bf16-rounded values followed by seven
// plain passes over f32 temporaries. Y = X [B S, d] @ [Wk | Wv] [d, 2d] +
// bias, rounded to bf16, stored as K and V [B, d, S] (= [B, H, hd, S]), or
// quantized to int8 with one f32 scale an (item, channel) over the S
// positions: scale = max(amax / 127, 1e-12), q = clamp(rint(y / scale),
// -127, 127).
// Bound at B 256 x S 512, d 1024: 2 x 131072 x 2048 x 1024 = 550 GFLOP a
// layer, 0.556 ms at 989 TFLOP/s, against 268 MB of X, 4 MB of W and 268 MB
// of int8 out (0.16 ms): operations bound, 6.7 ms for the 12 layers. So the
// main loop is kernel 1's: 256 x 128 tiles, four consumer warpgroups on
// wgmma, one TMA producer, a four-slot ring, the A rows multicast to the two
// column tiles of a cluster. What is new is the epilogue, which the library
// product left to seven passes over device memory:
//   * row tiles never straddle an item: an item's S positions are
//     ceil(S / 256) row tiles, rows past S are computed and never stored;
//   * + bias and the rounding to bf16 in registers;
//   * int8: the column maxima of an item's positions are taken in the
//     block (shuffles, then shared memory) and across its row tiles by the
//     cluster: the cluster is 2 column tiles x the item's row tiles (up to
//     4: S <= 1024, BART's positions), and each block reads its row
//     neighbours' maxima through distributed shared memory;
//   * the tile goes through shared memory turned around, [column][position],
//     so that every column's positions leave as whole 16-byte pieces of one
//     contiguous row of [B, d, S].
// The scale is amax * fl(1 / 127): what quantize_cross_kv's `amax / 127.0`
// computes on a CUDA tensor (PyTorch divides by a host scalar as a product
// with its f32 reciprocal); y / scale is an IEEE division (__fdiv_rn) and
// rint rounds half to even, as torch.round does.
// Past 1024 positions (LED's 16384) an item's row tiles outgrow a portable
// cluster. There kernel 4 runs in its bf16 form with clusters of the column
// pair alone (a cluster row a block row), and kernel 5, cross_kv_quant_kernel,
// quantizes: a block a row of [B, d, S] (an (item, channel) of K or V),
// the row's maximum over S, the scale, then every value, as above. The
// values it reads are the bf16 ones the int8 epilogue quantizes, so the int8
// and the scales are those of the one-pass form, bit for bit. Its cost is a
// bf16 copy of K and V, written and read once more: at B 32 x S 16384 2.1
// GB a layer, 1.3 ms at 3.35 TB/s, beside the product's 2.2 ms.

#include <stdint.h>
#include <initializer_list>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>

#include "attn_tiles.cuh"
#include "tma_wgmma.cuh"

namespace cg = cooperative_groups;
using namespace attn_tiles;
using namespace tma_wgmma;

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

// Descriptor of the W operand: NA swizzled [64 k][64 n] tiles side by side,
// ATOM_BYTES apart. MN-major: the leading byte offset (bits 16-29) is the
// step to the next 64 columns, the stride byte offset (bits 32-45) the step
// to the next eight k rows (1024 bytes).
__device__ __forceinline__ uint64_t w_tile_desc(uint32_t tile) {
  return static_cast<uint64_t>((tile & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(ATOM_BYTES >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
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
    wgmma_ss<1>(acc, adesc + 2 * kk, bdesc + 128 * kk, (first == 0) | (kk != 0));
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

constexpr int MID_WGS = 2;  // kernel 3: 128 rows a block

// Kernel 3. Threads 0 .. 255 are the two consumer warpgroups; lane 0 of the
// last warp is the producer. The grid is (column tiles, row tiles x split);
// the cluster is the `split` blocks of one output tile, rank r taking the k
// tiles [r per, (r + 1) per) and finishing rows [r 128 / split, (r + 1) 128 / split).
template <int NA, int STAGES>
__global__ void __launch_bounds__(MID_WGS * 128 + 32, 2)
gemm_mid_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_w, const float* __restrict__ bias,
                const float* __restrict__ res, void* __restrict__ C, int M, int N, int K,
                int act, int out_bf16, int split) {
  using T = Tile<MID_WGS, NA, STAGES>;
  constexpr int LD = T::BN + 8;  // floats a row of the partial tile: conflict-free both ways
  static_assert(T::BM * LD * 4 <= STAGES * T::STAGE_BYTES, "the partial tile reuses the ring");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_tiles(smem_raw);
  const uint32_t smem0 = smem_u32(smem);
  const uint32_t full0 = smem0 + STAGES * T::STAGE_BYTES;  // STAGES full, then STAGES empty
  const uint32_t empty0 = full0 + STAGES * 8;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rank = cluster.block_rank();  // the cluster is 1 x split x 1
  const int n0 = blockIdx.x * T::BN, m0 = (blockIdx.y / split) * T::BM;
  const int live = min(MID_WGS, (M - m0 + 63) / 64);  // warpgroups with a row below M
  const int nkt_all = (K + BK - 1) / BK;
  const int per = (nkt_all + split - 1) / split;
  const int kt0 = rank * per;
  const int nkt = max(0, min(per, nkt_all - kt0));

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);      // the producer's expect_tx
      mbar_init(empty0 + 8 * s, live);  // one thread of each live consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[NA * 8][4];
#pragma unroll
  for (int j = 0; j < NA * 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  if (tid >= MID_WGS * 128) {
    if (tid == MID_WGS * 128) {
      // the producer: the live warpgroups' A rows and the W tiles
      int slot = 0, parity = 1;  // a fresh barrier counts as released
      for (int kt = 0; kt < nkt; ++kt) {
        mbar_wait(empty0 + 8 * slot, parity);
        const uint32_t full = full0 + 8 * slot, st = smem0 + slot * T::STAGE_BYTES;
        const int k0 = (kt0 + kt) * BK;
        mbar_expect_tx(full, (live + NA) * ATOM_BYTES);
        for (int w = 0; w < live; ++w) tma_load(st + w * ATOM_BYTES, &map_a, k0, m0 + 64 * w, full);
        for (int a = 0; a < NA; ++a)
          tma_load(st + T::A_BYTES + a * ATOM_BYTES, &map_w, n0 + a * 64, k0, full);
        if (++slot == STAGES) {
          slot = 0;
          parity ^= 1;
        }
      }
    }
  } else if ((tid >> 7) < live) {
    const bool elected = (tid & 127) == 0;
    int slot = 0, parity = 0, prev = 0;
    pin(acc);
    for (int kt = 0; kt < nkt; ++kt) {
      mbar_wait(full0 + 8 * slot, parity);  // the step's tiles have landed (TMA: async proxy)
      mma_step<MID_WGS, NA>(acc, smem0 + slot * T::STAGE_BYTES, tid, kt == 0);
      wgmma_wait_pending<1>();  // the step before is done; this one runs on
      if (elected && kt > 0) mbar_arrive(empty0 + 8 * prev);  // hand its slot back
      prev = slot;
      if (++slot == STAGES) {
        slot = 0;
        parity ^= 1;
      }
    }
    wgmma_wait_pending<0>();
    pin(acc);
  }
  __syncwarp();     // the producer's warp is whole again
  __syncthreads();  // every wgmma has read its last tiles: the ring is free

  float* part = reinterpret_cast<float*>(smem);
  if (tid < MID_WGS * 128 && (tid >> 7) < live) {
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

  // rows [rank rows, (rank + 1) rows) of the tile, whole 16-byte pieces of
  // neighbouring columns: a warp covers 128 (BN 64: two rows of 64) columns
  const int rows = T::BM / split;
  constexpr int C4 = T::BN / 4;
  for (int i = tid; i < rows * C4; i += blockDim.x) {
    const int row = rank * rows + i / C4, col = (i % C4) * 4;
    const int gr = m0 + row, gc = n0 + col;
    if (gr >= M || gc >= N) continue;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int q = 0; q < split; ++q) {  // always in rank order
      const float* src = q == rank ? part : cluster.map_shared_rank(part, q);
      const float4 p = *reinterpret_cast<const float4*>(src + row * LD + col);
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    finish4(v, load_bias4(bias, gc, N), res, C, gr, gc, N, act, out_bf16);
  }
  cluster.sync();  // nobody's shared memory goes away while a peer still reads it
}

constexpr int KV_WGS = 4, KV_NA = 2, KV_STAGES = 4;  // kernel 4: kernel 1's tile and ring
constexpr int KV_MAX_TILES = 4;  // row tiles an item: a cluster of 2 x 4, the portable largest
// past the ring and its barriers: every warp's column maxima [16][128], the
// block's [128] (read by its row neighbours) and the scales [128], f32
constexpr int KV_XCH_BYTES = (KV_WGS * 4 + 2) * 64 * KV_NA * 4;
constexpr float INV127 = 1.0f / 127.0f;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Named barrier 1 over the consumer warpgroups: the producer warp takes no part.
__device__ __forceinline__ void kv_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(KV_WGS * 128) : "memory");
}

// Kernel 4. The grid is (column tiles, whole to a cluster pair; items x
// `tiles` row tiles), the cluster (2, tiles): rank cx + 2 cy is column tile cx
// of the pair and row tile cy of the item. Threads 0 .. 511 are the consumer
// warpgroups; lane 0 of the last warp is the producer.
template <bool INT8>
__global__ void __launch_bounds__(KV_WGS * 128 + 32, 1)
cross_kv_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_w, const float* __restrict__ bias,
                     void* __restrict__ out_k, void* __restrict__ out_v,
                     float* __restrict__ scale_k, float* __restrict__ scale_v, int S, int D,
                     int tiles, int crows) {
  using T = Tile<KV_WGS, KV_NA, KV_STAGES>;
  constexpr int cn = CLUSTER_N;
  constexpr int ESZ = INT8 ? 1 : 2;                // bytes a stored value
  constexpr int LDT = T::BM * ESZ + 16;            // bytes a column of the turned-around tile
  constexpr int CHUNKS = T::BM * ESZ / 16;         // 16-byte pieces a column
  static_assert(T::BN * LDT <= KV_STAGES * T::STAGE_BYTES, "the turned-around tile fits the ring");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_tiles(smem_raw);
  const uint32_t smem0 = smem_u32(smem);
  const uint32_t full0 = smem0 + KV_STAGES * T::STAGE_BYTES;  // STAGES full, then STAGES empty
  const uint32_t empty0 = full0 + KV_STAGES * 8;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int cx = blockIdx.x % cn, cy = blockIdx.y % tiles;  // column of the pair; row tile
  const int crow = blockIdx.y % crows;  // the block's cluster row: cy where the item's row
                                        // tiles make the cluster (int8), else 0
  const int item = blockIdx.y / tiles;
  const int n0 = blockIdx.x * T::BN, r0 = cy * T::BM;  // first column; first position of the item
  const int m0 = item * S + r0;                        // first row of X
  const int N = 2 * D;
  const int valid = min(T::BM, S - r0);                // positions of the item in this tile
  const int nkt = (D + BK - 1) / BK;
  float* colmax = reinterpret_cast<float*>(smem + KV_STAGES * T::STAGE_BYTES + 2 * KV_STAGES * 8);
  float* blockmax = colmax + KV_WGS * 4 * T::BN;             // [BN], read by the row neighbours
  float* scale_s = blockmax + T::BN;                         // [BN]

  if (tid == 0) {
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);               // the producer's expect_tx
      mbar_init(empty0 + 8 * s, cn * KV_WGS);    // every warpgroup of the column pair
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every block's barriers exist before a peer writes or arrives

  float acc[KV_NA * 8][4];
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int rlo = warp * 16 + g, rhi = rlo + 8;  // this thread's rows of the tile
  if (tid >= KV_WGS * 128) {
    if (tid == KV_WGS * 128) {
      // the producer: half of the A rows for both blocks of the column pair,
      // and its own W tiles
      constexpr int a_rows = T::BM / cn;
      const uint16_t pair = static_cast<uint16_t>(((1u << cn) - 1) << (cn * crow));
      const uint16_t self = static_cast<uint16_t>(1u << (cx + cn * crow));
      int slot = 0, parity = 1;  // a fresh barrier counts as released
      for (int kt = 0; kt < nkt; ++kt) {
        mbar_wait(empty0 + 8 * slot, parity);
        const uint32_t full = full0 + 8 * slot, st = smem0 + slot * T::STAGE_BYTES;
        mbar_expect_tx(full, T::STAGE_BYTES);
        tma_load_multicast(st + cx * a_rows * TILE_BYTES_PER_ROW, &map_a, kt * BK,
                           m0 + cx * a_rows, full, pair);
        for (int a = 0; a < KV_NA; ++a)
          tma_load_multicast(st + T::A_BYTES + a * ATOM_BYTES, &map_w, n0 + a * 64, kt * BK,
                             full, self);
        if (++slot == KV_STAGES) {
          slot = 0;
          parity ^= 1;
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < KV_NA * 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    const bool elected = (tid & 127) == 0;
    int slot = 0, parity = 0, prev = 0;
    pin(acc);
    for (int kt = 0; kt < nkt; ++kt) {
      mbar_wait(full0 + 8 * slot, parity);  // the step's tiles have landed (TMA: async proxy)
      mma_step<KV_WGS, KV_NA>(acc, smem0 + slot * T::STAGE_BYTES, tid, kt == 0);
      wgmma_wait_pending<1>();  // the step before is done; this one runs on
      if (elected && kt > 0)    // hand its slot back to both producers that fill it
        for (int r = 0; r < cn; ++r) mbar_arrive_cluster(empty0 + 8 * prev, r + cn * crow);
      prev = slot;
      if (++slot == KV_STAGES) {
        slot = 0;
        parity ^= 1;
      }
    }
    wgmma_wait_pending<0>();
    pin(acc);

    // + bias, rounded to bf16; int8: each warp's column maxima over its
    // rows of the item (shuffles across the eight row lanes)
#pragma unroll
    for (int j = 0; j < KV_NA * 8; ++j) {
      const int c = 8 * j + 2 * t, gc = n0 + c;
      const float2 b = gc < N ? __ldg(reinterpret_cast<const float2*>(bias + gc))
                              : make_float2(0.0f, 0.0f);
      acc[j][0] = round_bf16(acc[j][0] + b.x);
      acc[j][1] = round_bf16(acc[j][1] + b.y);
      acc[j][2] = round_bf16(acc[j][2] + b.x);
      acc[j][3] = round_bf16(acc[j][3] + b.y);
      if (INT8) {
        const bool lo = rlo < valid, hi = rhi < valid;  // rows of the item
        float m0v = fmaxf(lo ? fabsf(acc[j][0]) : 0.0f, hi ? fabsf(acc[j][2]) : 0.0f);
        float m1v = fmaxf(lo ? fabsf(acc[j][1]) : 0.0f, hi ? fabsf(acc[j][3]) : 0.0f);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          m0v = fmaxf(m0v, __shfl_xor_sync(0xffffffffu, m0v, o));
          m1v = fmaxf(m1v, __shfl_xor_sync(0xffffffffu, m1v, o));
        }
        if (g == 0) {
          colmax[warp * T::BN + c] = m0v;
          colmax[warp * T::BN + c + 1] = m1v;
        }
      }
    }
    if (INT8) {
      kv_consumers_sync();  // every warp's maxima are in
      if (tid < T::BN) {
        float m = 0.0f;
        for (int w = 0; w < KV_WGS * 4; ++w) m = fmaxf(m, colmax[w * T::BN + tid]);
        blockmax[tid] = m;
      }
    }
  }
  __syncwarp();    // the producer's warp is whole again
  cluster.sync();  // every block's maxima are in; every wgmma of the cluster is done

  if (tid < KV_WGS * 128) {
    if (INT8) {
      if (tid < T::BN) {  // the item's maxima over its row tiles, and the scale
        float m = 0.0f;
        for (int y = 0; y < tiles; ++y)
          m = fmaxf(m, cluster.map_shared_rank(blockmax, cx + cn * y)[tid]);
        const float s = fmaxf(m * INV127, 1e-12f);
        scale_s[tid] = s;
        const int gc = n0 + tid;
        if (cy == 0 && gc < N) (gc < D ? scale_k : scale_v)[(size_t)item * D + gc % D] = s;
      }
      kv_consumers_sync();
    }
    // the tile turned around, [column][position], 16 bytes of padding a
    // column, in the ring: the cluster's sync above came after every wgmma
#pragma unroll
    for (int j = 0; j < KV_NA * 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        unsigned char* col = smem + c * LDT;
        if (INT8) {
          const float s = scale_s[c];
          col[rlo] = static_cast<unsigned char>(static_cast<signed char>(
              fminf(fmaxf(rintf(__fdiv_rn(acc[j][e], s)), -127.0f), 127.0f)));
          col[rhi] = static_cast<unsigned char>(static_cast<signed char>(
              fminf(fmaxf(rintf(__fdiv_rn(acc[j][2 + e], s)), -127.0f), 127.0f)));
        } else {
          reinterpret_cast<__nv_bfloat16*>(col)[rlo] = __float2bfloat16_rn(acc[j][e]);
          reinterpret_cast<__nv_bfloat16*>(col)[rhi] = __float2bfloat16_rn(acc[j][2 + e]);
        }
      }
    }
    kv_consumers_sync();
    // each column's valid positions to its row of [B, d, S]: 16 lanes (int8)
    // or 32 (bf16) a column, whole 16-byte pieces where S keeps them aligned
    const bool whole = (S * ESZ) % 16 == 0;
    for (int i = tid; i < T::BN * CHUNKS; i += KV_WGS * 128) {
      const int c = i / CHUNKS, p0 = (i % CHUNKS) * (16 / ESZ), gc = n0 + c;
      if (gc >= N || p0 >= valid) continue;
      unsigned char* dst = reinterpret_cast<unsigned char*>(gc < D ? out_k : out_v) +
                           (((size_t)item * D + gc % D) * S + r0 + p0) * ESZ;
      const unsigned char* src = smem + c * LDT + p0 * ESZ;
      if (whole && p0 + 16 / ESZ <= valid) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        const int n = min(16 / ESZ, valid - p0) * ESZ;
        for (int k = 0; k < n; ++k) dst[k] = src[k];
      }
    }
  }
  __syncwarp();
  cluster.sync();  // no block leaves while a row neighbour may still read its maxima
}

// Kernel 5: a block a row of [rows, S] bf16 -> int8 and its scale.
constexpr int QUANT_THREADS = 256;

__global__ void __launch_bounds__(QUANT_THREADS)
cross_kv_quant_kernel(const __nv_bfloat16* __restrict__ src_k,
                      const __nv_bfloat16* __restrict__ src_v, int8_t* __restrict__ dst_k,
                      int8_t* __restrict__ dst_v, float* __restrict__ scale_k,
                      float* __restrict__ scale_v, int rows, int S) {
  __shared__ float wmax[QUANT_THREADS / 32];
  const bool is_v = static_cast<int>(blockIdx.x) >= rows;
  const size_t row = is_v ? blockIdx.x - rows : blockIdx.x;
  const __nv_bfloat16* x = (is_v ? src_v : src_k) + row * S;
  int8_t* y = (is_v ? dst_v : dst_k) + row * S;
  const int tid = threadIdx.x;
  const bool vec = S % 16 == 0;  // 16 values a piece: 32 bytes in, 16 out, aligned
  float m = 0.0f;
  if (vec) {
    for (int c = tid; c < S / 8; c += QUANT_THREADS) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(x) + c);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
      }
    }
  } else {
    for (int i = tid; i < S; i += QUANT_THREADS) m = fmaxf(m, fabsf(__bfloat162float(x[i])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((tid & 31) == 0) wmax[tid >> 5] = m;
  __syncthreads();
  m = 0.0f;
#pragma unroll
  for (int w = 0; w < QUANT_THREADS / 32; ++w) m = fmaxf(m, wmax[w]);
  const float sc = fmaxf(m * INV127, 1e-12f);
  if (tid == 0) (is_v ? scale_v : scale_k)[row] = sc;
  auto q8 = [&](float v) {
    return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(
        fminf(fmaxf(rintf(__fdiv_rn(v, sc)), -127.0f), 127.0f))));
  };
  if (vec) {
    for (int c = tid; c < S / 16; c += QUANT_THREADS) {
      const uint4 u0 = __ldg(reinterpret_cast<const uint4*>(x) + 2 * c);
      const uint4 u1 = __ldg(reinterpret_cast<const uint4*>(x) + 2 * c + 1);
      const __nv_bfloat162* h0 = reinterpret_cast<const __nv_bfloat162*>(&u0);
      const __nv_bfloat162* h1 = reinterpret_cast<const __nv_bfloat162*>(&u1);
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 a = __bfloat1622float2(h0[2 * i]), b = __bfloat1622float2(h0[2 * i + 1]);
        w[i] = q8(a.x) | q8(a.y) << 8 | q8(b.x) << 16 | q8(b.y) << 24;
        const float2 c2 = __bfloat1622float2(h1[2 * i]), d2 = __bfloat1622float2(h1[2 * i + 1]);
        w[2 + i] = q8(c2.x) | q8(c2.y) << 8 | q8(d2.x) << 16 | q8(d2.y) << 24;
      }
      reinterpret_cast<uint4*>(y)[c] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
    for (int i = tid; i < S; i += QUANT_THREADS)
      y[i] = static_cast<int8_t>(static_cast<uint8_t>(q8(__bfloat162float(x[i]))));
  }
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
  static device_state::PerDevice configured;
  auto kernel = gemm_large_kernel<WGS, NA, STAGES, MIN_BLOCKS>;
  cudaError_t e = allow_smem(kernel, SMEM, configured);
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
  static device_state::PerDevice configured;
  auto kernel = gemm_small_kernel<WGS, NA, STAGES>;
  cudaError_t e = allow_smem(kernel, T::SMEM_BYTES, configured);
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

// Kernel 3's ring: 96 KB (NA 1: four slots of 24 KB, NA 2: three of 32 KB),
// so that two blocks, each with its barriers and alignment slack, share an
// SM's 228 KB.
constexpr int mid_stages(int na) { return na == 1 ? 4 : 3; }

template <int NA>
constexpr int mid_smem() {
  constexpr int stages = mid_stages(NA);
  constexpr int bytes = Tile<MID_WGS, NA, stages>::SMEM_BYTES + 2 * stages * 8;
  static_assert(2 * (bytes + 1024) <= 233472, "two blocks an SM");  // + 1 KB reserved a block
  return bytes;
}

template <int NA>
int launch_mid(const GemmArgs& g, int split) {
  constexpr int STAGES = mid_stages(NA);
  using T = Tile<MID_WGS, NA, STAGES>;
  constexpr int SMEM = mid_smem<NA>();
  static device_state::PerDevice configured;
  auto kernel = gemm_mid_kernel<NA, STAGES>;
  cudaError_t e = allow_smem(kernel, SMEM, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap map_a, map_w;
  e = map_cache.get(g.a, g.M, g.K, 64, &map_a);  // a box a warpgroup: 64 rows
  if (e != cudaSuccess) return static_cast<int>(e);
  e = map_cache.get(g.w, g.K, g.N, 64, &map_w);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles_y = (long long)((g.M + T::BM - 1) / T::BM) * split;
  if (tiles_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((g.N + T::BN - 1) / T::BN, (unsigned)tiles_y, 1);
  cfg.blockDim = dim3(T::THREADS + 32, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = g.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, map_a, map_w, g.bias, g.res, g.c, g.M, g.N, g.K, g.act,
                         g.out_bf16, split);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 4's shared memory: kernel 1's ring and barriers, then the maxima.
constexpr int cross_kv_smem() {
  constexpr int bytes = large_smem<KV_WGS, KV_NA, KV_STAGES>() + KV_XCH_BYTES;
  static_assert(bytes <= MAX_SMEM, "ring, barriers and maxima too large");
  return bytes;
}

// clusters of the column pair x `crows` row tiles: the item's `tiles` for
// int8 (its column maxima), 1 for bf16 past KV_MAX_TILES
template <bool INT8>
int launch_cross_kv(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* bias,
                    void* out_k, void* out_v, float* scale_k, float* scale_v, int B, int S,
                    int D, int tiles, int crows, cudaStream_t stream) {
  using T = Tile<KV_WGS, KV_NA, KV_STAGES>;
  constexpr int SMEM = cross_kv_smem();
  constexpr int cn = CLUSTER_N;
  static device_state::PerDevice configured;
  auto kernel = cross_kv_gemm_kernel<INT8>;
  cudaError_t e = allow_smem(kernel, SMEM, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap map_a, map_w;
  e = map_cache.get(x, B * S, D, T::BM / cn, &map_a);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = map_cache.get(w, D, 2 * D, 64, &map_w);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_n = (2 * D + T::BN - 1) / T::BN;
  const long long tiles_y = (long long)B * tiles;
  if (tiles_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  // whole clusters: a block past the last column tile loads zeros and stores nothing
  cfg.gridDim = dim3((tiles_n + cn - 1) / cn * cn, (unsigned)tiles_y, 1);
  cfg.blockDim = dim3(T::THREADS + 32, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cn;
  attr[0].val.clusterDim.y = crows;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, map_a, map_w, bias, out_k, out_v, scale_k, scale_v, S, D,
                         tiles, crows);
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
//     64-column slab, split = 1, 2 or 4 blocks of a cluster along K;
//   variant 3 (M between): 128 x bn tiles, bn = 64 or 128, split = 1, 2 or 4
//     blocks of a cluster along K.
// bn is 0 for variants 1 and 2, whose tiles are fixed. Any other plan is
// refused with cudaErrorInvalidValue.
extern "C" int vt_gemm_bf16(const void* A, const void* W, const void* bias, const void* res,
                            void* C, int M, int N, int K, int act, int out_bf16, int variant,
                            int split, int bn, void* stream) {
  const GemmArgs g = {reinterpret_cast<const __nv_bfloat16*>(A),
                      reinterpret_cast<const __nv_bfloat16*>(W),
                      reinterpret_cast<const float*>(bias),
                      reinterpret_cast<const float*>(res),
                      C, M, N, K, act, out_bf16, reinterpret_cast<cudaStream_t>(stream)};
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (M < 1 || K < 32 || K % 32 || N < 64 || N % 64) return invalid;
  // TMA reads 16-byte aligned rows
  const bool aligned =
      reinterpret_cast<uintptr_t>(A) % 16 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;
  const bool split_ok = split == 1 || split == 2 || split == 4;
  if (variant == 1) {
    if (split != 1 || bn != 0 || !aligned) return invalid;
    return launch_large<4, 2, 4, 1>(g);
  }
  if (variant == 2) {
    if (!split_ok || bn != 0) return invalid;
    switch ((M + 63) / 64) {
      case 1: return launch_small<1, 1>(g, split);
      case 2: return launch_small<2, 1>(g, split);
      case 3: return launch_small<3, 1>(g, split);
      case 4: return launch_small<4, 1>(g, split);
      default: return invalid;
    }
  }
  if (variant == 3) {
    if (!split_ok || !aligned) return invalid;
    if (bn == 64) return launch_mid<1>(g, split);
    if (bn == 128) return launch_mid<2>(g, split);
  }
  return invalid;
}

// The decoder's cross K and V of one layer (kernel 4): X [B S, D] bf16, W
// [D, 2D] bf16 (Wk | Wv), bias [2D] f32 -> K and V [B, D, S], int8 with
// scales [B, D] f32 (is_int8 = 1) or bf16 (is_int8 = 0, scales NULL).
// `tiles` is kernels/primitives.cross_kv_plan's row tiles an item,
// ceil(S / 256), at most 4; D % 64 == 0; X and W start on 16 bytes. Anything
// else is refused with cudaErrorInvalidValue.
extern "C" int vt_cross_kv(const void* X, const void* W, const void* bias, void* out_k,
                           void* out_v, void* scale_k, void* scale_v, int B, int S, int D,
                           int tiles, int is_int8, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  constexpr int BM = Tile<KV_WGS, KV_NA, KV_STAGES>::BM;
  if (B < 1 || S < 1 || D < 64 || D % 64 || tiles != (S + BM - 1) / BM || tiles > KV_MAX_TILES)
    return invalid;
  if (reinterpret_cast<uintptr_t>(X) % 16 || reinterpret_cast<uintptr_t>(W) % 16 ||
      reinterpret_cast<uintptr_t>(bias) % 8 || out_k == nullptr || out_v == nullptr)
    return invalid;
  const auto x = reinterpret_cast<const __nv_bfloat16*>(X);
  const auto w = reinterpret_cast<const __nv_bfloat16*>(W);
  const auto b = reinterpret_cast<const float*>(bias);
  const auto st = reinterpret_cast<cudaStream_t>(stream);
  if (is_int8) {
    if (scale_k == nullptr || scale_v == nullptr) return invalid;
    return launch_cross_kv<true>(x, w, b, out_k, out_v, reinterpret_cast<float*>(scale_k),
                                 reinterpret_cast<float*>(scale_v), B, S, D, tiles, tiles, st);
  }
  return launch_cross_kv<false>(x, w, b, out_k, out_v, nullptr, nullptr, B, S, D, tiles, tiles,
                                st);
}

// Kernel 4 past KV_MAX_TILES row tiles an item (LED's long articles): K and
// V [B, D, S] bf16 as vt_cross_kv's bf16 form, in clusters of the column
// pair alone; `tiles` = ceil(S / 256) > KV_MAX_TILES. kernel 5
// (vt_cross_kv_quant) then makes the int8 form. Anything else is refused
// with cudaErrorInvalidValue.
extern "C" int vt_cross_kv_long(const void* X, const void* W, const void* bias, void* out_k,
                                void* out_v, int B, int S, int D, int tiles, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  constexpr int BM = Tile<KV_WGS, KV_NA, KV_STAGES>::BM;
  if (B < 1 || S < 1 || D < 64 || D % 64 || tiles != (S + BM - 1) / BM || tiles <= KV_MAX_TILES)
    return invalid;
  if (reinterpret_cast<uintptr_t>(X) % 16 || reinterpret_cast<uintptr_t>(W) % 16 ||
      reinterpret_cast<uintptr_t>(bias) % 8 || out_k == nullptr || out_v == nullptr)
    return invalid;
  return launch_cross_kv<false>(reinterpret_cast<const __nv_bfloat16*>(X),
                                reinterpret_cast<const __nv_bfloat16*>(W),
                                reinterpret_cast<const float*>(bias), out_k, out_v, nullptr,
                                nullptr, B, S, D, tiles, 1, reinterpret_cast<cudaStream_t>(stream));
}

// Kernel 5: K and V [rows, S] bf16 -> int8 [rows, S] and scales [rows] f32,
// a row an (item, channel): scale = max(amax / 127, 1e-12), q = clamp(rint(y
// / scale), -127, 127). Needs rows >= 1, S >= 1 and every pointer on 16
// bytes; anything else is refused with cudaErrorInvalidValue.
extern "C" int vt_cross_kv_quant(const void* src_k, const void* src_v, void* dst_k, void* dst_v,
                                 void* scale_k, void* scale_v, int rows, int S, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (rows < 1 || S < 1 || 2LL * rows > 2147483647LL) return invalid;
  for (const void* p : {src_k, src_v, static_cast<const void*>(dst_k),
                        static_cast<const void*>(dst_v), static_cast<const void*>(scale_k),
                        static_cast<const void*>(scale_v)})
    if (p == nullptr || reinterpret_cast<uintptr_t>(p) % 16) return invalid;
  cross_kv_quant_kernel<<<2 * rows, QUANT_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(src_k), reinterpret_cast<const __nv_bfloat16*>(src_v),
      reinterpret_cast<int8_t*>(dst_k), reinterpret_cast<int8_t*>(dst_v),
      reinterpret_cast<float*>(scale_k), reinterpret_cast<float*>(scale_v), rows, S);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory, in bytes a block, of the kernel that variant, M and
// bn select in vt_gemm_bf16; 0 where it would refuse them.
extern "C" int vt_gemm_smem_bytes(int variant, int M, int bn) {
  if (variant == 1) return bn == 0 ? large_smem<4, 2, 4>() : 0;
  if (variant == 3) return bn == 64 ? mid_smem<1>() : bn == 128 ? mid_smem<2>() : 0;
  if (variant != 2 || bn != 0) return 0;
  switch ((M + 63) / 64) {
    case 1: return Tile<1, 1, small_stages(1, 1)>::SMEM_BYTES;
    case 2: return Tile<2, 1, small_stages(2, 1)>::SMEM_BYTES;
    case 3: return Tile<3, 1, small_stages(3, 1)>::SMEM_BYTES;
    case 4: return Tile<4, 1, small_stages(4, 1)>::SMEM_BYTES;
    default: return 0;
  }
}

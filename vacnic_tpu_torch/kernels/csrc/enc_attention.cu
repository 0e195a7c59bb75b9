// Encoder attention of the fused multimodal text stack.
//
// Replaces: the attention blocks of vacnic_tpu/kernels/encoder_stack.py:
//   _kernel -- (1) text self-attention over S = 512 tokens with the per-item
//   additive pad bias [B, S], and (2) cross-attention from the text tokens
//   to the layer's precomputed img+ner K/V (KV = 40, 20 for only_image; no
//   bias: the img+ner mask is all ones in the supported configs).
// Semantics (both): q is rounded to bf16 after the head_dim**-0.5 scaling,
//   scores and softmax are f32, the normalised probabilities are rounded to
//   bf16 before the value product, which accumulates in f32; the head output
//   is bf16.
//
// Bound on the H100, B = 32, S = 512, H = 16, hd = 64, per layer:
//   self: q, k, v and o are 134 MB, ~40 us at 3.35 TB/s (bytes); the two
//     products are 4*B*H*S*S*hd = 34.4 GFLOP, ~35 us at 989 TFLOP/s, close
//     behind. The design below computes Q K^T twice (51.6 GFLOP, ~52 us).
//   cross: ~2.7 GFLOP against ~64 MB of q and o -- bytes bound (~20 us):
//     the kernel has to move q in and o out at the memory's rate.
// Design, self: the probabilities are rounded after the exact normalisation,
//   which an online rescale of the output cannot reproduce, so the kernel
//   makes two passes over the keys. Pass 1 computes Q K^T + bias tile by
//   tile and keeps only each row's running (max, denominator) in registers;
//   pass 2 recomputes the scores, forms p = exp(s - m) / l, rounds it to bf16
//   in registers and accumulates P V. One block of one warpgroup (4 warps)
//   per (item, head, 64-row query tile), four blocks resident per SM (16
//   warps); each warp owns 16 query rows. Q fragments (scaled and rounded
//   once), scores, probabilities, the f32 output and the statistics live in
//   registers; the three products are wgmma.mma_async m64n64k16
//   (attn_tiles.cuh) with A from registers and the K or V tile read from
//   shared memory once per block. Shared memory holds a two-stage ring of
//   64-key tiles (K alone in pass 1, K and V in pass 2) filled by cp.async
//   one tile ahead of the products, with one __syncthreads a tile, and the
//   item's f32 pad-bias row. The passes are two loops, not one loop with a
//   branch (see the note on ptxas in attn_tiles.cuh). Streaming the tiles per
//   query tile, rather than keeping a head's whole K and V resident (128 KB,
//   one block per SM, a cap on S), leaves room for four blocks per SM, shares
//   the ring with flash_attn.cu, fills the card at small batch (1024 blocks
//   at B = 8) and lifts the S <= 512 cap; the repeated K/V reads (K twice, V
//   once per query tile) come from L2.
//   The pad bias is read in f32, so the finfo(f32).min that the callers
//   build never overflows to -inf (the TPU kernel had to clamp it before a
//   bf16 cast). The output is stored as bf16 pairs, a quad of lanes covering
//   16 contiguous bytes of a row.
// Design, cross: the flash kernel with a single key tile, on the tensor
//   cores. One block of one warpgroup takes an (item, head) and every
//   gridDim.x-th 64-row tile of its q; the grid's x is as many tile groups
//   as keep every SM's four block slots busy (one group at B = 32, 512
//   blocks of eight tiles; four at B = 8). The head's K (hd x KV, keys
//   contiguous: the MN-major B of q K^T) and V (KV x hd: the MN-major B of
//   P V) are loaded once into swizzled 64 x 64 tiles, zero past KV (ck's
//   rows are KV x 2 bytes apart, 80 at KV 40, so K comes by scalar loads,
//   not TMA). q tiles stream through a ring of three by 16-byte cp.async,
//   two tiles ahead of the one in work, zero-filled past S. Per tile: the q
//   fragments are read from the ring, scaled and rounded to bf16 (A from
//   registers); S = q K^T is one m64n64 wgmma over k = 64; keys at or past
//   KV are set to -inf before the row max; the softmax runs in registers
//   (accurate expf, normalised by the reciprocal of the row sum, as the
//   kernel before); the normalised P is packed to bf16 as the A operand of
//   O = P V; O is rounded once, turned around in shared memory and stored
//   as whole 128-byte row slices. wgmma, not mma.sync: the same fragment
//   layouts as enc_self_attn_kernel (attn_tiles.cuh), one instruction a
//   k-step, and the tile operands read once a block; at 2.7 GFLOP the
//   kernel is bytes bound either way.
//
// (3) enc_window_kernel: LED's windowed self-attention (Longformer,
//   arXiv:2004.05150 §3; transformers' LEDEncoderSelfAttention), which
//   replaces no TPU kernel: the JAX package has no LED. Row i attends to the
//   keys j with |i - j| <= w (w = attention_window / 2) and to the item's
//   global keys j < G (the leading tokens with global attention, counted
//   once), each unless padded; the softmax is over that union, f32, exact;
//   a padded query row's probabilities are 0, so its output is 0. The rows
//   of the global tokens themselves are computed here too and then
//   overwritten by their global attention (kernels/encoder_stack).
//   Semantics as (1): q rounded to bf16 after the scaling, P to bf16 after
//   the exact normalisation, P V in f32, bf16 out.
// Bound on the H100, B = 32, S = 16384, H = 16, w = 512, a layer: the band
//   is 2w + 1 = 1025 keys a row, 4 * B * S * H * 1025 * 64 = 2.2 TFLOP, 2.2
//   ms at 989 TFLOP/s; q, k, v and o are 4.3 GB, 1.3 ms at 3.35 TB/s:
//   operations bound. As (1) it computes Q K^T twice: 3.3 TFLOP done.
// Design: enc_self_attn_kernel's, one block of one warpgroup a 64-row query
//   tile, two passes over a list of key tiles instead of all of them: the
//   tiles that meet [q0 - w, q0 + 63 + w] (17 at w = 512: 18 a tile minus
//   those cut by the item's ends) and, where that band does not reach it,
//   tile 0, which holds the global keys (G <= 64). Each score is masked by
//   the rule above in registers (-inf, exactly 0 after exp); the pad bias is
//   read from device memory (L1), not staged, so a block's shared memory is
//   the ring alone and four blocks share a SM at any S. A query tile whose
//   rows are all padding (the tail past an item's length) writes zeros and
//   returns: no copy, no product.

#include <float.h>
#include <math.h>
#include <stdint.h>
#include <initializer_list>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attn_tiles.cuh"

using namespace attn_tiles;

namespace {

constexpr int HD = 64;       // head dim the kernels are built for
constexpr int QT = 64;       // query rows per self-attention block, 16 per warp
constexpr int KT = 64;       // keys per shared-memory tile
constexpr int SELF_THREADS = QT / 16 * 32;
constexpr int KV_TILE_BYTES = KT * TILE_BYTES_PER_ROW;
constexpr int RING_BYTES = 2 * 2 * KV_TILE_BYTES;  // two stages of K tile | V tile
constexpr int SELF_SMEM_FIXED = RING_BYTES + TILE_ALIGN;  // + 4 S for the bias row
constexpr int MAX_S = 32768;  // bounds the bias row in shared memory
constexpr int MAX_KV = 64;
constexpr int CROSS_THREADS = QT / 16 * 32;  // one warpgroup: a 64-row q tile, 16 rows a warp
constexpr int CROSS_STAGES = 3;              // q tiles a block has in flight
// K tile | V tile | CROSS_STAGES q tiles | the output tile, + 1024 to align
constexpr int CROSS_SMEM = TILE_ALIGN + (3 + CROSS_STAGES) * KV_TILE_BYTES;
constexpr int CROSS_BLOCKS_PER_SM = 4;      // the block slots the grid fills
constexpr int WINDOW_SMEM = RING_BYTES + TILE_ALIGN;  // the ring alone: the bias stays in L1

__global__ void __launch_bounds__(SELF_THREADS, 4)
enc_self_attn_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int S, int H, float scaling) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_tiles(smem_raw);
  const uint32_t smem0 = smem_u32(smem);
  float* bias_s = reinterpret_cast<float*>(smem + RING_BYTES);

  const int d = H * HD, d3 = 3 * d;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t = lane & 3;
  const size_t tok0 = (size_t)b * S;
  const __nv_bfloat16* kbase = qkv + tok0 * d3 + d + h * HD;
  const __nv_bfloat16* vbase = kbase + d;
  const int row0 = q0 + warp * 16;  // this warp's first query row
  const int n_tiles = S / KT;

  // step i < n_tiles: K tile i (pass 1); step n_tiles + i: K and V tile i
  // (pass 2). Steps are started in order: the sources walk along, and K's
  // goes back to the first tile between the passes.
  TileLoader<SELF_THREADS> kload, vload;
  kload.init(kbase, d3, tid);
  vload.init(vbase, d3, tid);
  const long long tile_step = (long long)KT * d3;
  auto prefetch = [&](int step) {
    const uint32_t st = smem0 + (step & 1) * 2 * KV_TILE_BYTES;
    if (step == n_tiles) kload.src -= n_tiles * tile_step;
    kload.copy(st);
    kload.src += tile_step;
    if (step >= n_tiles) {
      vload.copy(st + KV_TILE_BYTES);
      vload.src += tile_step;
    }
    cp_async_commit();
  };

  prefetch(0);
  for (int i = tid; i < S; i += SELF_THREADS) bias_s[i] = bias[tok0 + i];

  // Q fragments, scaled and rounded to bf16 once
  uint32_t qf[4][4];
  load_q_frags(qf, qkv + (tok0 + row0) * d3 + h * HD, d3, lane);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qf[kk][e]));
      qf[kk][e] = pack_bf16x2(f.x * scaling, f.y * scaling);
    }
  }

  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m0 = -FLT_MAX, m1 = -FLT_MAX;  // rows g and g + 8: the exact row max after pass 1
  float l0 = 0.0f, l1 = 0.0f;          // pass 1: this lane's share of the denominators;
                                       // pass 2: their reciprocals

  // One step of either pass: waits for the step's tiles, starts the next
  // step's copies and computes s = Q K^T + bias for key tile `tile`.
  auto scores = [&](float (&s)[8][4], int step, int tile) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // the step's tiles have landed for everyone; the other stage is free
    if (step + 1 < 2 * n_tiles) prefetch(step + 1);
    qk_tile(s, qf, smem0 + (step & 1) * 2 * KV_TILE_BYTES);
    const float* bp = bias_s + tile * KT + 2 * t;
    float2 bv[8];  // read while the product runs
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = *reinterpret_cast<const float2*>(bp + 8 * j);
    wgmma_wait(s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] += bv[j].x;
      s[j][1] += bv[j].y;
      s[j][2] += bv[j].x;
      s[j][3] += bv[j].y;
    }
  };

  // pass 1: running (max, denominator)
  for (int tile = 0; tile < n_tiles; ++tile) {
    float s[8][4];
    scores(s, tile, tile);
    float mx0 = -FLT_MAX, mx1 = -FLT_MAX;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sum0 += fast_exp(s[j][0] - mn0) + fast_exp(s[j][1] - mn0);
      sum1 += fast_exp(s[j][2] - mn1) + fast_exp(s[j][3] - mn1);
    }
    l0 = l0 * fast_exp(m0 - mn0) + sum0;
    l1 = l1 * fast_exp(m1 - mn1) + sum1;
    m0 = mn0;
    m1 = mn1;
  }
  l0 = 1.0f / quad_sum(l0);
  l1 = 1.0f / quad_sum(l1);

  // pass 2: normalised probabilities, rounded to bf16, times V
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int step = n_tiles + tile;
    float s[8][4];
    scores(s, step, tile);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = fast_exp(s[j][0] - m0) * l0;
      s[j][1] = fast_exp(s[j][1] - m0) * l0;
      s[j][2] = fast_exp(s[j][2] - m1) * l1;
      s[j][3] = fast_exp(s[j][3] - m1) * l1;
    }
    uint32_t pf[4][4];
    pack_p_frags(pf, s);
    pv_tile(o, pf, smem0 + ((step & 1) * 2 + 1) * KV_TILE_BYTES);
    wgmma_wait(o);  // before the next step's copies may overwrite this stage
  }

  store_o_tile(out + (tok0 + row0) * d + h * HD, d, o, 1.0f, 1.0f, lane);
}

// grid (S / 64, H, B): block (x, h, b) takes query rows 64x .. 64x + 63 of
// item b, head h, over the key tiles of its band and the global tile.
__global__ void __launch_bounds__(SELF_THREADS, 4)
enc_window_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, int S, int H, int w, int G, float scaling) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_tiles(smem_raw);
  const uint32_t smem0 = smem_u32(smem);

  const int d = H * HD, d3 = 3 * d;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const size_t tok0 = (size_t)b * S;
  const float* brow = bias + tok0;  // the item's pad bias: 0 where a token is kept
  const int row0 = q0 + warp * 16;  // this warp's first query row
  const int ra = row0 + g, rb = ra + 8;  // this lane's two rows
  __nv_bfloat16* obase = out + (tok0 + row0) * d + h * HD;

  // a tile of padding alone: its probabilities are all 0
  if (!__syncthreads_or(tid < QT && __ldg(brow + q0 + tid) == 0.0f)) {
    float z[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) z[j][0] = z[j][1] = z[j][2] = z[j][3] = 0.0f;
    store_o_tile(obase, d, z, 1.0f, 1.0f, lane);
    return;
  }

  // the key tiles: [global tile 0,] lo .. hi
  const int lo = max(0, q0 - w) / KT, hi = min(S - 1, q0 + QT - 1 + w) / KT;
  const int extra = (G > 0 && lo > 0) ? 1 : 0;
  const int n_tiles = extra + hi - lo + 1;
  auto tile_of = [&](int i) { return i < extra ? 0 : lo + i - extra; };

  const __nv_bfloat16* kbase = qkv + tok0 * d3 + d + h * HD;
  const __nv_bfloat16* vbase = kbase + d;
  TileLoader<SELF_THREADS> kload, vload;
  kload.init(kbase, d3, tid);
  vload.init(vbase, d3, tid);
  const __nv_bfloat16* k0 = kload.src;
  const __nv_bfloat16* v0 = vload.src;
  const long long tile_step = (long long)KT * d3;
  // step i < n_tiles: K of tile_of(i) (pass 1); n_tiles + i: its K and V (pass 2)
  auto prefetch = [&](int step) {
    const uint32_t st = smem0 + (step & 1) * 2 * KV_TILE_BYTES;
    const int tile = tile_of(step < n_tiles ? step : step - n_tiles);
    kload.src = k0 + tile * tile_step;
    kload.copy(st);
    if (step >= n_tiles) {
      vload.src = v0 + tile * tile_step;
      vload.copy(st + KV_TILE_BYTES);
    }
    cp_async_commit();
  };
  prefetch(0);

  uint32_t qf[4][4];
  load_q_frags(qf, qkv + (tok0 + row0) * d3 + h * HD, d3, lane);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qf[kk][e]));
      qf[kk][e] = pack_bf16x2(f.x * scaling, f.y * scaling);
    }
  }

  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m0 = -FLT_MAX, m1 = -FLT_MAX;
  float l0 = 0.0f, l1 = 0.0f;

  // s = Q K^T + bias for the step's key tile, -inf where a key is neither
  // in the row's band nor global
  auto scores = [&](float (&s)[8][4], int step, int tile) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (step + 1 < 2 * n_tiles) prefetch(step + 1);
    qk_tile(s, qf, smem0 + (step & 1) * 2 * KV_TILE_BYTES);
    const int key0 = tile * KT + 2 * t;
    float2 bv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = __ldg(reinterpret_cast<const float2*>(brow + key0 + 8 * j));
    wgmma_wait(s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + 8 * j + e;
        const float bb = e ? bv[j].y : bv[j].x;
        const bool glob = key < G;
        s[j][e] = (glob || abs(ra - key) <= w) ? s[j][e] + bb : -INFINITY;
        s[j][2 + e] = (glob || abs(rb - key) <= w) ? s[j][2 + e] + bb : -INFINITY;
      }
    }
  };

  for (int i = 0; i < n_tiles; ++i) {
    float s[8][4];
    scores(s, i, tile_of(i));
    float mx0 = -FLT_MAX, mx1 = -FLT_MAX;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sum0 += fast_exp(s[j][0] - mn0) + fast_exp(s[j][1] - mn0);
      sum1 += fast_exp(s[j][2] - mn1) + fast_exp(s[j][3] - mn1);
    }
    l0 = l0 * fast_exp(m0 - mn0) + sum0;
    l1 = l1 * fast_exp(m1 - mn1) + sum1;
    m0 = mn0;
    m1 = mn1;
  }
  l0 = 1.0f / quad_sum(l0);
  l1 = 1.0f / quad_sum(l1);

  for (int i = 0; i < n_tiles; ++i) {
    const int step = n_tiles + i;
    float s[8][4];
    scores(s, step, tile_of(i));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = fast_exp(s[j][0] - m0) * l0;
      s[j][1] = fast_exp(s[j][1] - m0) * l0;
      s[j][2] = fast_exp(s[j][2] - m1) * l1;
      s[j][3] = fast_exp(s[j][3] - m1) * l1;
    }
    uint32_t pf[4][4];
    pack_p_frags(pf, s);
    pv_tile(o, pf, smem0 + ((step & 1) * 2 + 1) * KV_TILE_BYTES);
    wgmma_wait(o);
  }

  // a padded query row's probabilities are 0
  store_o_tile(obase, d, o, __ldg(brow + ra) == 0.0f ? 1.0f : 0.0f,
               __ldg(brow + rb) == 0.0f ? 1.0f : 0.0f, lane);
}

// One 16-byte asynchronous copy that reads `src` only when `ok`, and
// writes zeros otherwise (src-size 0): the q rows past S.
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__global__ void __launch_bounds__(CROSS_THREADS, 4)  // four blocks an SM: 4 x 49 KB
enc_cross_attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ ck,
                      const __nv_bfloat16* __restrict__ cv, __nv_bfloat16* __restrict__ out,
                      int S, int KV, int H, float scaling) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_tiles(smem_raw);
  const uint32_t smem0 = smem_u32(smem);
  const uint32_t ktile = smem0, vtile = smem0 + KV_TILE_BYTES;  // K [hd][key], V [key][hd]
  const uint32_t ring0 = smem0 + 2 * KV_TILE_BYTES;               // CROSS_STAGES q tiles
  unsigned char* ostage = smem + (2 + CROSS_STAGES) * KV_TILE_BYTES;  // the output tile

  const int d = H * HD;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const size_t tok0 = (size_t)b * S;
  const __nv_bfloat16* qbase = q + tok0 * d + h * HD;
  // this block's q tiles: blockIdx.x, blockIdx.x + gridDim.x, ...
  const int n_tiles = (S + QT - 1) / QT;
  const int mine = ((int)blockIdx.x < n_tiles) ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;

  // the block's i-th tile into ring slot i % CROSS_STAGES; one commit group
  // a tile, empty past the last, so that the wait below counts alike
  auto prefetch = [&](int i) {
    if (i < mine) {
      const int q0 = (blockIdx.x + i * gridDim.x) * QT;
      const uint32_t dst = ring0 + (i % CROSS_STAGES) * KV_TILE_BYTES;
#pragma unroll
      for (int k = 0; k < QT * 8 / CROSS_THREADS; ++k) {
        const int c = tid + k * CROSS_THREADS, row = c >> 3, chunk = c & 7;
        const bool ok = q0 + row < S;
        cp_async16_zfill(dst + swz(row, chunk),
                         qbase + (size_t)(ok ? q0 + row : 0) * d + chunk * 8, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < CROSS_STAGES - 1; ++i) prefetch(i);

  // K and V of the (item, head), once, zero past KV: K's row j is head
  // column j of ck (keys contiguous, KV x 2 bytes apart: scalar loads), V's
  // row k is key k of cv (16-byte loads)
  const __nv_bfloat16* kbase = ck + ((size_t)b * d + h * HD) * KV;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
#pragma unroll
  for (int k = 0; k < HD * 8 / CROSS_THREADS; ++k) {
    const int c = tid + k * CROSS_THREADS, j = c >> 3, chunk = c & 7;
    __align__(16) __nv_bfloat16 e[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int key = chunk * 8 + i;
      e[i] = key < KV ? kbase[(size_t)j * KV + key] : zero;
    }
    *reinterpret_cast<uint4*>(smem + swz(j, chunk)) = *reinterpret_cast<const uint4*>(e);
  }
#pragma unroll
  for (int k = 0; k < MAX_KV * 8 / CROSS_THREADS; ++k) {
    const int c = tid + k * CROSS_THREADS, key = c >> 3, chunk = c & 7;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (key < KV)
      v = __ldg(reinterpret_cast<const uint4*>(cv + ((size_t)b * KV + key) * d + h * HD) + chunk);
    *reinterpret_cast<uint4*>(smem + KV_TILE_BYTES + swz(key, chunk)) = v;
  }
  fence_proxy_async();  // written by the threads, read by wgmma

  const int row0 = warp * 16 + g;  // this lane's rows of a tile: row0, row0 + 8
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<CROSS_STAGES - 2>();
    __syncthreads();  // tile i has landed for all; slot i - 1 and the output tile are free
    prefetch(i + CROSS_STAGES - 1);
    const int q0 = (blockIdx.x + i * gridDim.x) * QT;

    // q fragments (A from registers) from the swizzled slot, scaled and
    // rounded to bf16
    const unsigned char* qs = smem + 2 * KV_TILE_BYTES + (i % CROSS_STAGES) * KV_TILE_BYTES;
    uint32_t qf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e & 1) * 8, chunk = 2 * kk + (e >> 1);
        const uint32_t raw = *reinterpret_cast<const uint32_t*>(qs + swz(row, chunk) + 4 * t);
        const float2 f =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
        qf[kk][e] = pack_bf16x2(f.x * scaling, f.y * scaling);
      }
    }

    // S = q K^T: K [hd][key] is the MN-major B operand; head-dim step kk
    // starts 16 rows (2048 bytes) further on
    float s[8][4];
    const uint64_t kdesc = wgmma_tile_desc(ktile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16<1>(s, qf[kk], kdesc + 128 * kk, kk != 0);
    wgmma_commit();
    wgmma_wait(s);

    // the keys at or past KV are padding: -inf before the max
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (8 * j + 2 * t + e >= KV) s[j][e] = s[j][2 + e] = -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = expf(s[j][0] - mx0);
      s[j][1] = expf(s[j][1] - mx0);
      s[j][2] = expf(s[j][2] - mx1);
      s[j][3] = expf(s[j][3] - mx1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
    const float inv0 = 1.0f / quad_sum(l0), inv1 = 1.0f / quad_sum(l1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // the normalised probabilities, rounded by pack_p_frags
      s[j][0] *= inv0;
      s[j][1] *= inv0;
      s[j][2] *= inv1;
      s[j][3] *= inv1;
    }
    uint32_t pf[4][4];
    pack_p_frags(pf, s);
    float o[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
    pv_tile(o, pf, vtile);
    wgmma_wait(o);

    // the output turned around in shared memory, then stored as 16-byte
    // pieces of rows: a warp writes four whole 128-byte row slices
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(ostage + swz(row0, j) + 4 * t) = pack_bf16x2(o[j][0], o[j][1]);
      *reinterpret_cast<uint32_t*>(ostage + swz(row0 + 8, j) + 4 * t) =
          pack_bf16x2(o[j][2], o[j][3]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < QT * 8 / CROSS_THREADS; ++k) {
      const int c = tid + k * CROSS_THREADS, row = c >> 3, chunk = c & 7;
      if (q0 + row < S)
        *reinterpret_cast<uint4*>(out + (tok0 + q0 + row) * d + h * HD + chunk * 8) =
            *reinterpret_cast<const uint4*>(ostage + swz(row, chunk));
    }
  }
}

}  // namespace

// qkv [B*S, 3*H*64] bf16 (q | k | v), bias [B, S] f32, out [B*S, H*64] bf16.
// Needs S % 64 == 0 and S <= 32768.
extern "C" int vt_enc_self_attention(const void* qkv, const void* bias, void* out, int B, int S,
                                     int H, float scaling, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (S % KT || S > MAX_S) return static_cast<int>(cudaErrorInvalidValue);
  static device_state::PerDevice configured;  // the attribute is set once a device, not a launch
  const cudaError_t e = allow_smem(enc_self_attn_kernel, SELF_SMEM_FIXED + MAX_S * 4, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(S / QT, H, B);
  enc_self_attn_kernel<<<grid, SELF_THREADS, SELF_SMEM_FIXED + (size_t)S * 4, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(qkv), reinterpret_cast<const float*>(bias),
      reinterpret_cast<__nv_bfloat16*>(out), S, H, scaling);
  return static_cast<int>(cudaGetLastError());
}

// LED's windowed self-attention: qkv, bias and out as vt_enc_self_attention,
// w the band's half width (attention_window / 2, >= 0), G the leading global
// tokens (0 .. 64). Needs S % 64 == 0 and S <= 32768; anything else is
// refused with cudaErrorInvalidValue.
extern "C" int vt_enc_window_attention(const void* qkv, const void* bias, void* out, int B, int S,
                                       int H, int w, int G, float scaling, void* stream) {
  if (B < 1 || H < 1 || S < KT || S % KT || S > MAX_S || w < 0 || G < 0 || G > KT)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 65535 || H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  static device_state::PerDevice configured;  // the attribute is set once a device, not a launch
  const cudaError_t e = allow_smem(enc_window_kernel, WINDOW_SMEM, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(S / QT, H, B);
  enc_window_kernel<<<grid, SELF_THREADS, WINDOW_SMEM, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(qkv), reinterpret_cast<const float*>(bias),
      reinterpret_cast<__nv_bfloat16*>(out), S, H, w, G, scaling);
  return static_cast<int>(cudaGetLastError());
}

// q [B*S, H*64] bf16, ck [B, H*64, KV] bf16, cv [B, KV, H*64] bf16,
// out [B*S, H*64] bf16. Needs 1 <= KV <= 64, S >= 1 and q, cv and out on
// 16 bytes; anything else is refused with cudaErrorInvalidValue.
extern "C" int vt_enc_cross_attention(const void* q, const void* ck, const void* cv, void* out,
                                      int B, int S, int KV, int H, float scaling, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || S < 1 || H < 1 || KV < 1 || KV > MAX_KV) return invalid;
  for (const void* p : {q, cv, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return invalid;
  static device_state::PerDevice configured;  // the attribute is set once a device, not a launch
  const cudaError_t e = allow_smem(enc_cross_attn_kernel, CROSS_SMEM, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  // blocks an (item, head), each taking every groups-th q tile: as many as
  // fill the SMs' block slots, at least one and at most one a q tile
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const long long fill = (long long)sms * CROSS_BLOCKS_PER_SM / ((long long)B * H);
  const int tiles = (S + QT - 1) / QT;
  const int groups = fill < 1 ? 1 : fill > tiles ? tiles : static_cast<int>(fill);
  dim3 grid(groups, H, B);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  enc_cross_attn_kernel<<<grid, CROSS_THREADS, CROSS_SMEM, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), reinterpret_cast<const __nv_bfloat16*>(ck),
      reinterpret_cast<const __nv_bfloat16*>(cv), reinterpret_cast<__nv_bfloat16*>(out), S, KV,
      H, scaling);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory a block of enc_cross_attn_kernel takes. Returns
// bytes, not an error code.
extern "C" int vt_enc_cross_smem_bytes() { return CROSS_SMEM; }

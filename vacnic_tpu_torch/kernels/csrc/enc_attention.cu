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
//   cross: ~2.7 GFLOP against ~64 MB of q and o -- bytes bound (~20 us).
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
// Design, cross: one thread per query row, the head's K [hd, KV] and
//   V [KV, hd] in shared memory as f32 and read by broadcast; KV <= 64.

#include <float.h>
#include <math.h>
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

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

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

__global__ void __launch_bounds__(128)
enc_cross_attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ ck,
                      const __nv_bfloat16* __restrict__ cv, __nv_bfloat16* __restrict__ out,
                      int S, int KV, int H, float scaling) {
  __shared__ float Ks[HD][MAX_KV];
  __shared__ float Vs[MAX_KV][HD];
  const int d = H * HD;
  const int h = blockIdx.y, b = blockIdx.z;
  for (int i = threadIdx.x; i < HD * KV; i += blockDim.x) {
    const int j = i / KV, kv = i % KV;  // ck is [B, d, KV]
    Ks[j][kv] = __bfloat162float(ck[((size_t)b * d + h * HD + j) * KV + kv]);
  }
  for (int i = threadIdx.x; i < KV * HD; i += blockDim.x) {
    const int kv = i / HD, j = i % HD;  // cv is [B, KV, d]
    Vs[kv][j] = __bfloat162float(cv[((size_t)b * KV + kv) * d + h * HD + j]);
  }
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= S) return;
  const size_t tok = (size_t)b * S + row;

  float qv[HD];
  const uint4* qp = reinterpret_cast<const uint4*>(q + tok * d + h * HD);
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    uint4 raw = qp[c];
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) qv[c * 8 + i] = bf16_round(__bfloat162float(e[i]) * scaling);
  }
  float s[MAX_KV];
  float m = -INFINITY;
#pragma unroll
  for (int kv = 0; kv < MAX_KV; ++kv) {
    float a = 0.0f;
    if (kv < KV) {
#pragma unroll
      for (int j = 0; j < HD; ++j) a += qv[j] * Ks[j][kv];
      m = fmaxf(m, a);
    }
    s[kv] = a;
  }
  float l = 0.0f;
#pragma unroll
  for (int kv = 0; kv < MAX_KV; ++kv) {
    s[kv] = (kv < KV) ? expf(s[kv] - m) : 0.0f;
    l += s[kv];
  }
  const float inv = 1.0f / l;
  float o[HD];
#pragma unroll
  for (int j = 0; j < HD; ++j) o[j] = 0.0f;
#pragma unroll
  for (int kv = 0; kv < MAX_KV; ++kv) {
    if (kv < KV) {
      const float p = bf16_round(s[kv] * inv);
#pragma unroll
      for (int j = 0; j < HD; ++j) o[j] += p * Vs[kv][j];
    }
  }
  uint4* op = reinterpret_cast<uint4*>(out + tok * d + h * HD);
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    uint4 raw;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(o[c * 8 + i]);
    op[c] = raw;
  }
}

}  // namespace

// qkv [B*S, 3*H*64] bf16 (q | k | v), bias [B, S] f32, out [B*S, H*64] bf16.
// Needs S % 64 == 0 and S <= 32768.
extern "C" int vt_enc_self_attention(const void* qkv, const void* bias, void* out, int B, int S,
                                     int H, float scaling, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (S % KT || S > MAX_S) return static_cast<int>(cudaErrorInvalidValue);
  static int configured_device = -1;  // the attribute is set once per device, not per launch
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev != configured_device) {
    e = cudaFuncSetAttribute(enc_self_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SELF_SMEM_FIXED + MAX_S * 4);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured_device = dev;
  }
  dim3 grid(S / QT, H, B);
  enc_self_attn_kernel<<<grid, SELF_THREADS, SELF_SMEM_FIXED + (size_t)S * 4, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(qkv), reinterpret_cast<const float*>(bias),
      reinterpret_cast<__nv_bfloat16*>(out), S, H, scaling);
  return static_cast<int>(cudaGetLastError());
}

// q [B*S, H*64] bf16, ck [B, H*64, KV] bf16, cv [B, KV, H*64] bf16,
// out [B*S, H*64] bf16. Needs KV <= 64.
extern "C" int vt_enc_cross_attention(const void* q, const void* ck, const void* cv, void* out,
                                      int B, int S, int KV, int H, float scaling, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid((S + 127) / 128, H, B);
  enc_cross_attn_kernel<<<grid, 128, 0, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), reinterpret_cast<const __nv_bfloat16*>(ck),
      reinterpret_cast<const __nv_bfloat16*>(cv), reinterpret_cast<__nv_bfloat16*>(out), S, KV,
      H, scaling);
  return static_cast<int>(cudaGetLastError());
}

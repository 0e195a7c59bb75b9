// Flash attention with an additive bias (non-causal), online softmax.
//
// Replaces: vacnic_tpu/kernels/flash_attn.py:flash_attention (_flash_kernel
//   :28, pallas_call :87), the long-sequence path of models/layers
//   attention_core.
// Computes, per (item b, head h): o = softmax(q k^T + bias) v with q already
//   scaled by the caller. Scores and the softmax statistics are f32; the
//   probabilities are rounded to bf16 before the value product, which
//   accumulates in f32; the output is normalised after P V,
//   o = acc / max(l, 1e-30), and rounded to bf16. The running max starts at
//   finfo(f32).min (not -inf), so a row whose keys are all masked stays
//   finite (uniform weights for a finite mask, zeros for a -inf one).
//
// Bound on the H100 at the encoder's shape (B 32, H 16, T = S = 512, D 64,
//   a [B, 1, T, S] bf16 bias): q, k, v and o are 134 MB and the bias 17 MB,
//   ~45 us at 3.35 TB/s (bytes); the 34 GFLOP take ~35 us at 989 TFLOP/s.
//   Bytes and operations are close, so the design has to keep both the
//   memory pipe and the tensor cores busy at once.
// Design: one block of one warpgroup (4 warps) per (item x head, 64-row query
//   tile), four blocks resident per SM with a bf16 bias and three with an f32
//   bias (16 / 12 warps); each warp owns 16 query rows. The warp's Q
//   fragments, its 16 x 64 score tile, the probabilities, its 16 x 64 f32
//   output and the rows' running max and denominator all live in registers.
//   Both products are wgmma.mma_async m64n64k16 (attn_tiles.cuh) with A from
//   registers and the K or V tile read from shared memory once per block: the
//   score accumulators, rounded to bf16 pairs, are the A operand of P V, and
//   the output is rescaled by exp(m_old - m_new) in registers. Shared memory
//   holds only a two-stage ring of {K tile, V tile, bias tile} for 64 keys:
//   tile i + 1 is in flight (cp.async, 16 bytes a lane) while tile i is
//   multiplied, with one __syncthreads a tile. The bias tile (64 rows x 64
//   keys) rides the same ring in coalesced 16-byte copies and is read back
//   in the accumulator layout from rows padded by eight elements
//   (conflict-free).
//   q, k, v, o and the bias are addressed through (item, head, row) strides
//   with a unit last stride: the head-split views of [B, T, d] projections
//   are read in place, a [B, 1, T, S] bias is read with a head stride of 0
//   (never expanded over heads; the heads of an item find its tiles in L2),
//   and o is written straight into the [B, T, H, D] layout that the head
//   merge reads without a copy, a quad of lanes covering 16 contiguous bytes.

#include <float.h>
#include <math.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attn_tiles.cuh"

using namespace attn_tiles;

namespace {

constexpr int D = 64;          // head dim
constexpr int QT = 64;         // query rows per block, 16 per warp
constexpr int KT = 64;         // keys per tile
constexpr int THREADS = QT / 16 * 32;
constexpr int KV_TILE_BYTES = KT * TILE_BYTES_PER_ROW;

struct Strides {
  long long b, h, t;
};

// Layout of one ring stage: K tile | V tile | bias tile [QT][KT + 8]. The
// eight elements of padding shift each row by 4 (bf16) or 8 (f32) banks, so
// the quads of a warp, reading rows g = 0..7 at the same columns, hit
// different banks.
template <typename BiasT>
struct Stage {
  static constexpr int BIAS_ROW_BYTES = (KT + 8) * (int)sizeof(BiasT);
  static constexpr int BIAS_CHUNKS = KT * (int)sizeof(BiasT) / 16;  // 16-byte chunks a row
  static constexpr int BYTES = 2 * KV_TILE_BYTES + QT * BIAS_ROW_BYTES;
};

__device__ __forceinline__ float2 bias_pair(const unsigned char* p, float) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 bias_pair(const unsigned char* p, __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename BiasT>
__global__ void __launch_bounds__(THREADS, sizeof(BiasT) == 2 ? 4 : 3)
flash_attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const BiasT* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, int H, int S, Strides qs, Strides ks,
                  Strides vs, Strides bs, Strides os) {
  using St = Stage<BiasT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_tiles(smem_raw);
  const uint32_t smem0 = smem_u32(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * QT;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  const BiasT* bb = bias + b * bs.b + h * bs.h;
  const int row0 = q0 + warp * 16;  // this warp's first query row

  // this thread's copies of a stage: two chunks a K and V tile, and chunk
  // tid % BIAS_CHUNKS of every (THREADS / BIAS_CHUNKS)-th row of the bias tile
  TileLoader<THREADS> kload, vload;
  kload.init(kb, ks.t, tid);
  vload.init(vb, vs.t, tid);
  constexpr int BIAS_ROWS_A_PASS = THREADS / St::BIAS_CHUNKS;
  const int brow0 = tid / St::BIAS_CHUNKS, bch = tid % St::BIAS_CHUNKS;
  const BiasT* bsrc = bb + (q0 + brow0) * bs.t + bch * (16 / (int)sizeof(BiasT));
  const long long bstep = BIAS_ROWS_A_PASS * bs.t;
  const uint32_t bdst = 2 * KV_TILE_BYTES + brow0 * St::BIAS_ROW_BYTES + bch * 16;

  auto prefetch = [&](int tile) {  // tiles are started in order: the sources walk along
    const uint32_t st = smem0 + (tile & 1) * St::BYTES;
    kload.copy(st);
    vload.copy(st + KV_TILE_BYTES);
    kload.src += KT * ks.t;
    vload.src += KT * vs.t;
#pragma unroll
    for (int i = 0; i < QT / BIAS_ROWS_A_PASS; ++i)
      cp_async16(st + bdst + i * BIAS_ROWS_A_PASS * St::BIAS_ROW_BYTES, bsrc + i * bstep);
    bsrc += KT;
    cp_async_commit();
  };

  prefetch(0);
  uint32_t qf[4][4];
  load_q_frags(qf, q + b * qs.b + h * qs.h + row0 * qs.t, qs.t, lane);

  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m0 = -FLT_MAX, m1 = -FLT_MAX;  // running max of rows g and g + 8
  float l0 = 0.0f, l1 = 0.0f;          // this lane's share of the denominators

  const int n_tiles = S / KT;
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // tile has landed for everyone; the other stage is free
    if (tile + 1 < n_tiles) prefetch(tile + 1);

    const unsigned char* st = smem + (tile & 1) * St::BYTES;
    const uint32_t st_u32 = smem0 + (tile & 1) * St::BYTES;
    float s[8][4];
    qk_tile(s, qf, st_u32);

    const unsigned char* brow = st + 2 * KV_TILE_BYTES + (warp * 16 + g) * St::BIAS_ROW_BYTES +
                                2 * t * (int)sizeof(BiasT);
    float mx0 = -FLT_MAX, mx1 = -FLT_MAX;
    wgmma_wait(s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 b0 = bias_pair(brow + 8 * j * (int)sizeof(BiasT), BiasT());
      const float2 b1 =
          bias_pair(brow + 8 * St::BIAS_ROW_BYTES + 8 * j * (int)sizeof(BiasT), BiasT());
      s[j][0] += b0.x;
      s[j][1] += b0.y;
      s[j][2] += b1.x;
      s[j][3] += b1.y;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = fast_exp(m0 - mn0), alpha1 = fast_exp(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = fast_exp(s[j][0] - mn0);
      s[j][1] = fast_exp(s[j][1] - mn0);
      s[j][2] = fast_exp(s[j][2] - mn1);
      s[j][3] = fast_exp(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
      o[j][0] *= alpha0;
      o[j][1] *= alpha0;
      o[j][2] *= alpha1;
      o[j][3] *= alpha1;
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    uint32_t pf[4][4];
    pack_p_frags(pf, s);
    pv_tile(o, pf, st_u32 + KV_TILE_BYTES);
    wgmma_wait(o);  // before the next step's copies may overwrite this stage
  }

  store_o_tile(out + b * os.b + h * os.h + row0 * os.t, os.t, o,
               1.0f / fmaxf(quad_sum(l0), 1e-30f), 1.0f / fmaxf(quad_sum(l1), 1e-30f), lane);
}

template <typename BiasT>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out, int B,
           int H, int T, int S, const long long* st, cudaStream_t stream) {
  constexpr int smem = 2 * Stage<BiasT>::BYTES + TILE_ALIGN;
  static device_state::PerDevice configured;  // the attribute is set once a device, not a launch
  const cudaError_t e = allow_smem(flash_attn_kernel<BiasT>, smem, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]},
      bs{st[9], st[10], st[11]}, os{st[12], st[13], st[14]};
  dim3 grid(T / QT, B * H);
  flash_attn_kernel<BiasT><<<grid, THREADS, smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(v), reinterpret_cast<const BiasT*>(bias),
      reinterpret_cast<__nv_bfloat16*>(out), H, S, qs, ks, vs, bs, os);
  return static_cast<int>(cudaGetLastError());
}

// One tile, multiplied by one warpgroup: s = q k^T and o = bf16(s) v through the same
// fragment code the attention kernels use, for a check against a matrix product.
__global__ void __launch_bounds__(THREADS)
attn_tile_check_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, float* __restrict__ s_out,
                       float* __restrict__ o_out) {
  extern __shared__ unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const uint32_t t0 = smem_u32(align_tiles(smem_raw));
  TileLoader<THREADS> kload, vload;
  kload.init(k, D, tid);
  vload.init(v, D, tid);
  kload.copy(t0);
  vload.copy(t0 + KV_TILE_BYTES);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  uint32_t qf[4][4];
  load_q_frags(qf, q + warp * 16 * D, D, lane);
  float s[8][4], o[8][4];
  qk_tile(s, qf, t0);
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  wgmma_wait(s);
  uint32_t pf[4][4];
  pack_p_frags(pf, s);
  pv_tile(o, pf, t0 + KV_TILE_BYTES);
  wgmma_wait(o);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = (warp * 16 + g + 8 * (e >> 1)) * D + 8 * j + 2 * t + (e & 1);
      s_out[idx] = s[j][e];
      o_out[idx] = o[j][e];
    }
  }
}

}  // namespace

// q [B, H, T, 64], k and v [B, H, S, 64], out [B, H, T, 64], all bf16, and the
// additive bias [B | 1, H | 1, T, S] (f32, or bf16 when bias_bf16), each
// addressed through the host array `strides` of 15 element strides:
// (item, head, row) for q, k, v, bias and out, in that order; every last
// dimension is contiguous. Needs head_dim == 64, T % 64 == 0, S % 64 == 0,
// 16-byte aligned rows of k, v and the bias, 4-byte aligned rows of q and out.
extern "C" int vt_flash_attention(const void* q, const void* k, const void* v, const void* bias,
                                  void* out, int B, int H, int T, int S, int head_dim,
                                  int bias_bf16, const void* strides, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long* st = reinterpret_cast<const long long*>(strides);
  if (head_dim != D || T % QT || S % KT) return static_cast<int>(cudaErrorInvalidValue);
  return bias_bf16 ? launch<__nv_bfloat16>(q, k, v, bias, out, B, H, T, S, st, s)
                   : launch<float>(q, k, v, bias, out, B, H, T, S, st, s);
}

// q, k, v [64, 64] bf16, contiguous -> s = q k^T [64, 64] f32 and
// o = bf16(s) v [64, 64] f32: the fragment layouts and the shared-memory
// descriptors of attn_tiles.cuh on one tile.
extern "C" int vt_attn_tile_check(const void* q, const void* k, const void* v, void* s_out,
                                  void* o_out, void* stream) {
  attn_tile_check_kernel<<<1, THREADS, 2 * KV_TILE_BYTES + TILE_ALIGN,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(v), reinterpret_cast<float*>(s_out),
      reinterpret_cast<float*>(o_out));
  return static_cast<int>(cudaGetLastError());
}

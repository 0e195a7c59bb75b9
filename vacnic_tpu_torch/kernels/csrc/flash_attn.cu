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
// Design: one block of 4 warps per (item x head, 64-row query tile); each
//   warp owns 16 query rows. 64-key K and V tiles stream through shared
//   memory; Q K^T and P V run on the tensor cores through WMMA bf16
//   fragments. Each warp keeps its rows' running max and denominator in
//   registers and its f32 output rows in shared memory, where they are
//   rescaled by exp(m_old - m_new) before the tile's P V is accumulated into
//   them (WMMA accumulators are loaded from and stored back to that tile).
//   q, k, v, o and the bias are addressed through (item, head, row) strides
//   with a unit last stride: the head-split views of [B, T, d] projections
//   are read in place, a [B, 1, T, S] bias is read with a head stride of 0
//   (never expanded over heads), and o can be written straight into the
//   [B, T, H, D] layout that the head merge reads without a copy.

#include <float.h>
#include <math.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int D = 64;        // head dim
constexpr int QT = 64;       // query rows per block
constexpr int KT = 64;       // keys per shared-memory tile
constexpr int LDS = KT + 4;  // f32 row stride of a warp's score tile
constexpr int LDP = KT + 8;  // bf16 row stride of a warp's probability tile

struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

constexpr int LDH = D + 8;  // bf16 row stride of the Q, K and V tiles
constexpr int LDO = D + 4;  // f32 row stride of a warp's output rows
constexpr int SMEM_BYTES = (QT + 2 * KT) * LDH * 2 + 4 * 16 * LDS * 4 + 4 * 16 * LDP * 2 +
                           4 * 16 * LDO * 4;

template <typename BiasT>
__global__ void __launch_bounds__(128)
flash_attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const BiasT* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, int H, int S, Strides qs, Strides ks,
                  Strides vs, Strides bs, Strides os) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + QT * LDH;
  __nv_bfloat16* Vs = Ks + KT * LDH;
  float* Ss = reinterpret_cast<float*>(Vs + KT * LDH);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(Ss + 4 * 16 * LDS);
  float* Os = reinterpret_cast<float*>(Ps + 4 * 16 * LDP);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * QT;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  const BiasT* bb = bias + b * bs.b + h * bs.h;
  float* Sw = Ss + warp * 16 * LDS;
  __nv_bfloat16* Pw = Ps + warp * 16 * LDP;
  float* Ow = Os + warp * 16 * LDO;

  for (int c = tid; c < QT * (D / 8); c += 128) {
    const int r = c / (D / 8), cc = (c % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(Qs + r * LDH + cc) =
        *reinterpret_cast<const uint4*>(qb + (q0 + r) * qs.t + cc);
  }
  for (int e = lane; e < 16 * D; e += 32) Ow[(e / D) * LDO + e % D] = 0.0f;
  float m_r[16], l_r[16];  // this warp's rows; the same in every lane
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    m_r[i] = -FLT_MAX;
    l_r[i] = 0.0f;
  }

  for (int kt = 0; kt < S; kt += KT) {
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int c = tid; c < KT * (D / 8); c += 128) {
      const int r = c / (D / 8), cc = (c % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(Ks + r * LDH + cc) =
          *reinterpret_cast<const uint4*>(kb + (kt + r) * ks.t + cc);
      *reinterpret_cast<uint4*>(Vs + r * LDH + cc) =
          *reinterpret_cast<const uint4*>(vb + (kt + r) * vs.t + cc);
    }
    __syncthreads();

    // scores of this warp's 16 rows against the tile's 64 keys
#pragma unroll
    for (int n = 0; n < KT / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bk;
        wmma::load_matrix_sync(a, Qs + warp * 16 * LDH + kk * 16, LDH);
        wmma::load_matrix_sync(bk, Ks + n * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(acc, a, bk, acc);
      }
      wmma::store_matrix_sync(Sw + n * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax: lane holds keys lane and lane + 32 of each row
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const BiasT* brow = bb + (q0 + warp * 16 + i) * bs.t + kt;
      const float s0 = Sw[i * LDS + lane] + to_f32(brow[lane]);
      const float s1 = Sw[i * LDS + lane + 32] + to_f32(brow[lane + 32]);
      float tm = fmaxf(s0, s1);
      for (int o = 16; o > 0; o >>= 1) tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, o));
      const float mn = fmaxf(m_r[i], tm);
      const float p0 = expf(s0 - mn), p1 = expf(s1 - mn);
      float ts = p0 + p1;
      for (int o = 16; o > 0; o >>= 1) ts += __shfl_xor_sync(0xffffffffu, ts, o);
      const float alpha = expf(m_r[i] - mn);
      l_r[i] = l_r[i] * alpha + ts;
      m_r[i] = mn;
      Pw[i * LDP + lane] = __float2bfloat16(p0);
      Pw[i * LDP + lane + 32] = __float2bfloat16(p1);
      for (int c = lane; c < D; c += 32) Ow[i * LDO + c] *= alpha;
    }
    __syncwarp();

    // O += P V
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Ow + n * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Pw + kk * 16, LDP);
        wmma::load_matrix_sync(bv, Vs + kk * 16 * LDH + n * 16, LDH);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(Ow + n * 16, acc, LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  __nv_bfloat16* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float den = fmaxf(l_r[i], 1e-30f);
    const int t = q0 + warp * 16 + i;
    for (int c = lane; c < D; c += 32) ob[t * os.t + c] = __float2bfloat16(Ow[i * LDO + c] / den);
  }
}

template <typename BiasT>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out, int B,
           int H, int T, int S, const long long* st, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(flash_attn_kernel<BiasT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]},
      bs{st[9], st[10], st[11]}, os{st[12], st[13], st[14]};
  dim3 grid(T / QT, B * H);
  flash_attn_kernel<BiasT><<<grid, 128, SMEM_BYTES, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(v), reinterpret_cast<const BiasT*>(bias),
      reinterpret_cast<__nv_bfloat16*>(out), H, S, qs, ks, vs, bs, os);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H, T, 64], k and v [B, H, S, 64], out [B, H, T, 64], all bf16, and the
// additive bias [B | 1, H | 1, T, S] (f32, or bf16 when bias_bf16), each
// addressed through the host array `strides` of 15 element strides:
// (item, head, row) for q, k, v, bias and out, in that order; every last
// dimension is contiguous. Needs head_dim == 64, T % 64 == 0, S % 64 == 0.
extern "C" int vt_flash_attention(const void* q, const void* k, const void* v, const void* bias,
                                  void* out, int B, int H, int T, int S, int head_dim,
                                  int bias_bf16, const void* strides, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long* st = reinterpret_cast<const long long*>(strides);
  if (head_dim != D) return static_cast<int>(cudaErrorInvalidValue);
  return bias_bf16 ? launch<__nv_bfloat16>(q, k, v, bias, out, B, H, T, S, st, s)
                   : launch<float>(q, k, v, bias, out, B, H, T, S, st, s);
}

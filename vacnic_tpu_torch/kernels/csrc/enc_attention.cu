// Encoder attention of the fused multimodal text stack.
//
// Replaces: the attention blocks of vacnic_tpu/kernels/encoder_stack.py:
//   _kernel -- (1) text self-attention over S = 512 tokens with the per-item
//   additive pad bias [B, S], and (2) cross-attention from the text tokens
//   to the layer's precomputed img+ner K/V (KV = 40, 20 for only_image; no
//   bias: the img+ner mask is all ones in the supported configs).
// Semantics (both): q is rounded to bf16 after the head_dim**-0.5 scaling,
//   scores and softmax are f32, the probabilities are rounded to bf16 before
//   the value product, which accumulates in f32; the head output is bf16.
//
// Bound on the H100, B = 32, S = 512, H = 16, hd = 64, per layer:
//   self: 4*B*H*S*S*hd = 68.7 GFLOP against ~130 MB of q/k/v/o -- operations
//     bound (~70 us at 989 TFLOP/s);
//   cross: ~2.7 GFLOP against ~64 MB of q and o -- bytes bound (~20 us).
// Design, self: one block of 4 warps per (item, head, 64-query tile). The
//   whole 64 x S score tile stays in shared memory (132 KB at S = 512), so
//   the softmax is exact over a resident row: no online rescaling of the
//   output accumulator is needed at this sequence length. Q K^T and P V run
//   on the tensor cores through WMMA bf16 fragments; the bf16 probabilities
//   are written over their own f32 scores in place (each warp owns its 16
//   rows). The pad bias is read in f32, so the finfo(f32).min that the
//   callers build never overflows to -inf (the TPU kernel had to clamp it
//   before a bf16 cast).
// Design, cross: one thread per query row, the head's K [hd, KV] and
//   V [KV, hd] in shared memory as f32 and read by broadcast; KV <= 64.

#include <math.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int HD = 64;      // head dim the kernels are built for
constexpr int QT = 64;      // query rows per self-attention block
constexpr int KT = 64;      // key rows per shared-memory tile
constexpr int LDQ = HD + 8; // bf16 row stride of the Q and K/V tiles
constexpr int MAX_S = 512;
constexpr int MAX_KV = 64;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__global__ void __launch_bounds__(128)
enc_self_attn_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int S, int H, float scaling) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lds = S + 4;  // f32 row stride of the score tile
  float* Ss = reinterpret_cast<float*>(smem);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + (size_t)QT * lds * 4);
  __nv_bfloat16* KVs = Qs + QT * LDQ;
  float* Os = reinterpret_cast<float*>(KVs + KT * LDQ);

  const int d = H * HD, d3 = 3 * d;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t tok0 = (size_t)b * S;

  // Q tile, scaled and rounded to bf16
  for (int c = tid; c < QT * (HD / 8); c += 128) {
    const int r = c / (HD / 8), cc = (c % (HD / 8)) * 8;
    uint4 raw = *reinterpret_cast<const uint4*>(qkv + (tok0 + q0 + r) * d3 + h * HD + cc);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(__bfloat162float(e[i]) * scaling);
    *reinterpret_cast<uint4*>(Qs + r * LDQ + cc) = raw;
  }

  // scores = Q K^T, tile by tile into Ss
  for (int kt = 0; kt < S; kt += KT) {
    __syncthreads();
    for (int c = tid; c < KT * (HD / 8); c += 128) {
      const int r = c / (HD / 8), cc = (c % (HD / 8)) * 8;
      *reinterpret_cast<uint4*>(KVs + r * LDQ + cc) =
          *reinterpret_cast<const uint4*>(qkv + (tok0 + kt + r) * d3 + d + h * HD + cc);
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < KT / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bk;
        wmma::load_matrix_sync(a, Qs + warp * 16 * LDQ + kk * 16, LDQ);
        wmma::load_matrix_sync(bk, KVs + n * 16 * LDQ + kk * 16, LDQ);
        wmma::mma_sync(acc, a, bk, acc);
      }
      wmma::store_matrix_sync(Ss + (size_t)warp * 16 * lds + kt + n * 16, acc, lds,
                              wmma::mem_row_major);
    }
  }
  __syncwarp();

  // exact softmax of each of this warp's rows; bf16 probabilities in place
  const float* brow = bias + tok0;
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    float* srow = Ss + (size_t)r * lds;
    float vals[MAX_S / 32];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < MAX_S / 32; ++j) {
      const int c = lane + 32 * j;
      vals[j] = (c < S) ? srow[c] + brow[c] : -INFINITY;
      m = fmaxf(m, vals[j]);
    }
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.0f;
#pragma unroll
    for (int j = 0; j < MAX_S / 32; ++j) {
      vals[j] = (lane + 32 * j < S) ? expf(vals[j] - m) : 0.0f;
      l += vals[j];
    }
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    const float inv = 1.0f / l;
    __syncwarp();
    __nv_bfloat16* prow = reinterpret_cast<__nv_bfloat16*>(srow);
#pragma unroll
    for (int j = 0; j < MAX_S / 32; ++j) {
      const int c = lane + 32 * j;
      if (c < S) prow[c] = __float2bfloat16(vals[j] * inv);
    }
    __syncwarp();
  }

  // O = P V
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) wmma::fill_fragment(o[n], 0.0f);
  const __nv_bfloat16* pw = reinterpret_cast<const __nv_bfloat16*>(Ss + (size_t)warp * 16 * lds);
  for (int vt = 0; vt < S; vt += KT) {
    __syncthreads();
    for (int c = tid; c < KT * (HD / 8); c += 128) {
      const int r = c / (HD / 8), cc = (c % (HD / 8)) * 8;
      *reinterpret_cast<uint4*>(KVs + r * LDQ + cc) =
          *reinterpret_cast<const uint4*>(qkv + (tok0 + vt + r) * d3 + 2 * d + h * HD + cc);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, pw + vt + kk * 16, 2 * lds);
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
        wmma::load_matrix_sync(bv, KVs + kk * 16 * LDQ + n * 16, LDQ);
        wmma::mma_sync(o[n], a, bv, o[n]);
      }
    }
  }

  float* os = Os + warp * 256;
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
    wmma::store_matrix_sync(os, o[n], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16, c = e % 16;
      out[(tok0 + q0 + warp * 16 + r) * d + h * HD + n * 16 + c] = __float2bfloat16(os[e]);
    }
    __syncwarp();
  }
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
// Needs S % 64 == 0 and S <= 512.
extern "C" int vt_enc_self_attention(const void* qkv, const void* bias, void* out, int B, int S,
                                     int H, float scaling, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)QT * (S + 4) * 4 + 2 * (size_t)QT * LDQ * 2 + 4 * 256 * 4;
  cudaError_t e = cudaFuncSetAttribute(enc_self_attn_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(S / QT, H, B);
  enc_self_attn_kernel<<<grid, 128, smem, s>>>(
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

// Decoder attention of one beam-search step (one query row per beam row).
//
// Replaces: the attention phases of vacnic_tpu/kernels/decode_layer.py:
//   _kernel -- (a) self-attention over the time-major, write-once cache
//   [T, BK, D], whose step-t row for beam row c lives in physical row
//   anc[t, c]; (b) cross-attention over the beam-invariant K/V
//   [B, H, hd, S] with the additive pad bias [B, S], bf16 or int8 with
//   per-(item, head, channel) f32 scales.
// Semantics: q is rounded to bf16 after the head_dim**-0.5 scaling (int8:
//   then multiplied by the K scale and rounded again), scores and softmax
//   are f32, probabilities are rounded to bf16 before the value sum, which
//   is f32 (int8: times the V scale); the head output is bf16.
//
// Bound on the H100 at the main path (BK = 160, B = 32, H = 16, hd = 64,
// S = 512), per layer: self reads BK * (pos + 1) * D * 2 * 2 bytes of K/V
//   rows (~33 MB at pos = 49, ~10 us at 3.35 TB/s); cross reads the item's
//   K/V once for all its beams: 2 * B * H * hd * S bytes = 33.5 MB in int8
//   (~10 us), 67 MB in bf16. Both are bytes bound.
// Design, self: one warp per (beam row, head), two channels per lane. The
//   ancestry is followed in the load address -- row anc[t, c] of step t --
//   so no one-hot product and no cache reorder exist; only t <= pos is
//   visited, and the new token's K/V (row pos, not yet written to the
//   cache) are read from this step's QKV output. Scores sit in shared
//   memory, the softmax is exact over them.
// Design, cross: one block per (item, head) serves all beams of the item,
//   so each K/V element is read from device memory once per step and
//   dequantised in registers; threads stride over S so the loads coalesce.

#include <math.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;
constexpr int MAX_BEAMS = 8;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

// grid (BK, H / 4), block 128: warp w handles head blockIdx.y * 4 + w.
__global__ void __launch_bounds__(128)
dec_self_attn_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ ck,
                     const __nv_bfloat16* __restrict__ cv, const int32_t* __restrict__ anc,
                     __nv_bfloat16* __restrict__ out, int BK, int T, int H, int pos,
                     float scaling) {
  extern __shared__ float sc_all[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x, h = blockIdx.y * 4 + warp;
  const int D = H * HD;
  float* sc = sc_all + warp * T;
  const size_t rowq = (size_t)row * 3 * D + h * HD + 2 * lane;
  const __nv_bfloat162 qq = *reinterpret_cast<const __nv_bfloat162*>(qkv + rowq);
  const float q0 = bf16_round(__low2float(qq) * scaling);
  const float q1 = bf16_round(__high2float(qq) * scaling);
  const __nv_bfloat16* knew = qkv + rowq + D;
  const __nv_bfloat16* vnew = qkv + rowq + 2 * D;
  const size_t col = h * HD + 2 * lane;

#pragma unroll 4
  for (int t = 0; t <= pos; ++t) {
    const __nv_bfloat16* kp =
        (t < pos) ? ck + ((size_t)t * BK + anc[(size_t)t * BK + row]) * D + col : knew;
    const __nv_bfloat162 kk = *reinterpret_cast<const __nv_bfloat162*>(kp);
    const float s = warp_sum(q0 * __low2float(kk) + q1 * __high2float(kk));
    if (lane == 0) sc[t] = s;
  }
  __syncwarp();
  float m = -INFINITY;
  for (int t = lane; t <= pos; t += 32) m = fmaxf(m, sc[t]);
  m = warp_max(m);
  float l = 0.0f;
  for (int t = lane; t <= pos; t += 32) l += expf(sc[t] - m);
  l = warp_sum(l);
  const float inv = 1.0f / l;
  __syncwarp();
  for (int t = lane; t <= pos; t += 32) sc[t] = bf16_round(expf(sc[t] - m) * inv);
  __syncwarp();

  float o0 = 0.0f, o1 = 0.0f;
#pragma unroll 4
  for (int t = 0; t <= pos; ++t) {
    const __nv_bfloat16* vp =
        (t < pos) ? cv + ((size_t)t * BK + anc[(size_t)t * BK + row]) * D + col : vnew;
    const __nv_bfloat162 vv = *reinterpret_cast<const __nv_bfloat162*>(vp);
    const float p = sc[t];
    o0 += p * __low2float(vv);
    o1 += p * __high2float(vv);
  }
  *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * D + col) = __floats2bfloat162_rn(o0, o1);
}

// grid (H, B), block 256.
template <typename KT>
__global__ void __launch_bounds__(256)
dec_cross_attn_kernel(const __nv_bfloat16* __restrict__ q, const KT* __restrict__ ck,
                      const KT* __restrict__ cv, const float* __restrict__ ks,
                      const float* __restrict__ vs, const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int beams, int H, int S, float scaling) {
  extern __shared__ float sm[];
  float* qs = sm;                 // [beams][HD]
  float* ps = sm + beams * HD;    // [beams][S]
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D = H * HD;
  const size_t head = (size_t)b * H + h;

  for (int i = tid; i < beams * HD; i += blockDim.x) {
    const int bm = i / HD, j = i % HD;
    float v = bf16_round(__bfloat162float(q[((size_t)b * beams + bm) * D + h * HD + j]) * scaling);
    if (ks) v = bf16_round(v * ks[head * HD + j]);
    qs[i] = v;
  }
  __syncthreads();

  const KT* kb = ck + head * HD * S;
  const KT* vb = cv + head * HD * S;
  for (int s = tid; s < S; s += blockDim.x) {
    float acc[MAX_BEAMS];
#pragma unroll
    for (int bm = 0; bm < MAX_BEAMS; ++bm) acc[bm] = 0.0f;
    for (int j = 0; j < HD; ++j) {
      const float kv = to_f32(kb[(size_t)j * S + s]);
#pragma unroll
      for (int bm = 0; bm < MAX_BEAMS; ++bm)
        if (bm < beams) acc[bm] += qs[bm * HD + j] * kv;
    }
    const float bb = bias[(size_t)b * S + s];
#pragma unroll
    for (int bm = 0; bm < MAX_BEAMS; ++bm)
      if (bm < beams) ps[bm * S + s] = acc[bm] + bb;
  }
  __syncthreads();

  for (int bm = warp; bm < beams; bm += blockDim.x / 32) {
    float* pr = ps + bm * S;
    float m = -INFINITY;
    for (int s = lane; s < S; s += 32) m = fmaxf(m, pr[s]);
    m = warp_max(m);
    float l = 0.0f;
    for (int s = lane; s < S; s += 32) l += expf(pr[s] - m);
    l = warp_sum(l);
    const float inv = 1.0f / l;
    for (int s = lane; s < S; s += 32) pr[s] = bf16_round(expf(pr[s] - m) * inv);
  }
  __syncthreads();

  for (int j = warp; j < HD; j += blockDim.x / 32) {
    float acc[MAX_BEAMS];
#pragma unroll
    for (int bm = 0; bm < MAX_BEAMS; ++bm) acc[bm] = 0.0f;
    for (int s = lane; s < S; s += 32) {
      const float vv = to_f32(vb[(size_t)j * S + s]);
#pragma unroll
      for (int bm = 0; bm < MAX_BEAMS; ++bm)
        if (bm < beams) acc[bm] += ps[bm * S + s] * vv;
    }
    const float scale = vs ? vs[head * HD + j] : 1.0f;
#pragma unroll
    for (int bm = 0; bm < MAX_BEAMS; ++bm) {
      if (bm < beams) {
        const float o = warp_sum(acc[bm]);
        if (lane == 0)
          out[((size_t)b * beams + bm) * D + h * HD + j] = __float2bfloat16(o * scale);
      }
    }
  }
}

}  // namespace

// qkv [BK, 3*H*64] bf16, cache_k/cache_v [T, BK, H*64] bf16 (one layer),
// anc [T, BK] int32, out [BK, H*64] bf16; rows t < pos come from the cache
// through anc, row pos from qkv. Needs H % 4 == 0.
extern "C" int vt_dec_self_attention(const void* qkv, const void* cache_k, const void* cache_v,
                                     const void* anc, void* out, int BK, int T, int H, int pos,
                                     float scaling, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = 4 * (size_t)T * sizeof(float);
  dim3 grid(BK, H / 4);
  dec_self_attn_kernel<<<grid, 128, smem, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(qkv), reinterpret_cast<const __nv_bfloat16*>(cache_k),
      reinterpret_cast<const __nv_bfloat16*>(cache_v), reinterpret_cast<const int32_t*>(anc),
      reinterpret_cast<__nv_bfloat16*>(out), BK, T, H, pos, scaling);
  return static_cast<int>(cudaGetLastError());
}

// q [B*beams, H*64] bf16, ck/cv [B, H, 64, S] int8 (is_int8) or bf16,
// ks/vs [B, H, 64] f32 (int8 only, else NULL), bias [B, S] f32,
// out [B*beams, H*64] bf16. Needs beams <= 8.
extern "C" int vt_dec_cross_attention(const void* q, const void* ck, const void* cv,
                                      const void* ks, const void* vs, const void* bias, void* out,
                                      int B, int beams, int H, int S, int is_int8, float scaling,
                                      void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)beams * (HD + S) * sizeof(float);
  dim3 grid(H, B);
  const auto* qq = reinterpret_cast<const __nv_bfloat16*>(q);
  const auto* kss = reinterpret_cast<const float*>(ks);
  const auto* vss = reinterpret_cast<const float*>(vs);
  const auto* bb = reinterpret_cast<const float*>(bias);
  auto* oo = reinterpret_cast<__nv_bfloat16*>(out);
  if (is_int8) {
    dec_cross_attn_kernel<int8_t><<<grid, 256, smem, st>>>(
        qq, reinterpret_cast<const int8_t*>(ck), reinterpret_cast<const int8_t*>(cv), kss, vss,
        bb, oo, beams, H, S, scaling);
  } else {
    dec_cross_attn_kernel<__nv_bfloat16><<<grid, 256, smem, st>>>(
        qq, reinterpret_cast<const __nv_bfloat16*>(ck), reinterpret_cast<const __nv_bfloat16*>(cv),
        nullptr, nullptr, bb, oo, beams, H, S, scaling);
  }
  return static_cast<int>(cudaGetLastError());
}

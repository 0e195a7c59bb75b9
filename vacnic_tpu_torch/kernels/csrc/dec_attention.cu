// Decoder self-attention of one beam-search step (one query row per beam row).
//
// Replaces: the self-attention phase of vacnic_tpu/kernels/decode_layer.py:
//   _kernel (_self_attn) -- attention over the time-major, write-once cache
//   [T, BK, D], whose step-t row for beam row c lives in physical row
//   anc[t, c]. (Its cross-attention phase is dec_cross_attention.cu.)
// Semantics: q is rounded to bf16 after the head_dim**-0.5 scaling, scores
//   and softmax are f32, probabilities are rounded to bf16 before the value
//   sum, which is f32; the head output is bf16.
//
// Bound on the H100 at the main path (BK = 160, H = 16, hd = 64), per
// layer: it reads BK * (pos + 1) * D * 2 * 2 bytes of K/V rows (~33 MB at
// pos = 49, ~10 us at 3.35 TB/s): bytes bound.
// Design, self: one warp per (beam row, head), two channels per lane. The
//   ancestry is followed in the load address -- row anc[t, c] of step t --
//   so no one-hot product and no cache reorder exist; only t <= pos is
//   visited, and the new token's K/V (row pos, not yet written to the
//   cache) are read from this step's QKV output. Scores sit in shared
//   memory, the softmax is exact over them.

#include <math.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;

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

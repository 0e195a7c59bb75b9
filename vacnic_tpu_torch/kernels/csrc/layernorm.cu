// Row LayerNorm over d (f32 statistics), writing an f32 and/or a bf16 copy.
//
// Replaces: the `ln(...)` blocks inside vacnic_tpu/kernels/encoder_stack.py:
//   _kernel (self_attn / img_ner_attn / final layer norms) and
//   vacnic_tpu/kernels/decode_layer.py:_kernel (self / cross / final layer
//   norms). The residual add that precedes each of them happens in the
//   epilogue of the GEMM that produces the input (gemm_bf16.cu), so this
//   kernel reads the already-summed row.
// Bound on the H100: bytes. At the encoder shape (16384 x 1024) it reads
//   64 MB of f32 and writes 64 MB f32 + 32 MB bf16 (~48 us at 3.35 TB/s);
//   at decode (160 x 1024) it is launch-latency bound.
// Design: one block per row; the row is read three times (mean, variance,
//   normalise) and the repeated reads hit L1/L2; the bf16 copy feeds the
//   next GEMM's A operand so no separate cast kernel runs. In place
//   (y32 == x) is allowed: each thread writes only what it just read.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nw = blockDim.x / 32;
  float t = (threadIdx.x < nw) ? red[threadIdx.x] : 0.0f;
  if (warp == 0)
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  if (threadIdx.x == 0) red[32] = t;
  __syncthreads();
  const float r = red[32];
  __syncthreads();
  return r;
}

__global__ void layernorm_kernel(const float* __restrict__ x, const float* __restrict__ gb,
                                 float* y32, __nv_bfloat16* __restrict__ y16, int d, float eps) {
  __shared__ float red[33];
  const size_t row = blockIdx.x;
  const float* xr = x + row * d;
  float s = 0.0f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) s += xr[i];
  const float mean = block_sum(s, red) / d;
  float v = 0.0f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float t = xr[i] - mean;
    v += t * t;
  }
  const float rstd = rsqrtf(block_sum(v, red) / d + eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float y = (xr[i] - mean) * rstd * gb[i] + gb[d + i];
    if (y32) y32[row * d + i] = y;
    if (y16) y16[row * d + i] = __float2bfloat16(y);
  }
}

}  // namespace

// x [rows, d] f32; gb [2, d] f32 (scale row, bias row); y32 [rows, d] f32 or
// NULL; y16 [rows, d] bf16 or NULL.
extern "C" int vt_layernorm(const void* x, const void* gb, void* y32, void* y16, int rows, int d,
                            float eps, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  layernorm_kernel<<<rows, 256, 0, s>>>(reinterpret_cast<const float*>(x),
                                        reinterpret_cast<const float*>(gb),
                                        reinterpret_cast<float*>(y32),
                                        reinterpret_cast<__nv_bfloat16*>(y16), d, eps);
  return static_cast<int>(cudaGetLastError());
}

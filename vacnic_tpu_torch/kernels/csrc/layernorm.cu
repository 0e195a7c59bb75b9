// Row LayerNorm over d (f32 statistics), writing an f32 and a bf16 copy.
//
// Replaces: the `ln(...)` blocks inside vacnic_tpu/kernels/encoder_stack.py:
//   _kernel (self_attn / img_ner_attn / final layer norms) and
//   vacnic_tpu/kernels/decode_layer.py:_kernel (self / cross / final layer
//   norms). The residual add that precedes each of them happens in the
//   epilogue of the GEMM that produces the input (gemm_bf16.cu), so this
//   kernel reads the already-summed row.
// Semantics (the plain twin's, kernels/primitives.layernorm_plain): the f32
//   mean, the variance as the mean of (x - mean)^2, then
//   (x - mean) * rsqrt(var + eps) * scale + bias, stored as f32 and rounded
//   to bf16.
// Bound on the H100: bytes. At the encoder shape (16384 x 1024) it reads
//   64 MB of f32 and writes 64 MB f32 + 32 MB bf16 (~50 us at 3.35 TB/s);
//   at decode (160 x 1024) one dependent load -> reduce -> store chain.
// Design, d <= 1024 (layernorm_warp_kernel): a warp owns a row and holds it
//   in registers -- lane l keeps float4 number l + 32 i, i < NV -- so every
//   element is read from device memory once, in 16-byte loads; mean and
//   centred variance are warp shuffles, with no block barrier; f32 leaves as
//   float4, bf16 as 8-byte stores. The scale and bias rows are read into
//   registers once per warp, and the warps of a grid of one resident wave
//   stride over the rows. A row whose length is not a multiple of 4 (or a
//   pointer off 16 bytes) takes the instance with scalar loads: lane l keeps
//   elements l + 32 i. Slots past d are masked out of both sums.
// Design, d > 1024 (layernorm_block_kernel): a block of 256 threads a row,
//   three passes over it (the second and third hit L1/L2), float4 where
//   aligned. Which instance runs is kernels/primitives.layernorm_plan's.
// In place (y32 == x) is allowed: a warp (a block) reads all of its row
//   before it writes any of it, and only it touches the row.

#include <stdint.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "device_state.cuh"

namespace {

constexpr int WARP_THREADS = 128;   // four warps a block, each on its own rows
constexpr int BLOCK_THREADS = 256;  // the wide instance: one block a row
constexpr int MAX_NV = 8;           // float4 slots a lane: d <= 32 * 4 * 8 = 1024

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sum4(float4 v) { return ((v.x + v.y) + v.z) + v.w; }

__device__ __forceinline__ float sq4(float4 v, float mean) {
  const float a = v.x - mean, b = v.y - mean, c = v.z - mean, d = v.w - mean;
  return ((a * a + b * b) + c * c) + d * d;
}

__device__ __forceinline__ float norm1(float v, float mean, float rstd, float g, float b) {
  return (v - mean) * rstd * g + b;
}

__device__ __forceinline__ void store_row4(float4 y, float* y32, __nv_bfloat16* y16, size_t at) {
  *reinterpret_cast<float4*>(y32 + at) = y;
  const __nv_bfloat162 lo = __floats2bfloat162_rn(y.x, y.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(y.z, y.w);
  uint2 packed;
  packed.x = *reinterpret_cast<const uint32_t*>(&lo);
  packed.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(y16 + at) = packed;
}

// One warp a row, NV float4 slots a lane (VEC) or 4 NV scalar slots (!VEC).
template <int NV, bool VEC>
__global__ void __launch_bounds__(WARP_THREADS)
layernorm_warp_kernel(const float* x, const float* __restrict__ gb, float* y32,
                      __nv_bfloat16* __restrict__ y16, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (WARP_THREADS / 32);
  const float fd = static_cast<float>(d);
  if (VEC) {
    const int d4 = d >> 2;
    float4 g[NV], b[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      g[i] = c < d4 ? __ldg(reinterpret_cast<const float4*>(gb) + c) : z;
      b[i] = c < d4 ? __ldg(reinterpret_cast<const float4*>(gb + d) + c) : z;
    }
    for (int row = blockIdx.x * (WARP_THREADS / 32) + (threadIdx.x >> 5); row < rows;
         row += warps) {
      const float4* xr = reinterpret_cast<const float4*>(x + static_cast<size_t>(row) * d);
      float4 v[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = lane + 32 * i;
        v[i] = c < d4 ? __ldcs(xr + c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < NV; ++i) s += sum4(v[i]);  // masked slots hold 0
      const float mean = warp_sum(s) / fd;
      float q = 0.0f;
#pragma unroll
      for (int i = 0; i < NV; ++i)
        if (lane + 32 * i < d4) q += sq4(v[i], mean);
      const float rstd = rsqrtf(warp_sum(q) / fd + eps);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = lane + 32 * i;
        if (c < d4) {
          const float4 y = make_float4(norm1(v[i].x, mean, rstd, g[i].x, b[i].x),
                                       norm1(v[i].y, mean, rstd, g[i].y, b[i].y),
                                       norm1(v[i].z, mean, rstd, g[i].z, b[i].z),
                                       norm1(v[i].w, mean, rstd, g[i].w, b[i].w));
          store_row4(y, y32, y16, static_cast<size_t>(row) * d + 4 * c);
        }
      }
    }
  } else {
    constexpr int NS = 4 * NV;
    float g[NS], b[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int c = lane + 32 * i;
      g[i] = c < d ? __ldg(gb + c) : 0.0f;
      b[i] = c < d ? __ldg(gb + d + c) : 0.0f;
    }
    for (int row = blockIdx.x * (WARP_THREADS / 32) + (threadIdx.x >> 5); row < rows;
         row += warps) {
      const float* xr = x + static_cast<size_t>(row) * d;
      float v[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = lane + 32 * i;
        v[i] = c < d ? __ldcs(xr + c) : 0.0f;
      }
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < NS; ++i) s += v[i];
      const float mean = warp_sum(s) / fd;
      float q = 0.0f;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float t = v[i] - mean;
        if (lane + 32 * i < d) q += t * t;
      }
      const float rstd = rsqrtf(warp_sum(q) / fd + eps);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = lane + 32 * i;
        if (c < d) {
          const float y = norm1(v[i], mean, rstd, g[i], b[i]);
          const size_t at = static_cast<size_t>(row) * d + c;
          y32[at] = y;
          y16[at] = __float2bfloat16(y);
        }
      }
    }
  }
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < BLOCK_THREADS / 32; ++w) t += red[w];  // every thread, the same order
  __syncthreads();  // red is free for the next sum
  return t;
}

// One block a row, any d: three passes over the row.
template <bool VEC>
__global__ void __launch_bounds__(BLOCK_THREADS)
layernorm_block_kernel(const float* x, const float* __restrict__ gb, float* y32,
                       __nv_bfloat16* __restrict__ y16, int d, float eps) {
  __shared__ float red[BLOCK_THREADS / 32];
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  const float* xr = x + base;
  const float fd = static_cast<float>(d);
  const int n = VEC ? d >> 2 : d;
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += BLOCK_THREADS)
    s += VEC ? sum4(reinterpret_cast<const float4*>(xr)[i]) : xr[i];
  const float mean = block_sum(s, red) / fd;
  float q = 0.0f;
  for (int i = threadIdx.x; i < n; i += BLOCK_THREADS) {
    if (VEC) {
      q += sq4(reinterpret_cast<const float4*>(xr)[i], mean);
    } else {
      const float t = xr[i] - mean;
      q += t * t;
    }
  }
  const float rstd = rsqrtf(block_sum(q, red) / fd + eps);
  // in place: a thread writes only the elements it has just read again
  for (int i = threadIdx.x; i < n; i += BLOCK_THREADS) {
    if (VEC) {
      const float4 v = reinterpret_cast<const float4*>(xr)[i];
      const float4 g = __ldg(reinterpret_cast<const float4*>(gb) + i);
      const float4 b = __ldg(reinterpret_cast<const float4*>(gb + d) + i);
      store_row4(make_float4(norm1(v.x, mean, rstd, g.x, b.x), norm1(v.y, mean, rstd, g.y, b.y),
                             norm1(v.z, mean, rstd, g.z, b.z), norm1(v.w, mean, rstd, g.w, b.w)),
                 y32, y16, base + 4 * static_cast<size_t>(i));
    } else {
      const float y = norm1(xr[i], mean, rstd, __ldg(gb + i), __ldg(gb + d + i));
      y32[base + i] = y;
      y16[base + i] = __float2bfloat16(y);
    }
  }
}

// Blocks of `kernel` that fit on the current device at once; `blocks` is
// the caller's cache (one per kernel instance), asked once a device.
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, device_state::PerDevice& blocks) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int n = blocks.get(dev);
  if (n == 0) {
    int per_sm = 0;
    const int sms = device_state::sm_count();
    if (sms <= 0 ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0) != cudaSuccess)
      return 0;
    n = sms * per_sm;
    blocks.set(dev, n);
  }
  return n;
}

template <int NV, bool VEC>
int launch_warp(const float* x, const float* gb, float* y32, __nv_bfloat16* y16, int rows, int d,
                float eps, cudaStream_t s) {
  static device_state::PerDevice blocks;  // resident blocks a wave, once a device
  auto kernel = layernorm_warp_kernel<NV, VEC>;
  const int wave = resident_blocks(kernel, WARP_THREADS, blocks);
  if (wave <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int need = (rows + WARP_THREADS / 32 - 1) / (WARP_THREADS / 32);
  kernel<<<need < wave ? need : wave, WARP_THREADS, 0, s>>>(x, gb, y32, y16, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int launch_warp_nv(int nv, const float* x, const float* gb, float* y32, __nv_bfloat16* y16,
                   int rows, int d, float eps, cudaStream_t s) {
  switch (nv) {
    case 1: return launch_warp<1, VEC>(x, gb, y32, y16, rows, d, eps, s);
    case 2: return launch_warp<2, VEC>(x, gb, y32, y16, rows, d, eps, s);
    case 3: return launch_warp<3, VEC>(x, gb, y32, y16, rows, d, eps, s);
    case 4: return launch_warp<4, VEC>(x, gb, y32, y16, rows, d, eps, s);
    case 5: return launch_warp<5, VEC>(x, gb, y32, y16, rows, d, eps, s);
    case 6: return launch_warp<6, VEC>(x, gb, y32, y16, rows, d, eps, s);
    case 7: return launch_warp<7, VEC>(x, gb, y32, y16, rows, d, eps, s);
    case 8: return launch_warp<8, VEC>(x, gb, y32, y16, rows, d, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x [rows, d] f32; gb [2, d] f32 (scale row, bias row); y32 [rows, d] f32;
// y16 [rows, d] bf16. The plan comes from kernels/primitives.layernorm_plan:
//   variant 1 (d <= 1024): layernorm_warp_kernel with `slots` = ceil(d / 128)
//     float4 (or 4 scalar) slots a lane;
//   variant 2: layernorm_block_kernel, slots = 0.
// Both take 16-byte loads and stores where d % 4 == 0 and x, gb, y32 and y16
// start on 16 bytes, else scalar ones. Any other plan is refused with
// cudaErrorInvalidValue.
extern "C" int vt_layernorm(const void* x, const void* gb, void* y32, void* y16, int rows, int d,
                            float eps, int variant, int slots, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* xx = reinterpret_cast<const float*>(x);
  const auto* gg = reinterpret_cast<const float*>(gb);
  auto* o32 = reinterpret_cast<float*>(y32);
  auto* o16 = reinterpret_cast<__nv_bfloat16*>(y16);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (rows < 1 || d < 1) return invalid;
  const bool vec = d % 4 == 0 && aligned16(x) && aligned16(gb) && aligned16(y32) && aligned16(y16);
  if (variant == 1) {
    if (slots < 1 || slots > MAX_NV || 128 * slots < d || 128 * (slots - 1) >= d) return invalid;
    return vec ? launch_warp_nv<true>(slots, xx, gg, o32, o16, rows, d, eps, s)
               : launch_warp_nv<false>(slots, xx, gg, o32, o16, rows, d, eps, s);
  }
  if (variant == 2) {
    if (slots != 0) return invalid;
    if (vec)
      layernorm_block_kernel<true><<<rows, BLOCK_THREADS, 0, s>>>(xx, gg, o32, o16, d, eps);
    else
      layernorm_block_kernel<false><<<rows, BLOCK_THREADS, 0, s>>>(xx, gg, o32, o16, d, eps);
    return static_cast<int>(cudaGetLastError());
  }
  return invalid;
}

// LM head with per-block statistics: logits, block max and exp-sum partials.
//
// Replaces: vacnic_tpu/kernels/lm_stats.py:lm_stats (_kernel :44,
//   pallas_call :104).
// Computes, for x [BK, d] bf16, w [Vp, d] bf16 (the tied embedding padded
//   to Vp rows, pad rows zero) and b [Vp] f32 (pad columns -1e9):
//   y = x @ w^T + b in f32 (bf16 products, f32 accumulation), stored as
//   logits [BK, Vp]; for each 1024-wide vocab block j,
//   m[r, j] = max(y[r, block j]) and s[r, j] = sum(exp(y[r, block j] - m[r, j])).
//
// Bound on the H100 at the stats path's shape (BK 160, d 1024, Vp 53248):
//   109 MB of weights + 34 MB of logits = 143 MB, ~43 us at 3.35 TB/s
//   (bytes); the 17.4 GFLOP take ~18 us at 989 TFLOP/s.
// Design: one block of 8 warps per (32-row tile, 1024-column vocab block).
//   Row tiles are the fastest grid index, so the row tiles of one vocab
//   block run side by side and its 2 MB of weights come from HBM about once
//   and from L2 for the other tiles (the Hopper form of the TPU kernel's
//   vocab-major grid). The block walks its vocab block in four 256-column
//   sub-tiles. Per sub-tile it streams x and w in 32-deep chunks through a
//   two-stage cp.async ring, multiplies with WMMA bf16 fragments into f32,
//   stages the f32 tile in shared memory (over the ring, which is free by
//   then), adds the bias, stores the logits, and folds the sub-tile's row
//   max and exp-sum into a running (m, s) pair per row (online combine).
//   m is the max of the very values stored, so stage 2's block-pigeonhole
//   top-C is exact on the stored logits. An all-pad block gives m = -1e9 and
//   s = 1024, never NaN: the running max starts at -FLT_MAX, not -inf.

#include <float.h>
#include <math.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int VBLOCK = 1024;  // vocab block of the statistics
constexpr int RT = 32;        // rows per block
constexpr int CT = 256;       // columns per sub-tile
constexpr int KC = 32;        // depth of one pipeline stage
constexpr int LDK = KC + 8;   // bf16 row stride of the staged x and w chunks
constexpr int LDC = CT + 4;   // f32 row stride of the staged output tile
constexpr int NT = 256;       // 8 warps: 2 groups of 16 rows x 4 groups of 64 columns

constexpr int STAGE_ELEMS = (RT + CT) * LDK;         // bf16 elements per ring stage
constexpr int RING_BYTES = 2 * STAGE_ELEMS * 2;      // 46,080
constexpr int CTILE_BYTES = RT * LDC * 4;            // 33,280
constexpr int SMEM_BYTES = RING_BYTES > CTILE_BYTES ? RING_BYTES : CTILE_BYTES;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int sz = pred ? 16 : 0;  // src-size 0 zero-fills rows past BK
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(sz));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(NT)
lm_stats_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ logits,
                float* __restrict__ m_out, float* __restrict__ s_out, int BK, int Vp, int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp / 4, wc = warp % 4;
  const int r0 = blockIdx.x * RT, vb = blockIdx.y;
  const int nvb = Vp / VBLOCK;
  const int nk = d / KC;

  float m_run[4], s_run[4];  // rows 4*warp .. 4*warp+3 of the tile
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -FLT_MAX;
    s_run[i] = 0.0f;
  }

  for (int sub = 0; sub < VBLOCK / CT; ++sub) {
    const int c0 = vb * VBLOCK + sub * CT;
    auto load = [&](int stage, int k0) {
      __nv_bfloat16* xs = ring + stage * STAGE_ELEMS;
      __nv_bfloat16* ws = xs + RT * LDK;
      for (int c = tid; c < RT * (KC / 8); c += NT) {
        const int r = c / (KC / 8), cc = (c % (KC / 8)) * 8;
        const bool ok = r0 + r < BK;
        cp_async16(xs + r * LDK + cc, x + (size_t)(ok ? r0 + r : 0) * d + k0 + cc, ok);
      }
      for (int c = tid; c < CT * (KC / 8); c += NT) {
        const int r = c / (KC / 8), cc = (c % (KC / 8)) * 8;
        cp_async16(ws + r * LDK + cc, w + (size_t)(c0 + r) * d + k0 + cc, true);
      }
    };

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);

    load(0, 0);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt & 1;
      if (kt + 1 < nk) load(st ^ 1, (kt + 1) * KC);
      cp_async_commit();
      cp_async_wait1();
      __syncthreads();
      const __nv_bfloat16* xs = ring + st * STAGE_ELEMS;
      const __nv_bfloat16* ws = xs + RT * LDK;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, xs + wr * 16 * LDK + kk, LDK);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // w is [vocab, d] row-major: as the [d, vocab] operand it is column-major
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
          wmma::load_matrix_sync(b, ws + (wc * 64 + j * 16) * LDK + kk, LDK);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + wr * 16 * LDC + wc * 64 + j * 16, acc[j], LDC,
                              wmma::mem_row_major);
    __syncthreads();

    // bias, logits, and the running statistics of this warp's four rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 4 + i;
      const bool live = r0 + r < BK;
      float v[CT / 32];
      float tm = -FLT_MAX;
#pragma unroll
      for (int j = 0; j < CT / 32; ++j) {
        const int c = lane + 32 * j;
        v[j] = Cs[r * LDC + c] + bias[c0 + c];
        tm = fmaxf(tm, v[j]);
        if (live) logits[(size_t)(r0 + r) * Vp + c0 + c] = v[j];
      }
      tm = warp_max(tm);
      float ts = 0.0f;
#pragma unroll
      for (int j = 0; j < CT / 32; ++j) ts += expf(v[j] - tm);
      ts = warp_sum(ts);
      const float mn = fmaxf(m_run[i], tm);
      s_run[i] = s_run[i] * expf(m_run[i] - mn) + ts * expf(tm - mn);
      m_run[i] = mn;
    }
    __syncthreads();  // Cs is the next sub-tile's ring
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + warp * 4 + i;
      if (row < BK) {
        m_out[(size_t)row * nvb + vb] = m_run[i];
        s_out[(size_t)row * nvb + vb] = s_run[i];
      }
    }
  }
}

}  // namespace

// x [BK, d] bf16, w [Vp, d] bf16, bias [Vp] f32 -> logits [BK, Vp] f32,
// m and s [BK, Vp / 1024] f32. Needs d % 32 == 0 and Vp % 1024 == 0.
extern "C" int vt_lm_stats(const void* x, const void* w, const void* bias, void* logits, void* m,
                           void* s, int BK, int Vp, int d, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid((BK + RT - 1) / RT, Vp / VBLOCK);
  lm_stats_kernel<<<grid, NT, SMEM_BYTES, st>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), reinterpret_cast<const __nv_bfloat16*>(w),
      reinterpret_cast<const float*>(bias), reinterpret_cast<float*>(logits),
      reinterpret_cast<float*>(m), reinterpret_cast<float*>(s), BK, Vp, d);
  return static_cast<int>(cudaGetLastError());
}

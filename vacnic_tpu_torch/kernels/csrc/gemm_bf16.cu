// Tiled bf16 x bf16 -> f32-accumulate matrix product with a fused epilogue.
//
// Replaces: the matrix products inside the two TPU kernels' bodies --
//   vacnic_tpu/kernels/encoder_stack.py:_kernel (fused QKV, self out-proj,
//   cross q, cross out-proj, fc1, fc2) and
//   vacnic_tpu/kernels/decode_layer.py:_kernel (the same six per layer).
// Computes C[M,N] = epilogue(A[M,K] @ W[K,N]) with A and W bf16 row-major
// (W in the JAX [in, out] layout), epilogue = + bias[N] (f32), optional
// exact erf gelu, optional + residual[M,N] (f32), stored as f32 or bf16.
//
// Bound on the H100 at the main-path shapes:
//   encoder, M = 32*512 = 16384: 2*M*N*K operations against a few tens of MB
//     -- operations bound (fc1: 137 GFLOP, ~0.14 ms at 989 TFLOP/s);
//   decode, M = 5*32 = 160: the weight matrix dominates the bytes (fc1 reads
//     8 MB for 1.3 GFLOP) -- bytes bound (~2.5 us at 3.35 TB/s).
// Design: mma.sync through WMMA 16x16x16 bf16 fragments, a two-stage
// cp.async ring of A and W tiles in shared memory, one warp-private 16x16
// staging tile for the epilogue so bias/gelu/residual are applied on the
// way out and the f32 product never round-trips through device memory.
// Large M takes 128x128 block tiles (8 warps), small M 64x64 tiles (4 warps)
// so that decode still spreads over several SMs. wgmma/TMA and split-K for
// the bytes-bound decode shapes are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int BK = 32;
constexpr int SKEW = 8;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int sz = pred ? 16 : 0;  // src-size 0 zero-fills rows past M
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(sz));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
gemm_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
            const float* __restrict__ bias, const float* __restrict__ res, void* __restrict__ C,
            int M, int N, int K, int act, int out_bf16) {
  constexpr int WARPS_N = BN / WN;
  constexpr int NWARPS = (BM / WM) * WARPS_N;
  constexpr int NT = NWARPS * 32;
  constexpr int FM = WM / 16, FN = WN / 16;
  __shared__ __align__(128) __nv_bfloat16 As[2][BM][BK + SKEW];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][BK][BN + SKEW];
  __shared__ __align__(128) float Cs[NWARPS][16][16];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_tile = [&](int stage, int k0) {
    constexpr int A_CHUNKS = BM * BK / 8;
    for (int c = tid; c < A_CHUNKS; c += NT) {
      int r = c / (BK / 8), cc = (c % (BK / 8)) * 8;
      int gm = m0 + r;
      bool ok = gm < M;
      cp_async16(&As[stage][r][cc], A + (size_t)(ok ? gm : 0) * K + k0 + cc, ok);
    }
    constexpr int B_CHUNKS = BK * BN / 8;
    for (int c = tid; c < B_CHUNKS; c += NT) {
      int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
      cp_async16(&Bs[stage][r][cc], W + (size_t)(k0 + r) * N + n0 + cc, true);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = K / BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) load_tile(st ^ 1, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], &As[st][wm * WM + i * 16][kk], BK + SKEW);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], &Bs[st][kk][wn * WN + j * 16], BN + SKEW);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(&Cs[warp][0][0], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int rbase = m0 + wm * WM + i * 16, cbase = n0 + wn * WN + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, c = e % 16;
        const int gm = rbase + r, gn = cbase + c;
        if (gm < M) {
          float v = Cs[warp][r][c];
          if (bias) v += bias[gn];
          if (act == 1) v = gelu_erf(v);
          const size_t o = (size_t)gm * N + gn;
          if (res) v += res[o];
          if (out_bf16)
            reinterpret_cast<__nv_bfloat16*>(C)[o] = __float2bfloat16(v);
          else
            reinterpret_cast<float*>(C)[o] = v;
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

// A [M,K] bf16, W [K,N] bf16, bias [N] f32 or NULL, res [M,N] f32 or NULL,
// C [M,N] f32 (out_bf16 = 0) or bf16 (out_bf16 = 1); act 0 = none, 1 = gelu.
// Needs K % 32 == 0 and N % 64 == 0 (N % 128 == 0 for the large tile).
extern "C" int vt_gemm_bf16(const void* A, const void* W, const void* bias, const void* res,
                            void* C, int M, int N, int K, int act, int out_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* a = reinterpret_cast<const __nv_bfloat16*>(A);
  const auto* w = reinterpret_cast<const __nv_bfloat16*>(W);
  const auto* b = reinterpret_cast<const float*>(bias);
  const auto* r = reinterpret_cast<const float*>(res);
  if (M >= 2048 && N % 128 == 0) {
    dim3 grid(N / 128, (M + 127) / 128);
    gemm_kernel<128, 128, 64, 32><<<grid, 256, 0, s>>>(a, w, b, r, C, M, N, K, act, out_bf16);
  } else {
    dim3 grid(N / 64, (M + 63) / 64);
    gemm_kernel<64, 64, 32, 32><<<grid, 128, 0, s>>>(a, w, b, r, C, M, N, K, act, out_bf16);
  }
  return static_cast<int>(cudaGetLastError());
}

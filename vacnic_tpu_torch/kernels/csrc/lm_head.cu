// The decoder's LM head over the padded vocabulary: logits = x w^T + b.
//
// Replaces: vacnic_tpu/kernels/decode_layer.py:_kernel `_lm_head` (:643-650),
//   the extra grid iteration of decode_stack (:653, pallas_call :952) that
//   runs when ChunkPlan.n_lm > 0, over the vocab chunks lm_j (:832) of the
//   BlockSpecs at :900-901.
// Computes, for x [BK, d] bf16 (the stack's last layer norm, rounded),
//   w [Vp, d] bf16 (the tied embedding padded to Vp rows, pad rows zero) and
//   b [Vp] f32 (pad entries -1e9): logits [BK, Vp] f32 = x w^T + b, bf16
//   products summed in f32.
//
// Bound on the H100 at the decode path's shape (BK 160, d 1024, Vp 53248):
//   the kernel must read 109 MB of weights and write 34 MB of logits,
//   143 MB: 0.043 ms at 3.35 TB/s. Its 17.4 GFLOP take 18 us at 989 TFLOP/s
//   (122 operations a byte, under the card's ~295): bytes bound. The weight
//   stream is what has to run at the memory's rate; x (320 KB) stays in L2.
//
// Design. The operands are swapped: vocab rows are the 64-row M side of
// wgmma, and x is the N side, so a weight tile comes in by TMA in its own
// K-major layout and x rides along as the K-major B operand (N = BK rounded
// up to 64, at most 256 a pass; a larger BK is taken in passes of 256).
// A persistent grid of one block an SM splits the vocabulary into
// contiguous runs of 64-row units, as even as whole units allow (832 units
// at Vp 53248 over 132 SMs: six or seven each), so every weight byte is read
// from HBM once and every SM streams the same share. A block is two consumer
// warpgroups, 64 vocab rows each (a tile of 128 rows), and one producer
// warp whose one thread keeps a ring of 64-deep k slots full by TMA: per
// slot the tile's [128][64] weight rows and the pass's [N][64] x rows, with
// full/empty mbarriers between them and no __syncthreads. A tile re-reads x
// (BK x d bf16) from L2 once a pass; two warpgroups a tile halve that
// traffic against one.
// Epilogue: a warp holds 16 vocab rows x N x rows in the wgmma D layout,
// where neighbouring vocab entries (one output row's contiguous bytes) lie
// in different lanes. It turns 32 x rows at a time around through 2.5 KB of
// its own shared memory (row stride 20 floats: conflict-free both ways),
// adds the bias and stores 64 contiguous bytes of each output row as four
// 16-byte stores. The producer is loading the next tile meanwhile. No
// atomics: each output is written once, in a fixed order of sums, so the
// kernel repeats bit for bit.

#include <stdint.h>
#include <initializer_list>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attn_tiles.cuh"
#include "tma_wgmma.cuh"

using namespace attn_tiles;
using namespace tma_wgmma;

namespace {

constexpr int KT = 64;                          // k of a ring slot: one 128-byte swizzled row
constexpr int UNIT = 64;                        // vocab rows of a warpgroup: wgmma's M
constexpr int WGS = 2;                          // consumer warpgroups: a tile of 128 vocab rows
constexpr int ATOM = 64 * TILE_BYTES_PER_ROW;   // one [64][64] bf16 tile, 8 KB
constexpr int THREADS = WGS * 128 + 32;         // and the producer warp
constexpr int MAX_SMEM = 232448;                // 227 KB a block
constexpr int ST_ROWS = 32;                     // x rows a warp turns around at a time
constexpr int ST_LD = 20;                       // floats a staged row: 16 vocab + 4 pad
constexpr int STAGING = WGS * 4 * ST_ROWS * ST_LD * 4;  // 20,480 bytes, every warp's

// NB 64-row chunks of x a pass (N = 64 NB) and the ring that fits beside
// the staging area and the barriers.
template <int NB>
struct Geometry {
  static_assert(NB >= 1 && NB <= 4, "N = 64 ... 256");
  static constexpr int N = 64 * NB;
  static constexpr int STAGE = WGS * ATOM + NB * ATOM;  // weight rows, then x rows
  static constexpr int FIT = (MAX_SMEM - TILE_ALIGN - STAGING - 2 * 8 * 8) / STAGE;
  static constexpr int STAGES = FIT > 8 ? 8 : FIT;
  static constexpr int SMEM = TILE_ALIGN + STAGES * STAGE + STAGING + 2 * STAGES * 8;
  static_assert(STAGES >= 3 && SMEM <= MAX_SMEM, "ring too small");
};

template <int NB>
__global__ void __launch_bounds__(THREADS, 1)
lm_head_kernel(const __grid_constant__ CUtensorMap map_w,
               const __grid_constant__ CUtensorMap map_x, const float* __restrict__ bias,
               float* __restrict__ logits, int BK, int Vp, int d) {
  using G = Geometry<NB>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_tiles(smem_raw);
  const uint32_t smem0 = smem_u32(smem);
  float* staging = reinterpret_cast<float*>(smem + G::STAGES * G::STAGE);
  const uint32_t full0 = smem0 + G::STAGES * G::STAGE + STAGING;  // STAGES full, then empty
  const uint32_t empty0 = full0 + G::STAGES * 8;
  const int tid = threadIdx.x;

  // this block's vocab units [u0, u1), tiles of WGS units, passes of N x rows
  const int units_all = Vp / UNIT;
  const int u0 = (int)((long long)blockIdx.x * units_all / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * units_all / gridDim.x);
  const int npass = (BK + G::N - 1) / G::N;
  const int nkt = (d + KT - 1) / KT;

  if (tid == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);      // the producer's expect_tx
      mbar_init(empty0 + 8 * s, WGS);   // one thread of each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= WGS * 128) {
    if (tid == WGS * 128) {  // the producer
      int slot = 0, parity = 1;  // a fresh barrier counts as released
      for (int u = u0; u < u1; u += WGS) {
        const int units = min(WGS, u1 - u);
        for (int p = 0; p < npass; ++p) {
          const int n0 = p * G::N;
          int xboxes = 0;  // boxes wholly past BK are not fetched: their columns are not stored
          for (int c = 0; c < NB; ++c) xboxes += n0 + 64 * c < BK;
          for (int kt = 0; kt < nkt; ++kt) {
            mbar_wait(empty0 + 8 * slot, parity);
            const uint32_t full = full0 + 8 * slot, st = smem0 + slot * G::STAGE;
            mbar_expect_tx(full, (units + xboxes) * ATOM);
            for (int a = 0; a < units; ++a)
              tma_load(st + a * ATOM, &map_w, kt * KT, (u + a) * UNIT, full);
            for (int c = 0; c < xboxes; ++c)
              tma_load(st + WGS * ATOM + c * ATOM, &map_x, kt * KT, n0 + 64 * c, full);
            if (++slot == G::STAGES) {
              slot = 0;
              parity ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const bool elected = (tid & 127) == 0;
  float* stg = staging + (wg * 4 + warp) * ST_ROWS * ST_LD;
  float acc[NB][8][4];
  int slot = 0, parity = 0;
  for (int u = u0; u < u1; u += WGS) {
    const int units = min(WGS, u1 - u);
    // the warp's 16 vocab rows; a warpgroup past the run's last unit
    // multiplies a stale tile and stores nothing
    const int vrow = (u + wg) * UNIT + warp * 16;
    for (int p = 0; p < npass; ++p) {
      const int n0 = p * G::N;
#pragma unroll
      for (int c = 0; c < NB; ++c) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[c][j][0] = acc[c][j][1] = acc[c][j][2] = acc[c][j][3] = 0.0f;
        pin(acc[c]);
      }
      int prev = 0;
      for (int kt = 0; kt < nkt; ++kt) {
        mbar_wait(full0 + 8 * slot, parity);  // the slot's tiles have landed (TMA: async proxy)
        const uint32_t st = smem0 + slot * G::STAGE;
        const uint64_t adesc = wgmma_tile_desc(st + wg * ATOM);  // its 64 vocab rows
        const uint64_t bdesc = wgmma_tile_desc(st + WGS * ATOM);  // the pass's x rows
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // 16 k: 32 bytes along both operands' rows
#pragma unroll
          for (int c = 0; c < NB; ++c)  // 64 x rows (8 KB of tile) a chunk
            wgmma_ss<0>(acc[c], adesc + 2 * kk, bdesc + c * (ATOM >> 4) + 2 * kk,
                        (kt != 0) | (kk != 0));
        wgmma_commit();
        wgmma_wait_pending<1>();  // the step before is done; this one runs on
        if (elected && kt > 0) mbar_arrive(empty0 + 8 * prev);  // hand its slot back
        prev = slot;
        if (++slot == G::STAGES) {
          slot = 0;
          parity ^= 1;
        }
      }
      wgmma_wait_pending<0>();
#pragma unroll
      for (int c = 0; c < NB; ++c) pin(acc[c]);
      if (elected) mbar_arrive(empty0 + 8 * prev);  // the pass's last slot

      if (wg < units) {
        // lane (g, t) holds vocab rows g, g + 8 and x rows 8j + 2t, + 1 of
        // tile j; staged as [x row][vocab] and read back as 16-byte pieces:
        // lane -> (row r, vocab quad q), the rows of a quarter warp four apart
        const int g = lane >> 2, t = lane & 3;
        const int q = lane & 3, r = ((lane >> 2) & 1) * 4 + (lane >> 3);
        const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias + vrow + 4 * q));
#pragma unroll
        for (int h = 0; h < 2 * NB; ++h) {  // x rows n0 + 32h .. n0 + 32h + 31
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float(&a)[4] = acc[h >> 1][(h & 1) * 4 + jj];
            float* row0 = stg + (8 * jj + 2 * t) * ST_LD + g;
            row0[0] = a[0];
            row0[ST_LD] = a[1];
            row0[8] = a[2];
            row0[ST_LD + 8] = a[3];
          }
          __syncwarp();
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = r + 8 * i, xrow = n0 + 32 * h + row;
            float4 v = *reinterpret_cast<const float4*>(stg + row * ST_LD + 4 * q);
            v.x += b4.x;
            v.y += b4.y;
            v.z += b4.z;
            v.w += b4.w;
            if (xrow < BK)
              *reinterpret_cast<float4*>(logits + (size_t)xrow * Vp + vrow + 4 * q) = v;
          }
          __syncwarp();
        }
      }
    }
  }
}

MapCache map_cache;

int sm_count() {  // of the current device, asked once per device
  static int dev_seen = -1, sms = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev != dev_seen) {
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    dev_seen = dev;
  }
  return sms;
}

template <int NB>
int launch(const void* x, const void* w, const float* bias, float* logits, int BK, int Vp,
           int d, cudaStream_t stream) {
  using G = Geometry<NB>;
  static int configured_device = -1;
  auto kernel = lm_head_kernel<NB>;
  cudaError_t e = allow_smem(kernel, G::SMEM, &configured_device);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap map_w, map_x;
  e = map_cache.get(w, Vp, d, 64, &map_w);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = map_cache.get(x, BK, d, 64, &map_x);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int grid = sms < Vp / UNIT ? sms : Vp / UNIT;
  kernel<<<grid, THREADS, G::SMEM, stream>>>(map_w, map_x, bias, logits, BK, Vp, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [BK, d] bf16, w [Vp, d] bf16, bias [Vp] f32 -> logits [BK, Vp] f32.
// Needs BK >= 1, d % 32 == 0, Vp % 128 == 0 and every pointer on 16 bytes;
// anything else is refused with cudaErrorInvalidValue.
extern "C" int vt_lm_head(const void* x, const void* w, const void* bias, void* logits, int BK,
                          int Vp, int d, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (BK < 1 || d < 32 || d % 32 || Vp < 128 || Vp % 128) return invalid;
  for (const void* p : {x, w, bias, static_cast<const void*>(logits)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return invalid;
  const float* b = reinterpret_cast<const float*>(bias);
  float* out = reinterpret_cast<float*>(logits);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (BK >= 256 ? 4 : (BK + 63) / 64) {
    case 1: return launch<1>(x, w, b, out, BK, Vp, d, st);
    case 2: return launch<2>(x, w, b, out, BK, Vp, d, st);
    case 3: return launch<3>(x, w, b, out, BK, Vp, d, st);
    default: return launch<4>(x, w, b, out, BK, Vp, d, st);
  }
}

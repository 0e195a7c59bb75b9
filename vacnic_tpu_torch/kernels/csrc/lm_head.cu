// The decoder's LM head over the padded vocabulary, logits = x w^T + b, and
// the same product with per-1024-block statistics (the LM-stats head).
//
// Replaces: vacnic_tpu/kernels/decode_layer.py:_kernel `_lm_head` (:643-650),
//   the extra grid iteration of decode_stack (:653, pallas_call :952) that
//   runs when ChunkPlan.n_lm > 0, over the vocab chunks lm_j (:832) of the
//   BlockSpecs at :900-901 (lm_head_kernel); and
//   vacnic_tpu/kernels/lm_stats.py:lm_stats (:76; _kernel :44, pallas_call
//   :104) (lm_stats_kernel).
// Computes, for x [BK, d] bf16 (the stack's last layer norm, rounded),
//   w [Vp, d] bf16 (the tied embedding padded to Vp rows, pad rows zero) and
//   b [Vp] f32 (pad entries -1e9): logits [BK, Vp] f32 = x w^T + b, bf16
//   products summed in f32. lm_stats_kernel also writes, for every
//   1024-wide vocab block j, m[r, j] = max(logits[r, block j]) and
//   s[r, j] = sum(exp(logits[r, block j] - m[r, j])).
//
// Bound on the H100 at the decode path's shape (BK 160, d 1024, Vp 53248):
//   the kernel must read 109 MB of weights and write 34 MB of logits,
//   143 MB: 0.043 ms at 3.35 TB/s. Its 17.4 GFLOP take 18 us at 989 TFLOP/s
//   (122 operations a byte, under the card's ~295): bytes bound. The weight
//   stream is what has to run at the memory's rate; x (320 KB) stays in L2.
//   The statistics add 2 x BK x Vp/1024 floats (68 KB) and the unit
//   partials below (2 x 4 x BK x Vp/64 bytes, 1.1 MB through L2).
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
// atomics in the product: each output is written once, in a fixed order of
// sums, so the kernel repeats bit for bit.
// Statistics (lm_stats_kernel only), from the very f32 values stored:
//   1. the stored values (bias added) go back into the staging area, and
//      each lane reads one x row's 16 vocab values of the warp whole: their
//      max, and their exp-sum in a fixed tree (ex2.approx, relative error ~2^-22: the stats
//      path's lse needs 1e-5), with no shuffle;
//   2. the warpgroup's four warps meet in 1 KB of shared memory a chunk of
//      32 x rows (double-buffered, one named barrier a chunk) and combine in
//      warp order into one (m, s) per (x row, 64-row unit), written to the
//      scratch unit_m/unit_s [BK, Vp/64];
//   3. when its whole run of units is done, a block adds its number of
//      units in each 1024-block it touched (one or two) to that block's
//      counter; the block whose addition makes 16 reads the block's 16 unit
//      partials of every x row in unit order and writes m = max m_u and
//      s = sum s_u exp(m_u - m), then sets the counter back to zero for the
//      next launch (a CUDA graph replays it). One arrival a block, at its
//      end, keeps the fence and the atomic off the weight stream: an arrival
//      a tile and pass stalled it (on an H100 at BK 160, 0.0853 ms against 0.0787).
//   m is a max of stored values, so stage 2's block-pigeonhole top-C is
//   exact on the stored logits; the fixed orders keep the output
//   bit-identical from call to call; an all-pad block gives m = -1e9 and
//   s = 1024. One launch a step, as before.

#include <float.h>
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
constexpr int VBLOCK = 1024;                    // vocab block of the statistics
constexpr int UNITS_PER_VBLOCK = VBLOCK / UNIT;  // 16: what a 1024-block's counter counts to
// the statistics' exchange: per warpgroup two chunk buffers of the four
// warps' (m, s) for 32 x rows, then a flag word per warpgroup (padded)
constexpr int EXCH = WGS * 2 * 4 * ST_ROWS * 8;  // 4,096 bytes
constexpr int FLAGS = 16;

// The statistics' outputs and scratch; all null for the plain head.
struct Stats {
  float* m;                // [BK, Vp / VBLOCK]
  float* s;
  float* unit_m;           // [BK, Vp / UNIT]: scratch, written before it is read
  float* unit_s;
  unsigned int* counters;  // [Vp / VBLOCK]: zero between launches
};

// NB 64-row chunks of x a pass (N = 64 NB) and the ring that fits beside
// the staging area, the statistics' exchange and the barriers.
template <int NB, bool STATS>
struct Geometry {
  static_assert(NB >= 1 && NB <= 4, "N = 64 ... 256");
  static constexpr int N = 64 * NB;
  static constexpr int STAGE = WGS * ATOM + NB * ATOM;  // weight rows, then x rows
  static constexpr int EXTRA = STATS ? EXCH + FLAGS : 0;
  static constexpr int FIT = (MAX_SMEM - TILE_ALIGN - STAGING - EXTRA - 2 * 8 * 8) / STAGE;
  static constexpr int STAGES = FIT > 8 ? 8 : FIT;
  static constexpr int SMEM = TILE_ALIGN + STAGES * STAGE + STAGING + EXTRA + 2 * STAGES * 8;
  static_assert(STAGES >= 3 && SMEM <= MAX_SMEM, "ring too small");
};

// A barrier of one consumer warpgroup's 128 threads (id 0 is __syncthreads').
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// A barrier of both consumer warpgroups (the producer warp has left).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, %0;\n" ::"n"(WGS * 128) : "memory");
}

template <int NB, bool STATS>
__device__ __forceinline__ void lm_head_body(const CUtensorMap* map_w, const CUtensorMap* map_x,
                                             const float* __restrict__ bias,
                                             float* __restrict__ logits, const Stats& stats,
                                             int BK, int Vp, int d) {
  using G = Geometry<NB, STATS>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_tiles(smem_raw);
  const uint32_t smem0 = smem_u32(smem);
  float* staging = reinterpret_cast<float*>(smem + G::STAGES * G::STAGE);
  float2* exch = reinterpret_cast<float2*>(smem + G::STAGES * G::STAGE + STAGING);
  const uint32_t full0 = smem0 + G::STAGES * G::STAGE + STAGING + (STATS ? EXCH : 0);
  const uint32_t empty0 = full0 + G::STAGES * 8;  // STAGES full, then STAGES empty
  int* flags = reinterpret_cast<int*>(smem + G::STAGES * G::STAGE + STAGING + EXCH +
                                      2 * G::STAGES * 8);  // read only when STATS
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
              tma_load(st + a * ATOM, map_w, kt * KT, (u + a) * UNIT, full);
            for (int c = 0; c < xboxes; ++c)
              tma_load(st + WGS * ATOM + c * ATOM, map_x, kt * KT, n0 + 64 * c, full);
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
  int chunk = 0;  // chunks of 32 x rows this warpgroup has exchanged (STATS)
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
          if (n0 + 32 * h >= BK) break;     // the same for the whole warpgroup
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
          // this chunk's exchange buffer: [warp][x row] of (m, s)
          float2* ex = exch + (wg * 2 + (chunk & 1)) * 4 * ST_ROWS;
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
            if constexpr (STATS)  // the stored values back in place, for the statistics
              *reinterpret_cast<float4*>(stg + row * ST_LD + 4 * q) = v;
          }
          if constexpr (STATS) {
            // lane l: x row l of the chunk, its 16 stored vocab values read
            // back whole (rows 80 bytes apart: conflict-free), twice: for the
            // max, then for the exp-sum (fewer live registers beside acc)
            __syncwarp();
            const float4* mine = reinterpret_cast<const float4*>(stg + lane * ST_LD);
            float pm = -FLT_MAX;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float4 a = mine[k];
              pm = fmaxf(pm, fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w)));
            }
            float s4[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float4 a = mine[k];
              s4[k] = (fast_exp(a.x - pm) + fast_exp(a.y - pm)) +
                      (fast_exp(a.z - pm) + fast_exp(a.w - pm));
            }
            ex[warp * ST_ROWS + lane] = make_float2(pm, (s4[0] + s4[1]) + (s4[2] + s4[3]));
          }
          __syncwarp();
          if constexpr (STATS) {
            // the four warps' partials of the chunk meet; warp w combines
            // x rows 8w .. 8w + 7 in warp order. The buffer is written again
            // two chunks on, after every warp has passed the next barrier.
            warpgroup_sync(wg);
            if (lane < 8) {
              const int row = warp * 8 + lane, xrow = n0 + 32 * h + row;
              const float2 p0 = ex[row], p1 = ex[ST_ROWS + row], p2 = ex[2 * ST_ROWS + row],
                           p3 = ex[3 * ST_ROWS + row];
              const float m = fmaxf(fmaxf(p0.x, p1.x), fmaxf(p2.x, p3.x));
              const float s = ((p0.y * fast_exp(p0.x - m) + p1.y * fast_exp(p1.x - m)) +
                               p2.y * fast_exp(p2.x - m)) + p3.y * fast_exp(p3.x - m);
              if (xrow < BK) {
                stats.unit_m[(size_t)xrow * units_all + u + wg] = m;
                stats.unit_s[(size_t)xrow * units_all + u + wg] = s;
              }
            }
            ++chunk;
          }
        }
      }
    }
  }

  if constexpr (STATS) {
    // Every unit partial of this block's run is out. One arrival for each
    // 1024-block the run touches (usually one or two), adding the run's
    // units of it; the block whose arrival makes 16 combines that block for
    // all BK rows, in unit order, and sets its counter back to zero.
    __threadfence();
    consumers_sync();
    const int nvb = Vp / VBLOCK;
    for (int vb = u0 / UNITS_PER_VBLOCK; vb <= (u1 - 1) / UNITS_PER_VBLOCK; ++vb) {
      unsigned int* ctr = stats.counters + vb;
      if (tid == 0) {
        const int n = min(u1, (vb + 1) * UNITS_PER_VBLOCK) - max(u0, vb * UNITS_PER_VBLOCK);
        flags[0] = atomicAdd(ctr, (unsigned)n) + n == UNITS_PER_VBLOCK;
      }
      consumers_sync();
      const bool last = flags[0];
      if (last) {
        __threadfence();
        for (int xrow = tid; xrow < BK; xrow += WGS * 128) {
          const float4* pm = reinterpret_cast<const float4*>(
              stats.unit_m + (size_t)xrow * units_all + vb * UNITS_PER_VBLOCK);
          const float4* ps = reinterpret_cast<const float4*>(
              stats.unit_s + (size_t)xrow * units_all + vb * UNITS_PER_VBLOCK);
          float mu[UNITS_PER_VBLOCK], su[UNITS_PER_VBLOCK];
#pragma unroll
          for (int k = 0; k < UNITS_PER_VBLOCK / 4; ++k) {  // from L2: other SMs wrote them
            const float4 a = __ldcg(pm + k), b = __ldcg(ps + k);
            mu[4 * k] = a.x, mu[4 * k + 1] = a.y, mu[4 * k + 2] = a.z, mu[4 * k + 3] = a.w;
            su[4 * k] = b.x, su[4 * k + 1] = b.y, su[4 * k + 2] = b.z, su[4 * k + 3] = b.w;
          }
          float m = mu[0];
#pragma unroll
          for (int k = 1; k < UNITS_PER_VBLOCK; ++k) m = fmaxf(m, mu[k]);
          float s = 0.0f;
#pragma unroll
          for (int k = 0; k < UNITS_PER_VBLOCK; ++k) s += su[k] * fast_exp(mu[k] - m);
          stats.m[(size_t)xrow * nvb + vb] = m;
          stats.s[(size_t)xrow * nvb + vb] = s;
        }
        if (tid == 0) atomicExch(ctr, 0u);  // all 16 of this launch are in
      }
      consumers_sync();  // flags[0] is read before the next vocab block writes it
    }
  }
}

template <int NB>
__global__ void __launch_bounds__(THREADS, 1)
lm_head_kernel(const __grid_constant__ CUtensorMap map_w,
               const __grid_constant__ CUtensorMap map_x, const float* __restrict__ bias,
               float* __restrict__ logits, int BK, int Vp, int d) {
  lm_head_body<NB, false>(&map_w, &map_x, bias, logits, Stats{}, BK, Vp, d);
}

template <int NB>
__global__ void __launch_bounds__(THREADS, 1)
lm_stats_kernel(const __grid_constant__ CUtensorMap map_w,
                const __grid_constant__ CUtensorMap map_x, const float* __restrict__ bias,
                float* __restrict__ logits, const Stats stats, int BK, int Vp, int d) {
  lm_head_body<NB, true>(&map_w, &map_x, bias, logits, stats, BK, Vp, d);
}

MapCache map_cache;

template <int NB, bool STATS>
int launch(const void* x, const void* w, const float* bias, float* logits, const Stats& stats,
           int BK, int Vp, int d, cudaStream_t stream) {
  using G = Geometry<NB, STATS>;
  static device_state::PerDevice configured;
  cudaError_t e;
  if constexpr (STATS)
    e = allow_smem(lm_stats_kernel<NB>, G::SMEM, configured);
  else
    e = allow_smem(lm_head_kernel<NB>, G::SMEM, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap map_w, map_x;
  e = map_cache.get(w, Vp, d, 64, &map_w);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = map_cache.get(x, BK, d, 64, &map_x);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int grid = sms < Vp / UNIT ? sms : Vp / UNIT;
  if constexpr (STATS)
    lm_stats_kernel<NB><<<grid, THREADS, G::SMEM, stream>>>(map_w, map_x, bias, logits, stats,
                                                            BK, Vp, d);
  else
    lm_head_kernel<NB><<<grid, THREADS, G::SMEM, stream>>>(map_w, map_x, bias, logits, BK, Vp, d);
  return static_cast<int>(cudaGetLastError());
}

// N = 64 NB x rows a pass: BK rounded up to 64, at most 256.
template <bool STATS>
int dispatch(const void* x, const void* w, const void* bias, void* logits, const Stats& stats,
             int BK, int Vp, int d, void* stream) {
  const float* b = reinterpret_cast<const float*>(bias);
  float* out = reinterpret_cast<float*>(logits);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (BK >= 256 ? 4 : (BK + 63) / 64) {
    case 1: return launch<1, STATS>(x, w, b, out, stats, BK, Vp, d, st);
    case 2: return launch<2, STATS>(x, w, b, out, stats, BK, Vp, d, st);
    case 3: return launch<3, STATS>(x, w, b, out, stats, BK, Vp, d, st);
    default: return launch<4, STATS>(x, w, b, out, stats, BK, Vp, d, st);
  }
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

}  // namespace

// x [BK, d] bf16, w [Vp, d] bf16, bias [Vp] f32 -> logits [BK, Vp] f32.
// Needs BK >= 1, d % 32 == 0, Vp % 128 == 0 and every pointer on 16 bytes;
// anything else is refused with cudaErrorInvalidValue.
extern "C" int vt_lm_head(const void* x, const void* w, const void* bias, void* logits, int BK,
                          int Vp, int d, void* stream) {
  if (BK < 1 || d < 32 || d % 32 || Vp < 128 || Vp % 128 ||
      !aligned16({x, w, bias, static_cast<const void*>(logits)}))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<false>(x, w, bias, logits, Stats{}, BK, Vp, d, stream);
}

// The same, and m, s [BK, Vp / 1024] f32, the blocks' max and exp-sum.
// unit_m, unit_s [BK, Vp / 64] f32 are scratch; counters [Vp / 1024] must
// be zero and are left zero. Needs BK >= 1, d % 32 == 0, Vp % 1024 == 0 and x, w, bias, logits,
// unit_m, unit_s on 16 bytes; anything else is refused with
// cudaErrorInvalidValue.
extern "C" int vt_lm_stats(const void* x, const void* w, const void* bias, void* logits, void* m,
                           void* s, void* unit_m, void* unit_s, void* counters, int BK, int Vp,
                           int d, void* stream) {
  if (BK < 1 || d < 32 || d % 32 || Vp < VBLOCK || Vp % VBLOCK ||
      !aligned16({x, w, bias, static_cast<const void*>(logits), static_cast<const void*>(unit_m),
                  static_cast<const void*>(unit_s)}) ||
      m == nullptr || s == nullptr || counters == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Stats stats{static_cast<float*>(m), static_cast<float*>(s), static_cast<float*>(unit_m),
                    static_cast<float*>(unit_s), static_cast<unsigned int*>(counters)};
  return dispatch<true>(x, w, bias, logits, stats, BK, Vp, d, stream);
}

// Dynamic shared memory a block of lm_head_kernel (stats 0) or
// lm_stats_kernel (stats 1) takes at N = 64 nb x rows a pass, nb 1 ... 4;
// -1 for any other nb. Returns bytes, not an error code.
extern "C" int vt_lm_head_smem_bytes(int nb, int stats) {
  switch (nb) {
    case 1: return stats ? Geometry<1, true>::SMEM : Geometry<1, false>::SMEM;
    case 2: return stats ? Geometry<2, true>::SMEM : Geometry<2, false>::SMEM;
    case 3: return stats ? Geometry<3, true>::SMEM : Geometry<3, false>::SMEM;
    case 4: return stats ? Geometry<4, true>::SMEM : Geometry<4, false>::SMEM;
    default: return -1;
  }
}

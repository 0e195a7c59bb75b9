// Decoder cross-attention of one beam-search step: every beam row of an item
// attends over the item's beam-invariant K/V [B, H, 64, S] (channel-major,
// bf16, or int8 with per-(item, head, channel) f32 scales) with the additive
// pad bias [B, S].
//
// Replaces: the cross-attention phase of vacnic_tpu/kernels/decode_layer.py:
//   _kernel (_cross_attn, decode_layer.py:499).
// Semantics (the plain twin's, kernels/primitives.dec_cross_attention_plain):
//   q is rounded to bf16 after the head_dim**-0.5 scaling (int8: then
//   multiplied by the K scale and rounded again); scores and the softmax over
//   all S are f32 with the f32 bias; the normalised probabilities are rounded
//   to bf16 before the value sum, which is f32 (int8: times the V scale); the
//   head output is bf16.
//
// Bound on the H100 at the main path (B = 32 items x 5 beams, H = 16, S = 512):
//   bytes. Each K/V element is needed once a step for all beams of its item:
//   2 * B * H * 64 * S = 33.5 MB in int8 (~10 us at 3.35 TB/s), 67 MB in bf16.
// Design: one block of four warps an (item, head), all of them resident at
//   once (B * H = 512 blocks, four a SM), each streaming its K and then its V
//   through a ring of 64-position tiles in shared memory: 16-byte cp.async
//   copies, R - 1 tiles in flight while the block works on one (R = 4 for
//   int8, 3 for bf16), one block barrier a tile. So a block's loads never
//   stop for its products or its softmax, and V's first tiles land while the
//   last scores and the softmax run.
//   - Scores: tensor cores (mma.sync m16n8k16, bf16 in, f32 sums). Warp w
//     takes the tile's positions 16w .. 16w + 15 as the A operand, K read
//     transposed by ldmatrix; q of the beams, padded to 8, is B, in registers.
//     Scores + bias stay in shared memory, f32, for all S.
//   - Softmax after the last K tile: a warp a beam, exact over all S, then
//     the normalised probabilities rounded to bf16, as the twin does.
//   - P V: warp w takes channels 16w .. 16w + 15 of each V tile as A (rows of
//     V), the probabilities as B, and sums over all S in its registers.
//   - int8 becomes bf16 exactly (byte v ^ 0x80 into the mantissa of 2^23,
//     2^23 + 128 off again; the top half of that f32 is its bf16), each warp
//     converting only the strip of the tile it multiplies, so no block
//     barrier sits between the conversion and the product.
//   The sums run in a fixed order: bit-identical from call to call. Positions
//   past S (the last tile's tail) are zero in shared memory and masked out of
//   the softmax. A head whose rows are not 16-byte aligned in device memory
//   (S * element bytes % 16 != 0) is copied element by element.
// More than 8 beams, two launches (kernels/primitives.dec_cross_plan picks):
//   - wide (9-24 beams): one block an (item, head) holds all of its beams,
//     q as ceil(beams / 8) n8 operands of mma.sync. Each K/V tile is copied
//     and (int8) converted once; a warp loads its A fragments of a tile once
//     and issues one mma a group, so the tensor-core work grows with the
//     beams and the bytes do not. Scores [beams][S] f32 bound the block's
//     shared memory, so the rest is cut to let four blocks share a SM up to
//     16 int8 beams at S = 512: the probabilities overlay the first half of
//     each beam's own score row (a warp writes a beam's bf16 over floats it
//     has read, 32 positions at a time in increasing order, so no write
//     lands on a float still unread), int8 tiles become bf16 in the lanes'
//     own operand registers (no strip in shared memory), and the bias is
//     read from device memory. The softmax's max is kept in registers while
//     the scores are written (a max is the same in any order), and its pass
//     over a row stores each exp, which the normalisation then scales: one
//     expf a position.
//   - grouped (any count): the beams of an item in groups of 8, one block a
//     (group, head, item), the group index fastest in launch order, so the
//     groups of one (item, head) run side by side and all but the first find
//     its K/V in L2 (64 KB a head in int8). Each block keeps the shared
//     memory of 8 beams, so S's limit does not fall with the beam count; the
//     last group's beams past the item's end are zero q rows, as beams past
//     NB are below 8.
//   Every beam's sums are those of a block of <= 8 beams in either launch:
//   the same A and B operands for its column of each mma, the same softmax
//   (a warp a beam: lanes strided over S in increasing order, then the
//   butterfly), the same P V order. So the bits are the same at any beam
//   count and in either launch.
// Split (1-8 beams, an S whose scores no block holds: LED's 16384 positions
//   at 5 beams need 320 KB of them): S cut into whole tiles over a thread
//   block cluster of 2, 4 or 8 blocks an (item, head), rank r taking the r-th
//   share in order. Each block runs the beams block above on its share: its
//   scores, then the exact softmax over the whole row through distributed
//   shared memory -- each rank's row maxima, the cluster barrier, the row
//   max over the ranks (a max is the same in any order), each rank's sum of
//   exp(s - max), the barrier, the sum over the ranks in rank order, which
//   every rank adds alike -- so the probabilities are rounded to bf16 after
//   the division by the whole row's sum; then its share of P V, the partial
//   sums of every rank read by rank 0 and added in rank order. The order is
//   fixed: bit-identical from call to call. The sums' order differs from the
//   unsplit block's, so the two agree to f32 rounding, not bit for bit. At
//   S 512 an earlier version of this split (2 or 4 blocks) was measured
//   against the unsplit block and not kept: 2048 short blocks in three
//   waves, whose loads stopped between the waves (PERF.md). Here it runs
//   only where no unsplit block fits.
//   In the wide block: the probabilities in rows of their own, int8's bf16
//   strips in shared memory, and one expf a position in each of two passes.

#include <math.h>
#include <stdint.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>

#include "attn_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

using attn_tiles::cp_async16;
using attn_tiles::cp_async_commit;
using attn_tiles::cp_async_wait;
using attn_tiles::smem_u32;

constexpr int HD = 64;
constexpr int THREADS = 128;  // four warps
constexpr int TP = 64;        // positions a tile
constexpr int MAX_BEAMS = 8;  // a block's beams: the n8 operand of mma.sync
constexpr int MAX_SMEM = 232448;
constexpr int QSW = HD + 4;   // floats a row of q in shared memory
constexpr int STRIP = 3072;   // bytes of a warp's bf16 strip of an int8 tile

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Four int8 (one word) -> four bf16 (two words, the lower index in the low
// half): byte v ^ 0x80 = v + 128 becomes the low mantissa byte of 2^23, and
// 2^23 + 128 comes off again; the result is an integer of at most 8 bits, so
// its bf16 is the top half of its f32. Exact.
__device__ __forceinline__ uint2 quad_to_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr float OFF = 8388736.0f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - OFF;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - OFF;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - OFF;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - OFF;
  return make_uint2(__byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632),
                    __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632));
}

// 16 int8 at `src` -> 16 bf16 at `dst` (both 16-byte aligned).
__device__ __forceinline__ void int8x16_to_bf16(const unsigned char* src, unsigned char* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const uint2 a = quad_to_bf16(v.x), b = quad_to_bf16(v.y), c = quad_to_bf16(v.z),
              d = quad_to_bf16(v.w);
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(a.x, a.y, b.x, b.y);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(c.x, c.y, d.x, d.y);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ldmatrix: four (two) 8 x 8 bf16 matrices whose rows lanes 0-7, 8-15, 16-23,
// 24-31 (0-7, 8-15) point at; .trans hands each lane a column pair.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}

// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 products, f32 sums. Lane (g, t) =
// (lane / 4, lane % 4) holds a = rows g, g + 8 x k 2t, 2t + 1 (a0, a1) and
// k 2t + 8, 2t + 9 (a2, a3); b = k 2t, 2t + 1 (b0), 2t + 8, 2t + 9 (b1) x
// column g; d = rows g (d0, d1), g + 8 (d2, d3) x columns 2t, 2t + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes of a row of `n` elements in shared memory, padded to an odd number
// of 16-byte chunks, so that the eight rows one ldmatrix (or eight lanes
// reading 16 bytes) touches lie in eight different bank groups.
__host__ __device__ constexpr int row_bytes(int n, int elem_bytes) {
  return ((n * elem_bytes / 16) | 1) * 16;
}

__host__ __device__ constexpr int ring_slots(int elem_bytes) { return elem_bytes == 1 ? 4 : 3; }

// Dynamic shared memory of a block (kernels/primitives.dec_cross_smem_bytes
// states the same), sp = S rounded up to whole tiles: the ring of K/V tiles
// as copied, int8's bf16 strips (one a warp), scores [beams][sp + 4] f32,
// probabilities [beams][sp + 8] bf16, a zero row, q [8][68] f32, the bias
// [sp], the V scales [64], the softmax statistics [8].
__host__ __device__ constexpr long long smem_bytes(int beams, int S, int elem_bytes) {
  return static_cast<long long>(ring_slots(elem_bytes)) * HD * row_bytes(TP, elem_bytes) +
         (elem_bytes == 1 ? 4 * STRIP : 0) + 4LL * beams * ((S + TP - 1) / TP * TP + 4) +
         2LL * beams * ((S + TP - 1) / TP * TP + 8) + 16 + 4LL * MAX_BEAMS * QSW +
         4LL * ((S + TP - 1) / TP * TP) + 4LL * HD + 8LL * MAX_BEAMS;
}

// Dynamic shared memory of a wide block (kernels/primitives.dec_cross_smem_bytes
// states the same): the ring as above, scores [beams][sp + 4] f32 (the
// probabilities over them), a zero row, the V scales [64], the warps' score
// maxima [4][beams].
__host__ __device__ constexpr long long wide_smem_bytes(int beams, int S, int elem_bytes) {
  return static_cast<long long>(ring_slots(elem_bytes)) * HD * row_bytes(TP, elem_bytes) +
         4LL * beams * ((S + TP - 1) / TP * TP + 4) + 16 + 4LL * HD + 16LL * beams;
}

constexpr int MAX_SPLIT = 8;  // blocks of a split cluster: the portable largest

// Positions a rank of a split over `split` blocks takes: whole tiles.
__host__ __device__ constexpr int split_positions(int S, int split) {
  return ((S + TP - 1) / TP + split - 1) / split * TP;
}

// Dynamic shared memory of a split block (kernels/primitives.dec_cross_smem_bytes
// states the same): the beams block's layout for `beams` beams over a
// rank's positions, then the exchange: the row maxima [8], the row sums [8]
// and the partial outputs [128][4], f32.
__host__ __device__ constexpr long long split_smem_bytes(int beams, int S, int elem_bytes,
                                                         int split) {
  return static_cast<long long>(ring_slots(elem_bytes)) * HD * row_bytes(TP, elem_bytes) +
         (elem_bytes == 1 ? 4 * STRIP : 0) + 4LL * beams * (split_positions(S, split) + 4) +
         2LL * beams * (split_positions(S, split) + 8) + 16 + 4LL * MAX_BEAMS * QSW +
         4LL * split_positions(S, split) + 4LL * HD + 8LL * MAX_BEAMS + 4LL * 2 * MAX_BEAMS +
         16LL * THREADS;
}

// A block's work: the NB beams of an (item, head), or (GROUPED, NB = 8)
// one group of 8 beams of it, or (SPLIT, NB = 8) the `beams` beams of an
// (item, head) over one rank's share of S.
template <typename KT, int NB, bool GROUPED, bool SPLIT = false>
__device__ __forceinline__ void
dec_cross_block(const __nv_bfloat16* __restrict__ q, const KT* __restrict__ ck,
                const KT* __restrict__ cv, const float* __restrict__ ks,
                const float* __restrict__ vs, const float* __restrict__ bias,
                __nv_bfloat16* __restrict__ out, int H, int S, int beams, int vec,
                float scaling) {
  constexpr int EB = sizeof(KT);
  constexpr bool INT8 = EB == 1;
  constexpr int R = ring_slots(EB);
  constexpr int RB = row_bytes(TP, EB);   // a row of a tile as copied
  constexpr int RBT = row_bytes(TP, 2);   // a bf16 row of a tile
  constexpr int SLOT = HD * RB;
  constexpr int SROW = row_bytes(16, 2);  // a row of a scores strip: 16 positions
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = GROUPED || SPLIT ? blockIdx.y : blockIdx.x;
  const int b = GROUPED || SPLIT ? blockIdx.z : blockIdx.y;
  const int grp = GROUPED ? blockIdx.x : 0;
  const int nb = GROUPED ? min(NB, beams - NB * grp) : SPLIT ? beams : NB;  // this block's beams
  const size_t row0 =
      static_cast<size_t>(b) * (GROUPED || SPLIT ? beams : NB) + NB * grp;  // its first q row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;   // mma lane naming
  const int mi = lane >> 3, r = lane & 7;  // the ldmatrix matrix and row this lane points at
  const int D = H * HD;
  const size_t head = static_cast<size_t>(b) * H + h;
  // the positions p0 .. p0 + sl - 1 of S are this block's (all but in a split)
  const int rank = SPLIT ? blockIdx.x : 0, nsplit = SPLIT ? gridDim.x : 1;
  const int spr = SPLIT ? split_positions(S, nsplit) : 0;
  const int p0 = rank * spr, sl = SPLIT ? min(spr, S - p0) : S;
  const int nt = (sl + TP - 1) / TP, sp = SPLIT ? spr : nt * TP;  // tiles; the layout's positions
  const int LB = SPLIT ? nb : NB;       // beams the layout holds
  const int SCW = sp + 4, PW = sp + 8;  // rows of scores, probabilities
  unsigned char* ring = smem;                                           // [R][64][RB]
  unsigned char* strip = ring + R * SLOT + (INT8 ? warp * STRIP : 0);  // int8: this warp's
  float* sc = reinterpret_cast<float*>(ring + R * SLOT + (INT8 ? 4 * STRIP : 0));  // [LB][SCW]
  __nv_bfloat16* pt = reinterpret_cast<__nv_bfloat16*>(sc + LB * SCW);    // [LB][PW]
  unsigned char* zero16 = reinterpret_cast<unsigned char*>(pt + LB * PW);  // 16 zero bytes
  float* qs = reinterpret_cast<float*>(zero16 + 16);                     // [8][QSW]
  float* bs = qs + MAX_BEAMS * QSW;                                      // [sp] bias
  float* vss = bs + sp;                                                  // [64] V scales
  float2* gst = reinterpret_cast<float2*>(vss + HD);                    // [8] (max, 1 / sum)
  float* xm = reinterpret_cast<float*>(gst + MAX_BEAMS);  // split: [8] this rank's row maxima,
  float* xl = xm + MAX_BEAMS;                             // [8] its row sums,
  float* xo = xl + MAX_BEAMS;                             // [128][4] its partial outputs
  const KT* kg = ck + head * HD * S + p0;
  const KT* vg = cv + head * HD * S + p0;
  const float* bg = bias + static_cast<size_t>(b) * S + p0;

  // tile j of K_0 .. K_{nt-1}, V_0 .. V_{nt-1} into ring slot j % R: one
  // cp.async group a tile (an empty one past the end keeps the count)
  auto fetch = [&](int j) {
    if (j < 2 * nt) {
      const int jt = j < nt ? j : j - nt;
      const KT* src = (j < nt ? kg : vg) + jt * TP;
      unsigned char* dst = ring + (j % R) * SLOT;
      const int n = min(TP, sl - jt * TP);
      if (vec && n == TP) {  // a whole tile: every thread the same pieces, no division
        constexpr int CPR = TP * EB / 16;  // 16-byte pieces of a row
        const int c = tid % CPR;
#pragma unroll
        for (int row = tid / CPR; row < HD; row += THREADS / CPR)
          cp_async16(smem_u32(dst + row * RB + 16 * c),
                     reinterpret_cast<const unsigned char*>(src + static_cast<size_t>(row) * S) +
                         16 * c);
      } else if (vec) {
        const int chunks = n * EB / 16;
        for (int i = tid; i < HD * chunks; i += THREADS) {
          const int row = i / chunks, c = i - row * chunks;
          cp_async16(smem_u32(dst + row * RB + 16 * c),
                     reinterpret_cast<const unsigned char*>(src + static_cast<size_t>(row) * S) +
                         16 * c);
        }
      } else {
        for (int i = tid; i < HD * n; i += THREADS) {
          const int row = i / n, p = i - row * n;
          reinterpret_cast<KT*>(dst + row * RB)[p] = src[static_cast<size_t>(row) * S + p];
        }
      }
      const int tail = (TP - n) * EB;  // past S: zero, so 0 * V stays 0
      for (int i = tid; i < HD * tail; i += THREADS) {
        const int row = i / tail;
        dst[row * RB + n * EB + (i - row * tail)] = 0;
      }
    }
    cp_async_commit();
  };

  // 1. the bias rides in the first tile's group; R - 1 tiles go out; q and
  // the scales come into registers meanwhile
  if (vec) {
    for (int c = tid; c < sl / 4; c += THREADS) cp_async16(smem_u32(bs + 4 * c), bg + 4 * c);
  } else {
    for (int p = tid; p < sl; p += THREADS) bs[p] = bg[p];
  }
#pragma unroll
  for (int j = 0; j < R - 1; ++j) fetch(j);
  const int qb = tid >> 4, qc = 4 * (tid & 15);  // thread t: four channels of beam t / 16
  uint2 q4 = make_uint2(0u, 0u);
  float4 k4s = make_float4(1.0f, 1.0f, 1.0f, 1.0f), v4s = k4s;
  if (qb < nb) {
    q4 = *reinterpret_cast<const uint2*>(q + (row0 + qb) * D + h * HD + qc);
    if (ks != nullptr) k4s = *reinterpret_cast<const float4*>(ks + head * HD + qc);
  }
  if (tid < HD / 4 && vs != nullptr) v4s = *reinterpret_cast<const float4*>(vs + head * HD + 4 * tid);
  if (tid < 4) reinterpret_cast<uint32_t*>(zero16)[tid] = 0u;
  {
    const float qv[4] = {__uint_as_float(q4.x << 16), __uint_as_float(q4.x & 0xFFFF0000u),
                         __uint_as_float(q4.y << 16), __uint_as_float(q4.y & 0xFFFF0000u)};
    const float kv[4] = {k4s.x, k4s.y, k4s.z, k4s.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // beams past nb: q = 0
      float v = bf16_round(qv[i] * scaling);
      if (ks != nullptr) v = bf16_round(v * kv[i]);
      qs[qb * QSW + qc + i] = v;
    }
  }
  if (tid < HD / 4) *reinterpret_cast<float4*>(vss + 4 * tid) = v4s;
  __syncthreads();
  uint32_t qf[4][2];  // B of the scores: q of beam g at the channel pairs of k-step kk
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float* qr = qs + g * QSW + 16 * kk + 2 * t;
    qf[kk][0] = pack_bf16(qr[0], qr[1]);  // bf16 values already: exact
    qf[kk][1] = pack_bf16(qr[8], qr[9]);
  }
  // B of P V: the probabilities of beam r, or a zero row past nb
  const bool real = r < nb;
  const uint32_t pbase = real ? smem_u32(pt) + (r * PW + 8 * (mi & 1)) * 2 : smem_u32(zero16);

  // 2. the tiles, one block barrier each
  float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // channels 16w + g (+ 8) x beams 2t, 2t + 1
  for (int j = 0; j < 2 * nt; ++j) {
    cp_async_wait<R - 2>();  // this thread's copies of tile j have landed
    __syncthreads();         // everyone's; and everyone is done with tile j - 1
    fetch(j + R - 1);        // into the slot tile j - 1 left
    const unsigned char* cur = ring + (j % R) * SLOT;
    if (j < nt) {
      // scores of positions j TP + 16w .. + 15: A = K^T (rows = positions)
      uint32_t base;
      if (INT8) {  // this warp's 16 columns of the 64 K rows, as bf16 rows of 16
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = lane + 32 * i;
          int8x16_to_bf16(cur + row * RB + 16 * warp, strip + row * SROW);
        }
        __syncwarp();
        base = smem_u32(strip) + (r + 8 * (mi >> 1)) * SROW + 16 * (mi & 1);
      } else {
        base = smem_u32(cur) + (r + 8 * (mi >> 1)) * RBT + 2 * (16 * warp + 8 * (mi & 1));
      }
      constexpr int KSTEP = 16 * (INT8 ? SROW : RBT);  // bytes of 16 channel rows
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        ldsm_x4_trans(base + kk * KSTEP, a);
        mma_bf16(d, a, qf[kk][0], qf[kk][1]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int pos = j * TP + 16 * warp + g + 8 * hh;
        const bool inside = pos < sl;
        const float bb = inside ? bs[pos] : 0.0f;
        if (2 * t < nb) sc[2 * t * SCW + pos] = inside ? d[2 * hh] + bb : -INFINITY;
        if (2 * t + 1 < nb) sc[(2 * t + 1) * SCW + pos] = inside ? d[2 * hh + 1] + bb : -INFINITY;
      }
      if (j == nt - 1) {  // 3. softmax over all S, a warp a beam
        __syncthreads();
        if constexpr (SPLIT) {  // the row's statistics over the cluster's ranks
          cg::cluster_group cluster = cg::this_cluster();
          for (int bm = warp; bm < nb; bm += THREADS / 32) {
            const float* row = sc + bm * SCW;
            float m = -INFINITY;
            for (int p = lane; p < sl; p += 32) m = fmaxf(m, row[p]);
            m = warp_max(m);
            if (lane == 0) xm[bm] = m;
          }
          cluster.sync();  // every rank's maxima are in
          for (int bm = warp; bm < nb; bm += THREADS / 32) {
            float m = -INFINITY;
            for (int k = 0; k < nsplit; ++k) m = fmaxf(m, cluster.map_shared_rank(xm, k)[bm]);
            const float* row = sc + bm * SCW;
            float l = 0.0f;
            for (int p = lane; p < sl; p += 32) l += expf(row[p] - m);
            l = warp_sum(l);
            if (lane == 0) {
              xl[bm] = l;
              gst[bm].x = m;
            }
          }
          cluster.sync();  // every rank's sums are in
          if (tid < nb) {
            float l = 0.0f;
            for (int k = 0; k < nsplit; ++k) l += cluster.map_shared_rank(xl, k)[tid];
            gst[tid].y = 1.0f / l;
          }
        } else {
          for (int bm = warp; bm < nb; bm += THREADS / 32) {
            const float* row = sc + bm * SCW;
            float m = -INFINITY;
            for (int p = lane; p < S; p += 32) m = fmaxf(m, row[p]);
            m = warp_max(m);
            float l = 0.0f;
            for (int p = lane; p < S; p += 32) l += expf(row[p] - m);
            l = warp_sum(l);
            if (lane == 0) gst[bm] = make_float2(m, 1.0f / l);
          }
        }
        __syncthreads();
#pragma unroll
        for (int bm = 0; bm < NB; ++bm) {  // normalised, then rounded to bf16; 0 past S
          if (bm >= nb) break;
          const float2 ml = gst[bm];
          for (int pos = tid; pos < nt * TP; pos += THREADS)
            pt[bm * PW + pos] =
                __float2bfloat16(pos < sl ? expf(sc[bm * SCW + pos] - ml.x) * ml.y : 0.0f);
        }
      }
    } else {
      // 4. P V of positions (j - nt) TP .. + 63: A = V rows 16w .. 16w + 15
      uint32_t base;
      if (INT8) {  // this warp's 16 V rows, as bf16 rows of 64
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = lane >> 1, c = 2 * (lane & 1) + i;  // 16 rows x 4 pieces of 16
          int8x16_to_bf16(cur + (16 * warp + row) * RB + 16 * c, strip + row * RBT + 32 * c);
        }
        __syncwarp();
        base = smem_u32(strip) + (r + 8 * (mi & 1)) * RBT + 16 * (mi >> 1);
      } else {
        base = smem_u32(cur) + (16 * warp + r + 8 * (mi & 1)) * RBT + 16 * (mi >> 1);
      }
      const uint32_t pb = real ? pbase + 2 * (j - nt) * TP : pbase;
#pragma unroll
      for (int kk = 0; kk < TP / 16; ++kk) {
        uint32_t a[4], b0, b1;
        ldsm_x4(base + 32 * kk, a);
        ldsm_x2(real ? pb + 32 * kk : pb, b0, b1);
        mma_bf16(o, a, b0, b1);
      }
    }
  }

  if constexpr (SPLIT) {  // the ranks' partial sums, added by rank 0 in rank order
    cg::cluster_group cluster = cg::this_cluster();
    *reinterpret_cast<float4*>(xo + 4 * tid) = make_float4(o[0], o[1], o[2], o[3]);
    cluster.sync();  // every rank's partials are in
    if (rank == 0) {
      float4 a = *reinterpret_cast<const float4*>(xo + 4 * tid);
      for (int k = 1; k < nsplit; ++k) {
        const float4 e = *reinterpret_cast<const float4*>(cluster.map_shared_rank(xo, k) + 4 * tid);
        a.x += e.x;
        a.y += e.y;
        a.z += e.z;
        a.w += e.w;
      }
      o[0] = a.x;
      o[1] = a.y;
      o[2] = a.z;
      o[3] = a.w;
    }
    cluster.sync();  // no rank leaves while rank 0 still reads its partials
    if (rank != 0) return;
  }

  // 5. the head output, times the V scale (int8)
  const int ch = 16 * warp + g;
  const float s0 = vs != nullptr ? vss[ch] : 1.0f, s8 = vs != nullptr ? vss[ch + 8] : 1.0f;
  __nv_bfloat16* ob = out + row0 * D + h * HD + ch;
  if (2 * t < nb) {
    ob[2 * t * D] = __float2bfloat16(o[0] * s0);
    ob[2 * t * D + 8] = __float2bfloat16(o[2] * s8);
  }
  if (2 * t + 1 < nb) {
    ob[(2 * t + 1) * D] = __float2bfloat16(o[1] * s0);
    ob[(2 * t + 1) * D + 8] = __float2bfloat16(o[3] * s8);
  }
}

// grid (H, B), block 128: NB beams an item.
template <typename KT, int NB>
__global__ void __launch_bounds__(THREADS)
dec_cross_kernel(const __nv_bfloat16* __restrict__ q, const KT* __restrict__ ck,
                 const KT* __restrict__ cv, const float* __restrict__ ks,
                 const float* __restrict__ vs, const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int H, int S, int vec, float scaling) {
  dec_cross_block<KT, NB, false>(q, ck, cv, ks, vs, bias, out, H, S, NB, vec, scaling);
}

// grid (groups, H, B), block 128: block (g, h, b) takes beams 8g ..
// min(8g + 8, beams) - 1 of item b. Three blocks a SM hold 8 beams' shared
// memory at S = 512; told so, ptxas keeps every value in registers (without
// it the int8 instance spilled).
template <typename KT>
__global__ void __launch_bounds__(THREADS, 3)
dec_cross_kernel_grouped(const __nv_bfloat16* __restrict__ q, const KT* __restrict__ ck,
                         const KT* __restrict__ cv, const float* __restrict__ ks,
                         const float* __restrict__ vs, const float* __restrict__ bias,
                         __nv_bfloat16* __restrict__ out, int H, int S, int beams, int vec,
                         float scaling) {
  dec_cross_block<KT, MAX_BEAMS, true>(q, ck, cv, ks, vs, bias, out, H, S, beams, vec, scaling);
}

// grid (split, H, B) in clusters of (split, 1, 1), block 128: rank r takes
// the r-th share of S for all `beams` <= 8 of an item. Two blocks a SM:
// LED's 16384 positions at 5 int8 beams over 8 ranks take 105 KB each.
template <typename KT>
__global__ void __launch_bounds__(THREADS, 2)
dec_cross_kernel_split(const __nv_bfloat16* __restrict__ q, const KT* __restrict__ ck,
                       const KT* __restrict__ cv, const float* __restrict__ ks,
                       const float* __restrict__ vs, const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, int H, int S, int beams, int vec,
                       float scaling) {
  dec_cross_block<KT, MAX_BEAMS, false, true>(q, ck, cv, ks, vs, bias, out, H, S, beams, vec,
                                              scaling);
}

// grid (H, B), block 128: all `beams` of an item, 8 (G - 1) < beams <= 8 G,
// as G n8 operands. G = 2 asks ptxas for the registers of four blocks a SM
// (9-16 int8 beams fit four in shared memory at S = 512), G = 3 for three.
template <typename KT, int G>
__global__ void __launch_bounds__(THREADS, G == 2 ? 4 : 3)
dec_cross_kernel_wide(const __nv_bfloat16* __restrict__ q, const KT* __restrict__ ck,
                      const KT* __restrict__ cv, const float* __restrict__ ks,
                      const float* __restrict__ vs, const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int H, int S, int beams, int vec,
                      float scaling) {
  constexpr int EB = sizeof(KT);
  constexpr bool INT8 = EB == 1;
  constexpr int R = ring_slots(EB);
  constexpr int RB = row_bytes(TP, EB);  // a row of a tile as copied
  constexpr int SLOT = HD * RB;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t row0 = static_cast<size_t>(b) * beams;  // the item's first q row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;   // mma lane naming
  const int mi = lane >> 3, r = lane & 7;  // the ldmatrix matrix and row this lane points at
  const int D = H * HD;
  const size_t head = static_cast<size_t>(b) * H + h;
  const int nt = (S + TP - 1) / TP, sp = nt * TP;
  const int SCW = sp + 4;  // floats a row of scores
  const int PW = 2 * SCW;  // bf16 a row of probabilities: over the row's scores
  unsigned char* ring = smem;                                     // [R][64][RB]
  float* sc = reinterpret_cast<float*>(ring + R * SLOT);          // [beams][SCW]
  __nv_bfloat16* pt = reinterpret_cast<__nv_bfloat16*>(sc);       // [beams][PW]
  unsigned char* zero16 = reinterpret_cast<unsigned char*>(sc + beams * SCW);
  float* vss = reinterpret_cast<float*>(zero16 + 16);  // [64] V scales
  float* wmax = vss + HD;                              // [4][beams] each warp's score maxima
  const KT* kg = ck + head * HD * S;
  const KT* vg = cv + head * HD * S;
  const float* bg = bias + static_cast<size_t>(b) * S;

  // tile j of K_0 .. K_{nt-1}, V_0 .. V_{nt-1} into ring slot j % R: one
  // cp.async group a tile (an empty one past the end keeps the count)
  auto fetch = [&](int j) {
    if (j < 2 * nt) {
      const int jt = j < nt ? j : j - nt;
      const KT* src = (j < nt ? kg : vg) + jt * TP;
      unsigned char* dst = ring + (j % R) * SLOT;
      const int n = min(TP, S - jt * TP);
      if (vec && n == TP) {
        constexpr int CPR = TP * EB / 16;  // 16-byte pieces of a row
        const int c = tid % CPR;
#pragma unroll
        for (int row = tid / CPR; row < HD; row += THREADS / CPR)
          cp_async16(smem_u32(dst + row * RB + 16 * c),
                     reinterpret_cast<const unsigned char*>(src + static_cast<size_t>(row) * S) +
                         16 * c);
      } else if (vec) {
        const int chunks = n * EB / 16;
        for (int i = tid; i < HD * chunks; i += THREADS) {
          const int row = i / chunks, c = i - row * chunks;
          cp_async16(smem_u32(dst + row * RB + 16 * c),
                     reinterpret_cast<const unsigned char*>(src + static_cast<size_t>(row) * S) +
                         16 * c);
        }
      } else {
        for (int i = tid; i < HD * n; i += THREADS) {
          const int row = i / n, p = i - row * n;
          reinterpret_cast<KT*>(dst + row * RB)[p] = src[static_cast<size_t>(row) * S + p];
        }
      }
      const int tail = (TP - n) * EB;  // past S: zero, so 0 * V stays 0
      for (int i = tid; i < HD * tail; i += THREADS) {
        const int row = i / tail;
        dst[row * RB + n * EB + (i - row * tail)] = 0;
      }
    }
    cp_async_commit();
  };

  // 1. R - 1 tiles go out; q comes straight into the B operands meanwhile:
  // beam 8 gi + g at the channel pairs of k-step kk, rounded as a block of
  // <= 8 beams rounds it (zero past the item's beams)
#pragma unroll
  for (int j = 0; j < R - 1; ++j) fetch(j);
  uint32_t qf[G][4][2];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const int bm = 8 * gi + g;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c = 16 * kk + 2 * t + 8 * hf;
        float v0 = 0.0f, v1 = 0.0f;
        if (bm < beams) {
          const uint32_t q2 =
              *reinterpret_cast<const uint32_t*>(q + (row0 + bm) * D + h * HD + c);
          v0 = bf16_round(__uint_as_float(q2 << 16) * scaling);
          v1 = bf16_round(__uint_as_float(q2 & 0xFFFF0000u) * scaling);
          if (ks != nullptr) {
            const float2 k2 = *reinterpret_cast<const float2*>(ks + head * HD + c);
            v0 = bf16_round(v0 * k2.x);
            v1 = bf16_round(v1 * k2.y);
          }
        }
        qf[gi][kk][hf] = pack_bf16(v0, v1);  // bf16 values already: exact
      }
    }
  }
  if (tid < HD / 4) {
    float4 v4s = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    if (vs != nullptr) v4s = *reinterpret_cast<const float4*>(vs + head * HD + 4 * tid);
    *reinterpret_cast<float4*>(vss + 4 * tid) = v4s;
  }
  if (tid < 4) reinterpret_cast<uint32_t*>(zero16)[tid] = 0u;

  // 2. the tiles, one block barrier each
  float o[G][4];  // group gi: channels 16w + g (+ 8) x beams 8 gi + 2t, + 1
  float mx[G][2];  // the largest score so far of beams 8 gi + 2t, + 1 at this lane's positions
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    o[gi][0] = o[gi][1] = o[gi][2] = o[gi][3] = 0.0f;
    mx[gi][0] = mx[gi][1] = -INFINITY;
  }
  for (int j = 0; j < 2 * nt; ++j) {
    cp_async_wait<R - 2>();  // this thread's copies of tile j have landed
    __syncthreads();         // everyone's; and everyone is done with tile j - 1
    fetch(j + R - 1);        // into the slot tile j - 1 left
    const unsigned char* cur = ring + (j % R) * SLOT;
    if (j < nt) {
      // scores of positions j TP + 16w .. + 15: A = K^T (rows = positions),
      // loaded once for every group. bf16: ldmatrix.trans, row g (g + 8) =
      // position g (g + 8). int8: ldmatrix.trans of byte pairs, so a lane
      // holds channels 2t, 2t + 1 at positions 2g, 2g + 1 of a matrix of
      // eight channels; rows g and g + 8 are positions 2g and 2g + 1, each
      // row's 16 channels in the k slots of the bf16 kernel's.
      uint32_t a[4][4];
      if (INT8) {
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2) {  // channels 32 k2 .. + 31: two k-steps
          uint32_t w[4];
          ldsm_x4_trans(smem_u32(cur) + (32 * k2 + 8 * mi + r) * RB + 16 * warp, w);
#pragma unroll
          for (int m = 0; m < 4; ++m) {  // eight channels: a0 / a1 (m even) or a2 / a3
            const uint2 v = quad_to_bf16(__byte_perm(w[m], 0u, 0x3120));
            a[2 * k2 + (m >> 1)][2 * (m & 1)] = v.x;      // position 2g
            a[2 * k2 + (m >> 1)][2 * (m & 1) + 1] = v.y;  // position 2g + 1
          }
        }
      } else {
        const uint32_t base =
            smem_u32(cur) + (r + 8 * (mi >> 1)) * RB + 2 * (16 * warp + 8 * (mi & 1));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) ldsm_x4_trans(base + kk * 16 * RB, a[kk]);
      }
      int pos[2];
      float bb[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        pos[hh] = j * TP + 16 * warp + (INT8 ? 2 * g + hh : g + 8 * hh);
        bb[hh] = pos[hh] < S ? __ldg(bg + pos[hh]) : 0.0f;
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) mma_bf16(d, a[kk], qf[gi][kk][0], qf[gi][kk][1]);
        const int c0 = 8 * gi + 2 * t;  // this lane's two beams
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const bool inside = pos[hh] < S;
          const float s0 = d[2 * hh] + bb[hh], s1 = d[2 * hh + 1] + bb[hh];
          if (inside) {
            mx[gi][0] = fmaxf(mx[gi][0], s0);
            mx[gi][1] = fmaxf(mx[gi][1], s1);
          }
          if (c0 < beams) sc[c0 * SCW + pos[hh]] = inside ? s0 : -INFINITY;
          if (c0 + 1 < beams) sc[(c0 + 1) * SCW + pos[hh]] = inside ? s1 : -INFINITY;
        }
      }
      if (j == nt - 1) {  // 3. softmax over all S, a warp a beam, then its probabilities
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {  // the warp's maxima: over g, then one lane a t
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int bm = 8 * gi + 2 * t + e;
            float m = mx[gi][e];
#pragma unroll
            for (int off = 4; off < 32; off <<= 1)
              m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
            if (g == 0 && bm < beams) wmax[warp * beams + bm] = m;
          }
        }
        __syncthreads();
        for (int bm = warp; bm < beams; bm += THREADS / 32) {
          float* row = sc + bm * SCW;
          const float m = fmaxf(fmaxf(wmax[bm], wmax[beams + bm]),
                                fmaxf(wmax[2 * beams + bm], wmax[3 * beams + bm]));
          float l = 0.0f;
          for (int p = lane; p < S; p += 32) {  // each exp kept for the normalisation
            const float e = expf(row[p] - m);
            row[p] = e;
            l += e;
          }
          l = warp_sum(l);
          const float inv = 1.0f / l;  // the same on every lane: the butterfly's sums commute
          __nv_bfloat16* prow = pt + bm * PW;
          // normalised, then rounded to bf16; 0 past S. Positions c .. c +
          // 31 land on the floats of c / 2 .. c / 2 + 15, all read by this
          // chunk or an earlier one
          for (int c = 0; c < sp; c += 32) {
            const int p = c + lane;
            const float v = p < S ? row[p] * inv : 0.0f;
            __syncwarp();
            prow[p] = __float2bfloat16(v);
          }
        }
      }
    } else {
      // 4. P V of positions (j - nt) TP .. + 63: A = V rows 16w .. 16w + 15
      // (channels), read once for every group. int8: a lane reads its own
      // byte pairs (positions 2t, 2t + 1 and 2t + 8, 2t + 9 of rows g and
      // g + 8) and turns them into its operand registers.
      const int p0 = (j - nt) * TP + 8 * (mi & 1);
#pragma unroll
      for (int kk = 0; kk < TP / 16; ++kk) {
        uint32_t a[4];
        if (INT8) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {  // rows g, g + 8: a0 / a2, a1 / a3
            const unsigned char* vr = cur + (16 * warp + g + 8 * hr) * RB + 16 * kk + 2 * t;
            const uint32_t lo = *reinterpret_cast<const unsigned short*>(vr);
            const uint32_t hi = *reinterpret_cast<const unsigned short*>(vr + 8);
            const uint2 v = quad_to_bf16(lo | (hi << 16));
            a[hr] = v.x;
            a[2 + hr] = v.y;
          }
        } else {
          ldsm_x4(smem_u32(cur) + (16 * warp + r + 8 * (mi & 1)) * RB + 16 * (mi >> 1) + 32 * kk,
                  a);
        }
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {  // B: the probabilities of beam 8 gi + r, or a zero row
          const int bm = 8 * gi + r;
          uint32_t b0, b1;
          ldsm_x2(bm < beams ? smem_u32(pt) + (bm * PW + p0 + 16 * kk) * 2 : smem_u32(zero16),
                  b0, b1);
          mma_bf16(o[gi], a, b0, b1);
        }
      }
    }
  }

  // 5. the head output, times the V scale (int8; 1 for bf16)
  const int ch = 16 * warp + g;
  const float s0 = vss[ch], s8 = vss[ch + 8];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const int c0 = 8 * gi + 2 * t;
    __nv_bfloat16* ob = out + (row0 + c0) * D + h * HD + ch;
    if (c0 < beams) {
      ob[0] = __float2bfloat16(o[gi][0] * s0);
      ob[8] = __float2bfloat16(o[gi][2] * s8);
    }
    if (c0 + 1 < beams) {
      ob[D] = __float2bfloat16(o[gi][1] * s0);
      ob[D + 8] = __float2bfloat16(o[gi][3] * s8);
    }
  }
}

struct Args {
  const void *q, *ck, *cv;
  const float *ks, *vs, *bias;
  __nv_bfloat16* out;
  int B, beams, groups, H, S;
  long long smem;  // the plan's bytes a block
  float scaling;
  cudaStream_t stream;
};

// NB beams an item (GROUPED: groups of NB = 8 beams, a block a group). The
// launch is the caller's plan (kernels/primitives.dec_cross_plan): its
// groups make the grid and its bytes the block's shared memory, refused
// where they are not this instance's.
template <typename KT, int NB, bool GROUPED = false>
int launch(const Args& a) {
  constexpr int EB = sizeof(KT);
  const long long smem = smem_bytes(NB, a.S, EB);
  if (smem > MAX_SMEM || a.smem != smem || a.groups != (a.beams + NB - 1) / NB ||
      (!GROUPED && a.groups != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  static device_state::PerDevice configured;  // the shared-memory limit, raised once a device
  const int vec = (a.S * EB) % 16 == 0 && reinterpret_cast<uintptr_t>(a.ck) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.cv) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.bias) % 16 == 0;
  const auto* q = reinterpret_cast<const __nv_bfloat16*>(a.q);
  const auto* ck = reinterpret_cast<const KT*>(a.ck);
  const auto* cv = reinterpret_cast<const KT*>(a.cv);
  if constexpr (GROUPED) {
    auto kernel = dec_cross_kernel_grouped<KT>;
    const cudaError_t e = device_state::allow_smem(kernel, MAX_SMEM, configured);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<dim3(a.groups, a.H, a.B), THREADS, static_cast<size_t>(smem),
             a.stream>>>(q, ck, cv, a.ks, a.vs, a.bias, a.out, a.H, a.S, a.beams, vec,
                         a.scaling);
  } else {
    auto kernel = dec_cross_kernel<KT, NB>;
    const cudaError_t e = device_state::allow_smem(kernel, MAX_SMEM, configured);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<dim3(a.H, a.B), THREADS, static_cast<size_t>(smem), a.stream>>>(
        q, ck, cv, a.ks, a.vs, a.bias, a.out, a.H, a.S, vec, a.scaling);
  }
  return static_cast<int>(cudaGetLastError());
}

// All beams of an item in one block, G n8 operands (wide). The plan's
// bytes must be this instance's and its grid one block an (item, head).
template <typename KT, int G>
int launch_wide(const Args& a) {
  constexpr int EB = sizeof(KT);
  const long long smem = wide_smem_bytes(a.beams, a.S, EB);
  if (smem > MAX_SMEM || a.smem != smem || a.groups != 1 ||
      (a.beams + MAX_BEAMS - 1) / MAX_BEAMS != G)
    return static_cast<int>(cudaErrorInvalidValue);
  static device_state::PerDevice configured;  // the shared-memory limit, raised once a device
  const int vec = (a.S * EB) % 16 == 0 && reinterpret_cast<uintptr_t>(a.ck) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.cv) % 16 == 0;
  auto kernel = dec_cross_kernel_wide<KT, G>;
  const cudaError_t e = device_state::allow_smem(kernel, MAX_SMEM, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(a.H, a.B), THREADS, static_cast<size_t>(smem), a.stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(a.q), reinterpret_cast<const KT*>(a.ck),
      reinterpret_cast<const KT*>(a.cv), a.ks, a.vs, a.bias, a.out, a.H, a.S, a.beams, vec,
      a.scaling);
  return static_cast<int>(cudaGetLastError());
}

// S over a cluster of `groups` = 2, 4 or 8 blocks an (item, head), <= 8
// beams (split). The plan's bytes must be this split's, and every rank
// must hold positions.
template <typename KT>
int launch_split(const Args& a) {
  constexpr int EB = sizeof(KT);
  const int split = a.groups;
  if (a.beams > MAX_BEAMS || (split != 2 && split != 4 && split != MAX_SPLIT))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = split_smem_bytes(a.beams, a.S, EB, split);
  if (smem > MAX_SMEM || a.smem != smem || (split - 1) * split_positions(a.S, split) >= a.S)
    return static_cast<int>(cudaErrorInvalidValue);
  static device_state::PerDevice configured;  // the shared-memory limit, raised once a device
  const int vec = (a.S * EB) % 16 == 0 && reinterpret_cast<uintptr_t>(a.ck) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.cv) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.bias) % 16 == 0;
  auto kernel = dec_cross_kernel_split<KT>;
  cudaError_t e = device_state::allow_smem(kernel, MAX_SMEM, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, a.H, a.B);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, reinterpret_cast<const __nv_bfloat16*>(a.q),
                         reinterpret_cast<const KT*>(a.ck), reinterpret_cast<const KT*>(a.cv),
                         a.ks, a.vs, a.bias, a.out, a.H, a.S, a.beams, vec, a.scaling);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The plan's variant (kernels/primitives.DEC_CROSS_VARIANTS: 0 beams, 1
// wide, 2 grouped, 3 split) -> its instance; anything else is refused.
template <typename KT>
int launch_variant(int variant, const Args& a) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (variant == 0) {
    switch (a.beams) {
      case 1: return launch<KT, 1>(a);
      case 2: return launch<KT, 2>(a);
      case 3: return launch<KT, 3>(a);
      case 4: return launch<KT, 4>(a);
      case 5: return launch<KT, 5>(a);
      case 6: return launch<KT, 6>(a);
      case 7: return launch<KT, 7>(a);
      case 8: return launch<KT, 8>(a);
      default: return invalid;
    }
  }
  if (variant == 1) {
    switch ((a.beams + MAX_BEAMS - 1) / MAX_BEAMS) {
      case 2: return launch_wide<KT, 2>(a);
      case 3: return launch_wide<KT, 3>(a);
      default: return invalid;
    }
  }
  if (variant == 2 && a.beams > MAX_BEAMS) return launch<KT, MAX_BEAMS, true>(a);
  if (variant == 3) return launch_split<KT>(a);
  return invalid;
}

}  // namespace

// q [B*beams, H*64] bf16, ck/cv [B, H, 64, S] int8 (is_int8) or bf16,
// ks/vs [B, H, 64] f32 (int8 only, else NULL), bias [B, S] f32,
// out [B*beams, H*64] bf16. beams >= 1; q 8-byte and the scales 16-byte
// aligned. variant, groups and smem are kernels/primitives.dec_cross_plan's:
// the instance (beams: 1-8 beams, one block an (item, head); wide: 9-24,
// one block an (item, head) for all; grouped: past 8, a block a group of
// 8; split: 1-8 beams, S over a cluster of `groups` blocks), the blocks an
// (item, head) and the dynamic shared memory of a block.
// A plan that is not the instance's, a block that would need more than 227
// KB of shared memory, or anything else out of range, is refused with
// cudaErrorInvalidValue.
extern "C" int vt_dec_cross_attention(const void* q, const void* ck, const void* cv,
                                      const void* ks, const void* vs, const void* bias, void* out,
                                      int B, int beams, int variant, int groups, int smem, int H,
                                      int S, int is_int8, float scaling, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || H < 1 || S < 1 || beams < 1 || groups < 1 || B > 65535 || H > 65535)
    return invalid;
  if (reinterpret_cast<uintptr_t>(q) % 8 || reinterpret_cast<uintptr_t>(ks) % 16 ||
      reinterpret_cast<uintptr_t>(vs) % 16)
    return invalid;
  const Args a = {q, ck, cv, reinterpret_cast<const float*>(ks), reinterpret_cast<const float*>(vs),
                  reinterpret_cast<const float*>(bias), reinterpret_cast<__nv_bfloat16*>(out),
                  B, beams, groups, H, S, smem, scaling, reinterpret_cast<cudaStream_t>(stream)};
  return is_int8 ? launch_variant<int8_t>(variant, a) : launch_variant<__nv_bfloat16>(variant, a);
}

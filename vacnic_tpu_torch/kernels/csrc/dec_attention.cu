// Decoder self-attention of one beam-search step (one query row per beam row)
// over a bf16, int8 or fp8 (e4m3) self cache.
//
// Replaces: the self-attention phase of vacnic_tpu/kernels/decode_layer.py:
//   _kernel (_self_attn, decode_layer.py:314; the int8 scales :393-409 and
//   :454-462, the fp8 store :330-339) -- attention over the time-major,
//   write-once cache [T, BK, D], whose step-t row for beam row c lives in
//   physical row anc[t, c]. (Its cross-attention phase is
//   dec_cross_attention.cu.)
// Semantics (the plain twin's, kernels/primitives.dec_self_attention_plain):
//   q is rounded to bf16 after the head_dim**-0.5 scaling; rows t < pos come
//   from the cache, row pos from this step's QKV output at full precision;
//   scores and the softmax are f32; the normalised probabilities are rounded
//   to bf16 before the value sum, which is f32; the head output is bf16.
//   int8 rows: s_t = (q . K_t) * sk[t, anc[t, c], h] and
//   o += (p_t * sv[t, anc[t, c], h]) * V_t. fp8 rows convert exactly to f32
//   and take the bf16 recipe.
//
// Bound on the H100 at the main path (BK = 160, H = 16, hd = 64, T = 64):
//   bytes. The K and V rows the ancestry reaches, once each: ~22 MB in bf16
//   at pos = 49 (~6.8 us at 3.35 TB/s), half of it in int8 or fp8 (int8 adds
//   its scales, 1/32 of the rows' bytes).
// Design: one warp a (beam row, head), four of them a block (one row, four
//   heads), blockIdx.x the row, so that the beams of one item, which share
//   ancestors, run side by side and meet in L2. A head's 64 channels of a
//   row are 128 bytes (bf16) or 64 (int8, fp8): eight lanes take a row, lane
//   (g, c) = (lane / 8, lane % 8) holds channels 8c .. 8c + 7 of the rows
//   t = g, g + 4, g + 8, ..., one 16- or 8-byte load each, so one load
//   instruction of the warp reads four rows. A score is a sum over the
//   row's eight lanes (three shuffles). A warp shares nothing with the
//   others: no block barrier. What bounds it, measured, is the chain of
//   dependent round trips, so every row is asked for as soon as its address
//   is known:
//   - q and the step's own K and V rows are loaded first, with the warp's
//     copy of the ancestry column anc[0 .. pos - 1, c] into shared memory.
//   - Then all its K rows to registers (13 a lane in bf16, 16 in int8 and
//     fp8: one round up to pos 52 or 64), and its V rows, 64 positions at a
//     time, to shared memory by cp.async, each lane copying the bytes it
//     will read itself; the V rows land while the scores and the softmax
//     run.
//   - Scores go to the warp's shared memory [T]; the softmax's max and sum
//     are warp reductions, and bf16(p) replaces each score; the V pass takes
//     eight f32 sums a lane; the four row groups' partial outputs meet by
//     two shuffles in a fixed order, so a repeated call is bit-identical.
//   - int8 -> f32 exactly: byte ^ 0x80 as the low byte of 2^23's bits, minus
//     2^23 + 128. fp8 -> f16 by one cvt for two values (exact), -> f32.
//   The step's own row (t == pos) is taken by row group pos % 4 after its
//   cached rows, in bf16 and unscaled, and every instance has the same lane
//   layout and order of sums: so an int8 cache with power-of-two scales
//   gives the bf16 instance's result on the dequantized cache bit for bit
//   (every product and sum is the same one, scaled by a power of two).
// Measured against it and not kept (PERF.md): a block a (row, four heads)
//   with the four warps splitting t, a softmax phase and a cross-warp
//   combine between block barriers, with V in registers or staged by
//   cp.async.
// Tensor cores have nothing to do: each (row, head) is a product of one
// query with rows gathered through its own ancestry.

#include <math.h>
#include <stdint.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "device_state.cuh"

namespace {

constexpr int HD = 64;
constexpr int THREADS = 128;          // four warps, a head each
constexpr int HEADS = 4;              // heads a block
constexpr int GROUPS = 4;             // rows a load instruction of a warp reads
constexpr int VCAP = 64;              // V positions a warp stages at a time
constexpr int MAX_T = 4096;

// Dynamic shared memory of a block (kernels/primitives.dec_self_smem_bytes),
// for each of the four warps, rounded up to 16 bytes: staged V rows
// [VCAP][64] of the cache's type, their int8 scales [VCAP] f32, scores [T]
// f32, ancestry [T] int32.
__host__ __device__ constexpr int warp_smem_bytes(int T, int elem_bytes) {
  return (VCAP * HD * elem_bytes + 4 * VCAP + 8 * T + 15) / 16 * 16;
}
__host__ __device__ constexpr int smem_bytes(int T, int elem_bytes) {
  return HEADS * warp_smem_bytes(T, elem_bytes);
}

// Asynchronous copy of N bytes (4, 8 or 16) global -> shared.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(N)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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

// A head's sum over its eight lanes, every lane of the eight holding it.
__device__ __forceinline__ float head_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float dot8(const float (&q)[8], const float (&k)[8]) {
  float s = q[0] * k[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) s = fmaf(q[j], k[j], s);
  return s;
}

// Eight channels of a row: how they are loaded and turned into f32.
template <typename KT> struct Row;

template <> struct Row<__nv_bfloat16> {
  using Raw = uint4;
  static constexpr bool kScaled = false;
  static constexpr int kRows = 13;  // K rows a lane has in flight
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void cvt(const Raw& r, float (&f)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <> struct Row<int8_t> {
  using Raw = uint2;
  static constexpr bool kScaled = true;
  static constexpr int kRows = 16;
  static __device__ __forceinline__ Raw load(const int8_t* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ void cvt(const Raw& r, float (&f)[8]) {
    const uint32_t w[2] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * i + j] = __int_as_float(__byte_perm(w[i], 0x4B000000u, 0x7650u | j)) - 8388736.0f;
    }
  }
};

template <> struct Row<__nv_fp8_e4m3> {
  using Raw = uint2;
  static constexpr bool kScaled = false;
  static constexpr int kRows = 16;
  static __device__ __forceinline__ Raw load(const __nv_fp8_e4m3* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ void cvt(const Raw& r, float (&f)[8]) {
    const uint32_t w[2] = {r.x, r.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
            static_cast<__nv_fp8x2_storage_t>(w[i] >> (16 * j)), __NV_E4M3);
        const float2 v = __half22float2(__half2(h));
        f[4 * i + 2 * j] = v.x;
        f[4 * i + 2 * j + 1] = v.y;
      }
    }
  }
};

// grid (BK, H / 4), block 128, warp w: head blockIdx.y * 4 + w of row
// blockIdx.x. Rows t < pos from the cache through anc, row pos from qkv;
// ks/vs [T, BK, H] f32 for an int8 cache, else unused.
template <typename KT>
__global__ void __launch_bounds__(THREADS, 5)
dec_self_kernel(const __nv_bfloat16* __restrict__ qkv, const KT* __restrict__ ck,
                const KT* __restrict__ cv, const float* __restrict__ ks,
                const float* __restrict__ vs, const int32_t* __restrict__ anc,
                __nv_bfloat16* __restrict__ out, int BK, int T, int H, int pos, float scaling) {
  using R = Row<KT>;
  using Raw = typename R::Raw;
  using B16 = Row<__nv_bfloat16>;
  constexpr int UK = R::kRows;
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* base =
      reinterpret_cast<unsigned char*>(smem4) + warp * warp_smem_bytes(T, sizeof(KT));
  KT* vst = reinterpret_cast<KT*>(base);                            // [VCAP][64]
  float* vsc = reinterpret_cast<float*>(vst + VCAP * HD);           // [VCAP]
  float* sc = vsc + VCAP;                                           // [T]
  int* anc_s = reinterpret_cast<int*>(sc + T);                      // [T]
  const int row = blockIdx.x, h = blockIdx.y * HEADS + warp;
  const int D = H * HD;
  const int g = lane >> 3, c = lane & 7;  // row group, channel chunk
  const int col = h * HD + 8 * c;
  const bool own = g == (pos & 3);        // this group takes the step's own row
  const __nv_bfloat16* qrow = qkv + static_cast<size_t>(row) * 3 * D + col;

  const uint4 q_raw = B16::load(qrow);
  uint4 kn_raw = make_uint4(0, 0, 0, 0), vn_raw = kn_raw;
  if (own) {
    kn_raw = B16::load(qrow + D);
    vn_raw = B16::load(qrow + 2 * D);
  }
  for (int t = lane; t < pos; t += 32) anc_s[t] = __ldg(anc + static_cast<size_t>(t) * BK + row);
  float q[8];
  B16::cvt(q_raw, q);
#pragma unroll
  for (int j = 0; j < 8; ++j) q[j] = bf16_round(q[j] * scaling);
  __syncwarp();

  // the lane's K rows t = g + 4u for u in [u0, u0 + UK), with their scales;
  // zero past pos, so that every lane takes part in every shuffle
  Raw kr[UK];
  float kss[UK];
  auto fetch_k = [&](int u0) {
#pragma unroll
    for (int u = 0; u < UK; ++u) {
      if (GROUPS * (u0 + u) >= pos) break;  // no group has a row here
      const int t = g + GROUPS * (u0 + u);
      Raw raw = {};
      float sk = 0.0f;
      if (t < pos) {
        const size_t r = static_cast<size_t>(t) * BK + anc_s[t];
        raw = R::load(ck + r * D + col);
        if constexpr (R::kScaled) sk = __ldg(ks + r * H + h);
      }
      kr[u] = raw;
      kss[u] = sk;
    }
  };
  // the lane's chunk of its V rows among positions t0 .. t0 + VCAP - 1
  auto stage_v = [&](int t0) {
    const int end = min(pos, t0 + VCAP);
    for (int t = t0 + g; t < end; t += GROUPS) {
      const size_t r = static_cast<size_t>(t) * BK + anc_s[t];
      cp_async<8 * sizeof(KT)>(vst + (t - t0) * HD + 8 * c, cv + r * D + col);
      if constexpr (R::kScaled) {
        if (c == 0) cp_async<4>(vsc + (t - t0), vs + r * H + h);
      }
    }
    cp_async_commit();
  };

  fetch_k(0);
  stage_v(0);  // V's rows fly during the scores and the softmax
  for (int u0 = 0; GROUPS * u0 < pos; u0 += UK) {
    if (u0 > 0) fetch_k(u0);
#pragma unroll
    for (int u = 0; u < UK; ++u) {
      if (GROUPS * (u0 + u) < pos) {  // the same for every lane: row group 0 has a row
        const int t = g + GROUPS * (u0 + u);
        float k[8];
        R::cvt(kr[u], k);
        float s = head_sum(dot8(q, k));
        if constexpr (R::kScaled) s *= kss[u];
        if (c == 0 && t < pos) sc[t] = s;
      }
    }
  }
  {  // the step's own key, at full precision (zero in the other groups)
    float k[8];
    B16::cvt(kn_raw, k);
    const float s = head_sum(dot8(q, k));
    if (own && c == 0) sc[pos] = s;
  }
  __syncwarp();

  {  // the softmax over t <= pos, exact, bf16(p) in place
    float m = -INFINITY;
    for (int t = lane; t <= pos; t += 32) m = fmaxf(m, sc[t]);
    m = warp_max(m);
    float l = 0.0f;
    for (int t = lane; t <= pos; t += 32) l += expf(sc[t] - m);
    const float inv = 1.0f / warp_sum(l);
    for (int t = lane; t <= pos; t += 32) sc[t] = bf16_round(expf(sc[t] - m) * inv);
  }
  __syncwarp();

  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
  for (int t0 = 0; t0 < pos; t0 += VCAP) {
    if (t0 > 0) {
      __syncwarp();  // every lane is done with the slots it restages, lane c = 0 with the scales
      stage_v(t0);
    }
    cp_async_wait_all();
    if constexpr (R::kScaled) __syncwarp();  // lane c = 0 copied the scales
    const int end = min(pos, t0 + VCAP);
    for (int t = t0 + g; t < end; t += GROUPS) {
      float v[8];
      R::cvt(*reinterpret_cast<const Raw*>(vst + (t - t0) * HD + 8 * c), v);
      float p = sc[t];
      if constexpr (R::kScaled) p *= vsc[t - t0];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(p, v[j], acc[j]);
    }
  }
  if (own) {  // the step's own value, unscaled
    float v[8];
    B16::cvt(vn_raw, v);
    const float p = sc[pos];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = fmaf(p, v[j], acc[j]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {  // (g0 + g1) + (g2 + g3)
    acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 8);
    acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 16);
  }
  if (g == 0) {
    uint4 o;
    o.x = bf16x2_bits(acc[0], acc[1]);
    o.y = bf16x2_bits(acc[2], acc[3]);
    o.z = bf16x2_bits(acc[4], acc[5]);
    o.w = bf16x2_bits(acc[6], acc[7]);
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * D + col) = o;
  }
}

template <typename KT>
int launch(const void* qkv, const void* ck, const void* cv, const void* ks, const void* vs,
           const void* anc, void* out, int BK, int T, int H, int pos, float scaling,
           cudaStream_t stream) {
  auto kernel = dec_self_kernel<KT>;
  static device_state::PerDevice configured;  // the shared-memory limit, raised once a device
  const cudaError_t e =
      device_state::allow_smem(kernel, smem_bytes(MAX_T, sizeof(KT)), configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(BK, H / HEADS), THREADS, smem_bytes(T, sizeof(KT)), stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(qkv), reinterpret_cast<const KT*>(ck),
      reinterpret_cast<const KT*>(cv), reinterpret_cast<const float*>(ks),
      reinterpret_cast<const float*>(vs), reinterpret_cast<const int32_t*>(anc),
      reinterpret_cast<__nv_bfloat16*>(out), BK, T, H, pos, scaling);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv [BK, 3*H*64] bf16; cache_k/cache_v [T, BK, H*64] (one layer) of the
// kind: 0 bf16, 1 int8 with k_scale/v_scale [T, BK, H] f32, 2 fp8 e4m3;
// anc [T, BK] int32; out [BK, H*64] bf16. Rows t < pos come from the cache
// through anc, row pos from qkv. Needs H % 4 == 0, 0 <= pos < T <= 4096 and
// qkv, the cache and the scales on 16 bytes.
extern "C" int vt_dec_self_attention(const void* qkv, const void* cache_k, const void* cache_v,
                                     const void* k_scale, const void* v_scale, const void* anc,
                                     void* out, int BK, int T, int H, int pos, int kind,
                                     float scaling, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (BK < 1 || H < HEADS || H % HEADS || H / HEADS > 65535 || T < 1 || T > MAX_T || pos < 0 ||
      pos >= T)
    return invalid;
  if ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(cache_k) |
       reinterpret_cast<uintptr_t>(cache_v) | reinterpret_cast<uintptr_t>(k_scale) |
       reinterpret_cast<uintptr_t>(v_scale)) % 16)
    return invalid;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return launch<__nv_bfloat16>(qkv, cache_k, cache_v, nullptr, nullptr, anc, out, BK, T, H,
                                   pos, scaling, s);
    case 1:
      if (k_scale == nullptr || v_scale == nullptr) return invalid;
      return launch<int8_t>(qkv, cache_k, cache_v, k_scale, v_scale, anc, out, BK, T, H, pos,
                            scaling, s);
    case 2:
      return launch<__nv_fp8_e4m3>(qkv, cache_k, cache_v, nullptr, nullptr, anc, out, BK, T, H,
                                   pos, scaling, s);
    default:
      return invalid;
  }
}

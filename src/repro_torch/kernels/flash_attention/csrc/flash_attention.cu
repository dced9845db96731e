// Flash-attention forward for Hopper (sm_90a) on the CUDA cores, bf16 at
// head dims 16 and 32, called through a plain C entry point (ctypes).
//
// Replaces, for bf16 inputs at head dims 16 and 32, the JAX package's
// Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd (body
// `_kernel`): grouped-query attention with an online softmax, optional
// logit soft-cap, causal mask with a query offset, a sliding window given
// as a runtime integer (one build serves local and global layers) and a
// KV-length mask; running max, normaliser and accumulator in f32, output
// in bf16. f32 at every head dim runs flash_attention_tf32.cu, bf16 at
// 64-256 flash_attention_sm90.cu, both on the tensor cores.
//
// What bounds it on the card: operations, run here on the f32 CUDA cores
// (67 TFLOP/s); at these head dims the products are small.
//
// Design, against what the TPU kernel did:
//   * It reads model layout (B, S, H, D) through strides; the Pallas
//     wrapper's transposes only served its BlockSpecs.
//   * One CTA per (query tile of BQ rows, query head, batch). The Pallas
//     grid walked KV blocks in order with the softmax state in VMEM; here
//     the CTA loops over KV tiles staged in shared memory and keeps that
//     state in registers. Query head h reads KV head h / (H / Hkv).
//   * KV tiles that the causal, window or kv_len mask covers entirely for
//     the whole query tile are skipped; the rest are masked per element.
//     Query tiles are handed out heaviest first under a causal mask.
//   * A warp owns RPW query rows, and the accumulator of each row is
//     split across the 32 lanes (lane owns d = lane + 32 j), so a thread
//     holds RPW * max(D / 32, 1) floats, not a row.
//     For the scores a lane owns keys (lane, lane + 32) instead and reads
//     the query rows as shared-memory broadcasts; the probabilities pass
//     between the two layouts through a per-warp shared buffer.
//   * Shared memory: Q (BQ x D), K (BK x (D + 4), padded so the lanes'
//     float4 reads of different keys hit different banks), V (BK x D) and
//     the probabilities, all f32; each instance raises its dynamic limit
//     before launch.
//   * Fully masked rows (no visible key) output 0, as the oracle does.
//   * Tiles are widened to f32 in shared memory; probabilities are
//     rounded to bf16 before the PV product, as the TPU kernel casts p to
//     v's type; the normaliser sums the unrounded p, as it does there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#ifndef FLASH_BLOCK_Q
#define FLASH_BLOCK_Q 64
#endif
#ifndef FLASH_BLOCK_K
#define FLASH_BLOCK_K 64
#endif

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = FLASH_BLOCK_Q;   // query rows per CTA
constexpr int BK = FLASH_BLOCK_K;   // keys per KV tile: two per lane
constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int RPW = BQ / NWARPS;    // query rows per warp
static_assert(BK == 64, "a lane owns keys lane and lane + 32");
static_assert(BQ % NWARPS == 0, "whole rows per warp");

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float round_to_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [row0, row0 + nrows) of a (., D) slab with row stride `rs` into
// shared memory with row stride `ds`, widened to f32; rows >= `limit` are 0.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ds, const bf16* src,
                                          long long rs, int row0, int limit, int nrows) {
  constexpr int G = D / 4;
  for (int i = threadIdx.x; i < nrows * G; i += THREADS) {
    const int r = i / G, c = (i % G) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < limit) val = load4(src + (long long)(row0 + r) * rs + c);
    *reinterpret_cast<float4*>(dst + r * ds + c) = val;
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BQ) * D + size_t(BK) * (D + 4) + size_t(BK) * D
                          + size_t(NWARPS) * RPW * BK);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, bf16* __restrict__ o,
          int S, int Tn, int group,
          long long qsb, long long qss, long long qsh,
          long long ksb, long long kss, long long ksh,
          long long vsb, long long vss, long long vsh,
          long long osb, long long oss, long long osh,
          float scale, float cap, int causal, long long q_offset,
          long long window, long long kv_len) {
  constexpr int KS = D + 4;                 // padded K row stride
  constexpr int DPL = D >= 32 ? D / 32 : 1; // accumulator elements per lane
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * D;
  float* Vs = Ks + BK * KS;
  float* Ps = Vs + BK * D;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int r0 = warp * RPW;
  float* Pw = Ps + warp * RPW * BK;
  const bool lane_has_d = D >= 32 || lane < D;

  load_tile<D>(Qs, D, q + b * qsb + h * qsh, qss, q0, S, BQ);
  const bf16* kb = k + b * ksb + hk * ksh;
  const bf16* vb = v + b * vsb + hk * vsh;

  // keys any row of this tile can see: [kbeg, kend)
  long long kend = Tn < kv_len ? Tn : kv_len;
  const long long qfirst = q_offset + q0;
  const long long qlast = q_offset + (q0 + BQ < S ? q0 + BQ : S) - 1;
  if (causal && qlast + 1 < kend) kend = qlast + 1;
  long long kbeg = qfirst - window + 1;
  if (kbeg < 0) kbeg = 0;
  const int tbeg = kbeg < kend ? (int)(kbeg / BK) : 0;
  const int tend = kbeg < kend ? (int)((kend + BK - 1) / BK) : 0;

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int kt = tbeg; kt < tend; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();    // Q is loaded / the previous tile is consumed
    load_tile<D>(Ks, KS, kb, kss, k0, Tn, BK);
    load_tile<D>(Vs, D, vb, vss, k0, Tn, BK);
    __syncthreads();

    // scores: lane owns keys k0 + lane and k0 + lane + 32
    float s[RPW][2];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(Ks + lane * KS + d);
      const float4 kc = *reinterpret_cast<const float4*>(Ks + (lane + 32) * KS + d);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (r0 + r) * D + d);
        s[r][0] += qv.x * ka.x + qv.y * ka.y + qv.z * ka.z + qv.w * ka.w;
        s[r][1] += qv.x * kc.x + qv.y * kc.y + qv.z * kc.z + qv.w * kc.w;
      }
    }

    // mask, online softmax, probabilities to the warp's buffer
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const long long qpos = qfirst + r0 + r;
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const long long kpos = k0 + lane + 32 * c;
        float x = s[r][c] * scale;
        if (cap > 0.f) x = cap * tanhf(x / cap);
        const bool ok = kpos < Tn && kpos < kv_len && (!causal || kpos <= qpos)
                        && qpos - kpos < window;
        s[r][c] = ok ? x : -INFINITY;
        tmax = fmaxf(tmax, s[r][c]);
      }
      tmax = warp_max(tmax);
      const float m_new = fmaxf(m[r], tmax);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[r] - m_use);
      const float p0 = expf(s[r][0] - m_use);
      const float p1 = expf(s[r][1] - m_use);
      l[r] = alpha * l[r] + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      Pw[r * BK + lane] = round_to_bf16(p0);
      Pw[r * BK + lane + 32] = round_to_bf16(p1);
    }
    __syncwarp();

    // acc += P V: lane owns output dims lane + 32 i
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          vv[jj][i] = lane_has_d ? Vs[(j + jj) * D + lane + 32 * i] : 0.f;
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(Pw + r * BK + j);
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          acc[r][i] += p.x * vv[0][i] + p.y * vv[1][i] + p.z * vv[2][i] + p.w * vv[3][i];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qi = q0 + r0 + r;
    if (qi >= S || !lane_has_d) continue;
    const float den = l[r] == 0.f ? 1.f : l[r];   // fully masked rows -> 0
    bf16* orow = o + b * osb + (long long)qi * oss + h * osh;
#pragma unroll
    for (int i = 0; i < DPL; ++i) orow[lane + 32 * i] = __float2bfloat16(acc[r][i] / den);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Tn, int H, int Hkv, const long long* st, float scale,
           float cap, int causal, long long q_offset, long long window,
           long long kv_len, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, Tn, H / Hkv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale, cap, causal, q_offset, window, kv_len);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q (B, S, H, D), k/v (B, T, Hkv, D), o (B, S, H, D), D 16 or 32.
// strides: q (batch, seq, head), then k, v, o likewise, in elements; the
// head_dim stride is 1. window and kv_len are "no limit" when at least T.
// Returns the CUDA error code (0 = launched).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int Tn, int H, int Hkv, int D, const long long* strides, float scale,
    float cap, int causal, long long q_offset, long long window,
    long long kv_len, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, S, Tn, H, Hkv, strides, scale, cap, causal, q_offset, window, kv_len, s);
    case 32: return launch<32>(q, k, v, o, B, S, Tn, H, Hkv, strides, scale, cap, causal, q_offset, window, kv_len, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Flash-attention forward in f32 on Hopper's tensor cores (sm_90a), 3xTF32,
// called through a plain C entry point (ctypes).
//
// Replaces, for f32 inputs at every head dim (16, 32, 64, 128, 256), the
// JAX package's Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:113 (flash_attention_fwd,
// body `_kernel`): grouped-query attention with an online softmax,
// optional logit soft-cap, causal mask with a query offset, a sliding
// window given as a runtime integer and a KV-length mask; running max,
// normaliser and accumulator in f32, output in f32.
//
// What bounds it on the card: operations. At gemma2-2b widths (D = 256,
// 8 query / 4 KV heads, S = T = 4096, causal) the two products are
// 68.7 GFLOP of f32 work against ~0.1 GB of inputs and output. A single
// TF32 product keeps ~11 bits and misses the reference's 2e-5 bound (by
// ~70x at D = 256), so each f32 product is three TF32 products: with
// hi = x rounded to TF32 and lo = x - hi, a.b ~ lo(a).hi(b) + hi(a).lo(b)
// + hi(a).hi(b), accumulated in f32 (the lo.lo term is below f32's own
// rounding). The least time is 3 x 68.7 GFLOP at the 495 TFLOP/s of the
// TF32 tensor cores: 0.417 ms.
//
// Design:
//   * mma.sync.m16n8k8 tf32 -> f32, not wgmma: tf32 wgmma takes only
//     K-major operands (V would need a transpose) and wants B in shared
//     memory, where the hi and lo halves of K and V would not fit at
//     D = 256. Here each fragment is split into hi and lo in registers
//     after it is loaded, so shared memory holds one f32 copy of each tile.
//     The split is integer arithmetic: hi = (bits + 0x1000) & ~0x1fff
//     (round to nearest TF32, ties away, as cvt.rna does), lo = x - hi
//     (exact in f32) passed as it is, the tensor cores reading its TF32
//     bits. cvt.rna.tf32.f32 compiles to a longer sequence on sm_90, and
//     the split runs on every fragment element of K, V and P.
//   * One CTA of NWARPS warps per (query tile of 16 x NWARPS rows, query
//     head, batch); each warp owns 16 query rows (the MMA's m16). The
//     linear grid hands out query tiles heaviest first across all heads
//     under a causal mask. Query head h reads KV head h / (H / Hkv).
//   * Shared memory: Q (BQ x D), one K tile and one V tile (BK x D), all
//     f32 with rows padded to D + 4 floats (16-byte aligned, and 8
//     consecutive rows start in distinct bank quads). cp.async copies
//     16-byte pieces and zero-fills rows past S or T. As in FlashAttention-2,
//     V(i) is copied while S(i) = Q K(i)^T is computed and K(i + 1) while
//     O += P V(i) is: two barriers per tile, one buffer each. 200 KiB at
//     D = 256 (BK = 32), one CTA per SM.
//   * S = Q K^T: Q and K are K-major, so the A and B fragments come from
//     ldmatrix (b16 view: lane l gets the float at row l / 4, column l % 4
//     of each 8 x 4-float matrix). Three MMAs per fragment pair, small
//     terms first.
//   * Softmax on the accumulator fragment in f32, in log2 units: a thread
//     holds rows g and g + 8 (g = lane / 4), reduced over the 4 lanes of a
//     quad; the normaliser is kept per thread and reduced once at the end.
//     Masks run per element only on tiles that straddle the causal
//     diagonal, the window edge, kv_len or T; a warp skips a tile none of
//     its rows can see, and the CTA never loads a tile none of its rows
//     can. Masked logits are -inf, the row max is taken as 0 while nothing
//     is visible and the normaliser as 1 where it is 0, so fully masked
//     rows come out exactly 0, as in the oracle.
//   * O += P V without a shuffle: the S accumulator gives a thread keys
//     (2t, 2t + 1) of each 8-key block (t = lane % 4), and the A fragment
//     wants k = (t, t + 4); the keys of each block are permuted (k = t is
//     key 2t, k = t + 4 is key 2t + 1) and V's B fragment is loaded with
//     the same permutation, V[2t][n] and V[2t + 1][n] (n = lane / 4), by
//     scalar loads that hit 32 distinct banks at row stride D + 4.
//   * O (16 x D a warp, D / 2 floats a thread) stays in registers; the
//     epilogue divides by the normaliser (IEEE division, so the layout
//     probes' exact results stay exact) and stores float2 pairs.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int BQ = 16 * NWARPS;      // query rows per CTA
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int BK = D >= 256 ? 32 : 64;   // keys per tile
  static constexpr int RS = D + 4;                  // padded row stride, floats
  static constexpr int NB = BK / 8;                 // 8-key blocks per tile
  static constexpr int ND = D / 8;                  // 8-column blocks of O
  static constexpr size_t BYTES = sizeof(float) * size_t(BQ + 2 * BK) * RS;
  static_assert(NB % 2 == 0, "K fragments are loaded two key blocks at a time");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// x ~ hi + lo: hi is x rounded to TF32, lo the rest
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in 3xTF32: the two small terms first, then hi.hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// rows [row0, row0 + nrows) of a (., D) slab with row stride `rs` into
// shared memory with row stride RS; rows >= `limit` are zero-filled.
template <int D, int RS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long rs,
                                          long long row0, long long limit, int nrows) {
  constexpr int G = D / 4;     // 16-byte pieces per row
  for (int i = threadIdx.x; i < nrows * G; i += THREADS) {
    const int r = i / G, c = (i % G) * 4;
    const bool in = row0 + r < limit;
    const float* p = in ? src + (row0 + r) * rs + c : src;
    cp_async16(smem_u32(dst + r * RS + c), p, in ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               int S, int Tn, int H, int group,
               long long qsb, long long qss, long long qsh,
               long long ksb, long long kss, long long ksh,
               long long vsb, long long vss, long long vsh,
               long long osb, long long oss, long long osh,
               float scale, float cap, int causal, long long q_offset,
               long long window, long long kv_len) {
  using L = Tile<D>;
  constexpr int BK = L::BK, RS = L::RS, NB = L::NB, ND = L::ND;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * RS;
  float* Vs = Ks + BK * RS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (S + BQ - 1) / BQ;
  const int bh_count = gridDim.x / nq;
  const int bh = blockIdx.x % bh_count;
  const int q0 = (nq - 1 - (int)(blockIdx.x / bh_count)) * BQ;   // heaviest first
  const int b = bh / H, h = bh % H, hk = h / group;

  load_tile<D, RS>(Qs, q + b * qsb + h * qsh, qss, q0, S, BQ);
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;

  // keys any row of this CTA can see: [kbeg, kend)
  const long long kmax = Tn < kv_len ? Tn : kv_len;
  long long kend = kmax;
  const long long qfirst = q_offset + q0;
  const long long qlast = q_offset + (q0 + BQ < S ? q0 + BQ : S) - 1;
  if (causal && qlast + 1 < kend) kend = qlast + 1;
  long long kbeg = qfirst - window + 1;
  if (kbeg < 0) kbeg = 0;
  const int tbeg = kbeg < kend ? (int)(kbeg / BK) : 0;
  const int tend = kbeg < kend ? (int)((kend + BK - 1) / BK) : 0;

  // this warp's rows: positions [wa, wb]; none when they all lie past S
  const int wrow0 = q0 + warp * 16;
  const bool warp_has_rows = wrow0 < S;
  const long long wa = q_offset + wrow0;
  const long long wb = q_offset + (wrow0 + 16 < S ? wrow0 + 16 : S) - 1;

  // ldmatrix addresses: lane l names row l % 8 of matrix l / 8
  const int mi = lane >> 3, mr = lane & 7;
  const uint32_t q_addr = smem_u32(Qs + (warp * 16 + mr + 8 * (mi & 1)) * RS + 4 * (mi >> 1));
  const uint32_t k_addr = smem_u32(Ks + (mr + 8 * (mi >> 1)) * RS + 4 * (mi & 1));
  const float* v_frag = Vs + (2 * t) * RS + g;

  const float slog2 = scale * LOG2E;
  float m[2] = {-INFINITY, -INFINITY};    // running max of rows g, g + 8 (log2 units)
  float l[2] = {0.f, 0.f};                // this thread's share of the normaliser
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  if (tbeg < tend) load_tile<D, RS>(Ks, kb, kss, (long long)tbeg * BK, Tn, BK);
  cp_async_commit();

  for (int kt = tbeg; kt < tend; ++kt) {
    const long long k0 = (long long)kt * BK, klast = k0 + BK - 1;
    cp_async_wait_all();
    __syncthreads();                 // K(kt) is in; every warp is done with V(kt - 1)
    load_tile<D, RS>(Vs, vb, vss, k0, Tn, BK);
    cp_async_commit();

    const bool live = warp_has_rows && k0 < kmax && (!causal || k0 <= wb)
                      && wa - klast < window;
    const bool full = klast < kmax && (!causal || klast <= wa) && wb - k0 < window;
    float s[NB][4];
    if (live) {
      // S = Q K^T over D in steps of 8
#pragma unroll
      for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 4
      for (int d0 = 0; d0 < D; d0 += 8) {
        uint32_t a[4], ah[4], al[4];
        ldsm_x4(a, q_addr + d0 * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) split(__uint_as_float(a[i]), ah[i], al[i]);
#pragma unroll
        for (int j = 0; j < NB; j += 2) {
          uint32_t kf[4];                 // b0, b1 of key blocks j and j + 1
          ldsm_x4(kf, k_addr + (j * 8 * RS + d0) * 4);
          mma_3xtf32(s[j], ah, al, __uint_as_float(kf[0]), __uint_as_float(kf[1]));
          mma_3xtf32(s[j + 1], ah, al, __uint_as_float(kf[2]), __uint_as_float(kf[3]));
        }
      }

      // scale, soft-cap, mask; online softmax in log2 units
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x;
          if (cap > 0.f) {
            x = cap * tanhf(s[j][e] * scale / cap) * LOG2E;
          } else {
            x = s[j][e] * slog2;
          }
          if (!full) {
            const long long kpos = k0 + 8 * j + 2 * t + (e & 1);
            const long long qpos = wa + g + 8 * (e >> 1);
            const bool ok = kpos < kmax && (!causal || kpos <= qpos) && qpos - kpos < window;
            x = ok ? x : -INFINITY;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2], m_use[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = exp2f(m[r] - m_use[r]);
        m[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(s[j][e] - m_use[e >> 1]);
          rs[e >> 1] += s[j][e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < ND; ++j) {   // (skipped while no row max moved)
          acc[j][0] *= alpha[0];
          acc[j][1] *= alpha[0];
          acc[j][2] *= alpha[1];
          acc[j][3] *= alpha[1];
        }
      }
    }

    cp_async_wait_all();
    __syncthreads();                 // V(kt) is in; every warp is done with K(kt)
    if (kt + 1 < tend) load_tile<D, RS>(Ks, kb, kss, k0 + BK, Tn, BK);
    cp_async_commit();

    if (live) {
      // O += P V, keys of each 8-key block permuted (k = t <-> key 2t,
      // k = t + 4 <-> key 2t + 1) so P's A fragment is the S accumulator
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        uint32_t ph[4], pl[4];
        split(s[j][0], ph[0], pl[0]);     // row g,     key 2t
        split(s[j][2], ph[1], pl[1]);     // row g + 8, key 2t
        split(s[j][1], ph[2], pl[2]);     // row g,     key 2t + 1
        split(s[j][3], ph[3], pl[3]);     // row g + 8, key 2t + 1
        const float* v0 = v_frag + j * 8 * RS;
#pragma unroll
        for (int n = 0; n < ND; ++n)
          mma_3xtf32(acc[n], ph, pl, v0[n * 8], v0[RS + n * 8]);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = wrow0 + g + 8 * r;
    if (qi >= S) continue;
    const float den = l[r] == 0.f ? 1.f : l[r];   // fully masked rows -> 0
    float* orow = o + b * osb + (long long)qi * oss + h * osh + 2 * t;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) =
          make_float2(acc[j][2 * r] / den, acc[j][2 * r + 1] / den);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Tn, int H, int Hkv, const long long* st, float scale, float cap,
           int causal, long long q_offset, long long window, long long kv_len,
           cudaStream_t stream) {
  constexpr size_t bytes = Tile<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((S + BQ - 1) / BQ) * H * B;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  flash_fwd_tf32<D><<<(unsigned)blocks, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Tn, H, H / Hkv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale, cap, causal, q_offset, window, kv_len);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 q (B, S, H, D), k/v (B, T, Hkv, D), o (B, S, H, D). strides: q
// (batch, seq, head), then k, v, o likewise, in elements; the head_dim
// stride is 1, the others multiples of 4, the starts 16-byte aligned.
// window and kv_len are "no limit" when at least T. Returns the CUDA
// error code (0 = launched).
extern "C" int flash_attention_tf32_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int Tn, int H, int Hkv, int D, const long long* strides, float scale,
    float cap, int causal, long long q_offset, long long window,
    long long kv_len, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:  return launch<16>(q, k, v, o, B, S, Tn, H, Hkv, strides, scale, cap, causal, q_offset, window, kv_len, s);
    case 32:  return launch<32>(q, k, v, o, B, S, Tn, H, Hkv, strides, scale, cap, causal, q_offset, window, kv_len, s);
    case 64:  return launch<64>(q, k, v, o, B, S, Tn, H, Hkv, strides, scale, cap, causal, q_offset, window, kv_len, s);
    case 128: return launch<128>(q, k, v, o, B, S, Tn, H, Hkv, strides, scale, cap, causal, q_offset, window, kv_len, s);
    case 256: return launch<256>(q, k, v, o, B, S, Tn, H, Hkv, strides, scale, cap, causal, q_offset, window, kv_len, s);
    default:  return (int)cudaErrorInvalidValue;
  }
}

// Mamba-2 SSD chunked scan forward for Hopper (sm_90a), called through a
// plain C entry point (ctypes).
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/ssd_scan/kernel.py::ssd_scan_fwd (body `_kernel`).
// Per chunk of l steps it computes the inclusive cumsum `cs` of the
// log-decay dta, the intra-chunk term ((C B^T) o exp(cs_t - cs_s), lower
// triangular) x, the inter-chunk term exp(cs_t) C state, and the state
// update state exp(cs_last) + sum_t exp(cs_last - cs_t) B_t (x) x_t, with
// the f32 (p, n) state of each head carried across chunks. It returns y.
//
// What bounds it on the card: operations. At mamba2-1.3b widths (64 heads,
// p = 64, n = 128, s = 4096, l = 64) the chunked form needs ~9.7 GFLOP
// against ~0.14 GB moved. This first version runs on the f32 CUDA cores;
// tensor cores and the two-pass form (per-chunk states, then a scan across
// chunks) are later steps, to be chosen by measurement (ROADMAP Queue 2).
//
// Design, against what the TPU kernel did:
//   * The Pallas grid was (batch x head groups, chunks) with the chunks
//     sequential and the state in VMEM. Here one CTA owns one (batch,
//     head) and walks its chunks in order, the state in shared memory
//     (32 KiB at p = 64, n = 128). Blocks run in no order on the card, so
//     nothing carries between CTAs. `head_group` was a TPU tiling choice
//     and has no counterpart: the result does not depend on it.
//   * The chunk is at most LMAX = 64 steps (the A/B path's chunk), so the
//     chunk's x, B, C, the decay-masked l x l matrix and the state fit the
//     227 KiB of shared memory beside each other: ~130 KiB at the widths
//     above. A longer requested chunk runs as 64-step chunks: the chunked
//     form is exact for any chunk length, so this moves only rounding.
//   * Each product runs as 4 x 4 register tiles per thread over padded
//     shared-memory rows (odd row strides for B, C and the state, so lanes
//     reading different rows hit different banks).
//   * A ragged last chunk is zero-filled (x = B = C = 0, dta = 0), which
//     adds nothing to the state and decays nothing.
//   * bf16 x, B and C are widened to f32 in shared memory; products
//     accumulate in f32. The casts follow the TPU kernel: the masked
//     matrix, exp(cs_last - cs) and the state contribution are rounded to
//     x's type, as are the intra and inter terms before their sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int LMAX = 64;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T> __device__ __forceinline__ T store_as(float x);
template <> __device__ __forceinline__ float store_as<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Layout {
  int P, N, Lp, NS, LS;   // head dim, state dim, padded chunk, row strides
  __host__ __device__ Layout(int P_, int N_, int L) : P(P_), N(N_),
      Lp((L + 3) / 4 * 4), NS(N_ + 1), LS((L + 3) / 4 * 4 + 1) {}
  __host__ __device__ size_t floats() const {
    return size_t(P) * NS          // state
         + size_t(Lp) * P          // x
         + 2 * size_t(Lp) * NS     // B (then w B), C
         + size_t(Lp) * LS         // masked C B^T
         + 2 * size_t(Lp);         // cs, exp(cs)
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_fwd(const T* __restrict__ x, const float* __restrict__ dta,
        const T* __restrict__ Bm, const T* __restrict__ Cm, T* __restrict__ y,
        int S, int P, int N, int L,
        long long xsb, long long xss, long long xsh,
        long long dsb, long long dss, long long dsh,
        long long bsb, long long bss, long long csb, long long css,
        long long ysb, long long yss, long long ysh) {
  const Layout lay(P, N, L);
  const int Lp = lay.Lp, NS = lay.NS, LS = lay.LS;
  extern __shared__ float4 smem4[];
  float* St = reinterpret_cast<float*>(smem4);   // P x NS state
  float* Xs = St + P * NS;                       // Lp x P
  float* Bs = Xs + Lp * P;                       // Lp x NS
  float* Cs = Bs + Lp * NS;                      // Lp x NS
  float* Ms = Cs + Lp * NS;                      // Lp x LS
  float* cs = Ms + Lp * LS;                      // Lp
  float* ecs = cs + Lp;                          // Lp

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const T* xb = x + b * xsb + h * xsh;
  const float* db = dta + b * dsb + h * dsh;
  const T* Bb = Bm + b * bsb;
  const T* Cb = Cm + b * csb;
  T* yb = y + b * ysb + h * ysh;

  for (int i = tid; i < P * NS; i += THREADS) St[i] = 0.f;

  const int L4 = Lp / 4, P4 = P / 4, N4 = N / 4;
  for (int t0 = 0; t0 < S; t0 += L) {
    const int lc = S - t0 < L ? S - t0 : L;   // valid steps of this chunk
    for (int i = tid; i < Lp * P; i += THREADS) {
      const int t = i / P, c = i % P;
      Xs[i] = t < lc ? to_f32(xb[(t0 + t) * xss + c]) : 0.f;
    }
    for (int i = tid; i < Lp * N; i += THREADS) {
      const int t = i / N, c = i % N;
      const bool ok = t < lc;
      Bs[t * NS + c] = ok ? to_f32(Bb[(t0 + t) * bss + c]) : 0.f;
      Cs[t * NS + c] = ok ? to_f32(Cb[(t0 + t) * css + c]) : 0.f;
    }
    if (tid < 32) {   // inclusive cumsum of dta, two steps per lane
      const int t = 2 * lane;
      const float a0 = t < lc ? db[(t0 + t) * dss] : 0.f;
      const float a1 = t + 1 < lc ? db[(t0 + t + 1) * dss] : 0.f;
      const float pair = a0 + a1;
      float incl = pair;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      const float excl = incl - pair;
      if (t < Lp) { cs[t] = excl + a0; ecs[t] = expf(excl + a0); }
      if (t + 1 < Lp) { cs[t + 1] = incl; ecs[t + 1] = expf(incl); }
    }
    __syncthreads();
    const float last = cs[Lp - 1];

    // M[t][s] = (s <= t) (C_t . B_s) exp(cs_t - cs_s), rounded to T
    for (int g = tid; g < L4 * L4; g += THREADS) {
      const int tb = (g / L4) * 4, sb = g % L4;   // rows tb..tb+3, cols sb + L4 j
      float acc[4][4] = {};
      if (sb <= tb + 3) {
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = Cs[(tb + a) * NS + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[(sb + L4 * j) * NS + n];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[a][j] += cv[a] * bv[j];
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = tb + a, s = sb + L4 * j;
          Ms[t * LS + s] = s <= t ? round_to<T>(acc[a][j] * expf(cs[t] - cs[s])) : 0.f;
        }
    }
    __syncthreads();

    // y = (M x)  +  exp(cs) (C state), each rounded to T; B <- w B
    for (int g = tid; g < L4 * P4; g += THREADS) {
      const int tb = (g / P4) * 4, pb = g % P4;   // rows tb..tb+3, cols pb + P4 j
      float yi[4][4] = {}, ye[4][4] = {};
      const int smax = tb + 4 < Lp ? tb + 4 : Lp;
      for (int s = 0; s < smax; ++s) {
        float mv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) mv[a] = Ms[(tb + a) * LS + s];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = Xs[s * P + pb + P4 * j];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) yi[a][j] += mv[a] * xv[j];
      }
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = Cs[(tb + a) * NS + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = St[(pb + P4 * j) * NS + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) ye[a][j] += cv[a] * sv[j];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = tb + a;
        if (t >= lc) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float out = round_to<T>(yi[a][j]) + round_to<T>(ye[a][j] * ecs[t]);
          yb[(t0 + t) * yss + pb + P4 * j] = store_as<T>(out);
        }
      }
    }
    for (int i = tid; i < Lp * N; i += THREADS) {
      const int t = i / N, c = i % N;
      Bs[t * NS + c] *= round_to<T>(expf(last - cs[t]));
    }
    __syncthreads();

    // state = state exp(cs_last) + round_T(sum_t x_t (x) w_t B_t)
    const float decay = expf(last);
    for (int g = tid; g < P4 * N4; g += THREADS) {
      const int pb = (g / N4) * 4, nb = g % N4;   // rows pb..pb+3, cols nb + N4 j
      float acc[4][4] = {};
      for (int t = 0; t < Lp; ++t) {
        float xv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) xv[a] = Xs[t * P + pb + a];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[t * NS + nb + N4 * j];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[a][j] += xv[a] * bv[j];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* st = St + (pb + a) * NS + nb + N4 * j;
          *st = *st * decay + round_to<T>(acc[a][j]);
        }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* x, const float* dta, const void* Bm, const void* Cm,
           void* y, int B, int S, int H, int P, int N, int L,
           const long long* st, cudaStream_t stream) {
  const size_t bytes = Layout(P, N, L).floats() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_fwd<T><<<dim3(H, B), THREADS, bytes, stream>>>(
      static_cast<const T*>(x), dta, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), S, P, N, L,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], st[12]);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared-memory bytes the kernel asks for at these widths, so the wrapper
// can refuse widths that do not fit before launching.
extern "C" long long ssd_scan_smem_bytes(int P, int N, int L) {
  return (long long)(Layout(P, N, L).floats() * sizeof(float));
}

// dtype: 0 float32, 1 bfloat16 (x, B, C and y; dta is float32). L is the
// chunk, 1 <= L <= 64; P and N are multiples of 4. strides, in elements:
// x (batch, seq, head), dta (batch, seq, head), B (batch, seq),
// C (batch, seq), y (batch, seq, head); the innermost stride is 1.
// Returns the CUDA error code (0 = launched).
extern "C" int ssd_scan_launch(const void* x, const void* dta, const void* Bm,
                               const void* Cm, void* y, int dtype, int B,
                               int S, int H, int P, int N, int L,
                               const long long* strides, void* stream) {
  if (L < 1 || L > LMAX || P % 4 || N % 4) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dta);
  if (dtype == 0)
    return launch<float>(x, d, Bm, Cm, y, B, S, H, P, N, L, strides, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, d, Bm, Cm, y, B, S, H, P, N, L, strides, s);
  return (int)cudaErrorInvalidValue;
}

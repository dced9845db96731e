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
// against ~0.14 GB moved; it runs in f32 on the CUDA cores (67 TFLOP/s),
// in bf16 too (tensor cores for bf16 are a later step).
//
// Design, against what the TPU kernel did:
//   * Two launches. `ssd_cb` computes G = C B^T once per (batch, chunk)
//     into an f32 scratch (b, chunks, lp, lp) that the wrapper allocates
//     (1 MiB at the widths above, so it stays in L2): G does not depend on
//     the head, and the Pallas kernel (like this kernel's first version)
//     recomputed it for every head.
//   * `ssd_chunks`: one CTA per (p-tile, head, batch). The Pallas grid was
//     (batch x head groups, chunks) with the chunks sequential and the
//     state in VMEM; here each CTA walks its chunks in order with its
//     P_TILE x n rows of the f32 state in shared memory. The rows of the
//     state are independent, so splitting p is exact, and the grid fills
//     the card: 256 CTAs at p = 64 with P_TILE = 16, against 64 of 132 SMs
//     for one CTA per head. A ragged last p-tile is zero-filled and not
//     stored. `head_group` was a TPU tiling choice and has no counterpart.
//   * The next chunk's x-slice, B, C, G and dta are copied with cp.async
//     into the second of two stage buffers while the current chunk
//     computes (STAGES = 2); where two stages do not fit the shared memory
//     the wrapper launches the one-stage instance, which loads before it
//     computes (two of its CTAs fit an SM, so one loads while the other
//     computes). P_TILE and the stage count are chosen by measurement at
//     mamba2-1.3b widths, S = 1024 and 4096 (tune.py in this directory).
//   * Each CTA forms M = G o exp(cs_t - cs_s) (lower triangle) for its own
//     head in place of G (both stored transposed), scales x by
//     exp(cs_last - cs) once, and then runs the output (M x + exp(cs)
//     C state) on warps 0-3 and the state update (x^T (w B)) on warps 4-7
//     side by side: the state is double-buffered, so neither waits for the
//     other. What bounds the walk is shared-memory bandwidth, not the FMA
//     pipes, so each thread keeps a register tile (4 x 4 of y, 8 x 4 of the
//     state) that reads each shared value once for 4 or 8 FMAs, and the
//     layouts keep a quarter-warp's 16-byte reads in distinct banks.
//   * The chunk is at most LMAX = 64 steps. A longer requested chunk runs
//     as 64-step chunks: the chunked form is exact for any chunk length,
//     so this moves only rounding. A ragged last chunk is zero-filled
//     (x = B = C = 0, dta = 0), which adds nothing and decays nothing.
//   * bf16 x, B and C stay bf16 in shared memory and are widened as they
//     are read; products accumulate in f32. The casts follow the TPU
//     kernel: the masked matrix, exp(cs_last - cs) and the state
//     contribution are rounded to x's type, as are the intra and inter
//     terms before their sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef SSD_P_TILE
#define SSD_P_TILE 32
#endif

namespace {

constexpr int THREADS = 256;
constexpr int LMAX = 64;
constexpr int PT = SSD_P_TILE;   // state rows (head-dim columns) per CTA
static_assert(PT % 8 == 0, "a bf16 x row of the p-tile is whole 16-byte pieces");

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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void st4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// cp.async of `bytes` (0-16) from global to shared, zero-filling the rest
// of the 16; both addresses 16-byte aligned
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src),
                  "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src),
                  "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__host__ __device__ inline int pad4(int L) { return (L + 3) / 4 * 4; }

// ---------------------------------------------------------------------------
// G[b, c] = C_c B_c^T over the chunk's lp x lp steps (zero past the chunk),
// stored transposed: row s holds (C_t . B_s) for t = 0 .. lp - 1, so that
// the chunk walk reads two output rows' weights as one float2

__host__ __device__ inline size_t cb_smem_bytes(int N, int L) {
  return 2 * size_t(pad4(L)) * (N + 1) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_cb(const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ G,
       int S, int N, int L, long long bsb, long long bss, long long csb, long long css) {
  const int Lp = pad4(L), NS = N + 1;
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);
  float* Cs = Bs + Lp * NS;
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int t0 = c * L, lc = S - t0 < L ? S - t0 : L;
  const T* Bb = Bm + b * bsb;
  const T* Cb = Cm + b * csb;
  for (int i = tid; i < Lp * N; i += THREADS) {
    const int t = i / N, n = i % N;
    const bool ok = t < lc;
    Bs[t * NS + n] = ok ? to_f32(Bb[(t0 + t) * bss + n]) : 0.f;
    Cs[t * NS + n] = ok ? to_f32(Cb[(t0 + t) * css + n]) : 0.f;
  }
  __syncthreads();
  float* Gc = G + (size_t(b) * gridDim.x + c) * Lp * Lp;
  const int L4 = Lp / 4;
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
      for (int j = 0; j < 4; ++j) Gc[(sb + L4 * j) * Lp + tb + a] = acc[a][j];
  }
}

// ---------------------------------------------------------------------------
// the chunk walk of one (p-tile, head, batch)

template <typename T>
struct Plan {
  // element counts of each shared-memory array; every row is a multiple of
  // 16 bytes so that cp.async lands aligned
  int Lp, N, NS, LS, SS;
  __host__ __device__ Plan(int N_, int L) : Lp(pad4(L)), N(N_),
      NS((N_ + 16 / int(sizeof(T)) - 1) / (16 / int(sizeof(T))) * (16 / int(sizeof(T)))
         + 16 / int(sizeof(T))),
      LS(pad4(L) + 4), SS(N_ + 4) {}
  __host__ __device__ size_t stage_bytes() const {
    return sizeof(T) * (size_t(Lp) * PT + 2 * size_t(Lp) * NS)   // x, B, C
         + sizeof(float) * (size_t(Lp) * LS + Lp);                // G (then M), dta
  }
  // state rows are SS apart, plus 4 floats after every 8 rows: the four
  // rows p, p + 4, p + 8, p + 12 that a quarter-warp reads then fall in
  // different banks
  __host__ __device__ static int state_row(int r, int SS) { return r * SS + (r >> 3) * 4; }
  __host__ __device__ int state_floats() const { return state_row(PT, SS); }
  __host__ __device__ size_t fixed_bytes() const {
    return sizeof(float) * (size_t(Lp) * PT              // x exp(cs_last - cs)
                            + 2 * size_t(state_floats())   // state, double-buffered
                            + 3 * size_t(Lp));             // cs, exp(cs), exp(cs_last - cs)
  }
  __host__ __device__ size_t bytes(int stages) const {
    return stages * stage_bytes() + fixed_bytes();
  }
};

template <typename T>
struct Stage {
  T* x;        // Lp x PT
  T* B;        // Lp x NS
  T* C;        // Lp x NS
  float* G;    // Lp x LS: G^T, then M^T in place
  float* d;    // Lp
  __device__ Stage(uint8_t* base, const Plan<T>& pl) {
    x = reinterpret_cast<T*>(base);
    B = x + pl.Lp * PT;
    C = B + pl.Lp * pl.NS;
    G = reinterpret_cast<float*>(C + pl.Lp * pl.NS);
    d = G + pl.Lp * pl.LS;
  }
};

template <typename T, int STAGES>
__global__ void __launch_bounds__(THREADS, STAGES == 1 ? 2 : 1)
ssd_chunks(const T* __restrict__ x, const float* __restrict__ dta,
           const T* __restrict__ Bm, const T* __restrict__ Cm,
           const float* __restrict__ G, T* __restrict__ y,
           int S, int P, int N, int L,
           long long xsb, long long xss, long long xsh,
           long long dsb, long long dss, long long dsh,
           long long bsb, long long bss, long long csb, long long css,
           long long ysb, long long yss, long long ysh) {
  const Plan<T> pl(N, L);
  const int Lp = pl.Lp, NS = pl.NS, LS = pl.LS, SS = pl.SS;
  extern __shared__ float4 smem4[];
  uint8_t* raw = reinterpret_cast<uint8_t*>(smem4);
  float* XW = reinterpret_cast<float*>(raw + STAGES * pl.stage_bytes());
  float* St0 = XW + Lp * PT;
  const int SF = pl.state_floats();
  float* cs = St0 + 2 * SF;
  float* ecs = cs + Lp;
  float* wv = ecs + Lp;

  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int pv = P - p0 < PT ? P - p0 : PT;        // valid columns of this tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nch = (S + L - 1) / L;
  const T* xb = x + b * xsb + h * xsh + p0;
  const float* db = dta + b * dsb + h * dsh;
  const T* Bb = Bm + b * bsb;
  const T* Cb = Cm + b * csb;
  const float* Gb = G + size_t(b) * nch * Lp * Lp;
  T* yb = y + b * ysb + h * ysh + p0;

  auto load = [&](int c, int st) {
    const Stage<T> sg(raw + st * pl.stage_bytes(), pl);
    const int t0 = c * L, lc = S - t0 < L ? S - t0 : L;
    constexpr int E = 16 / sizeof(T);              // elements per 16-byte piece
    constexpr int XP = PT / E;
    for (int i = tid; i < Lp * XP; i += THREADS) {
      const int t = i / XP, k = i % XP;
      int bytes = t < lc ? (pv - k * E) * int(sizeof(T)) : 0;
      bytes = bytes < 0 ? 0 : (bytes > 16 ? 16 : bytes);
      cp16(sg.x + t * PT + k * E, bytes ? xb + (t0 + t) * xss + k * E : xb, bytes);
    }
    const int NP = (N + E - 1) / E;
    for (int i = tid; i < Lp * NP; i += THREADS) {
      const int t = i / NP, k = i % NP;
      int bytes = t < lc ? (N - k * E) * int(sizeof(T)) : 0;
      bytes = bytes > 16 ? 16 : bytes;
      cp16(sg.B + t * NS + k * E, bytes ? Bb + (t0 + t) * bss + k * E : Bb, bytes);
      cp16(sg.C + t * NS + k * E, bytes ? Cb + (t0 + t) * css + k * E : Cb, bytes);
    }
    const float* Gc = Gb + size_t(c) * Lp * Lp;
    for (int i = tid; i < Lp * (Lp / 4); i += THREADS) {
      const int t = i / (Lp / 4), k = i % (Lp / 4);
      cp16(sg.G + t * LS + 4 * k, Gc + t * Lp + 4 * k, 16);
    }
    for (int t = tid; t < Lp; t += THREADS)
      cp4(sg.d + t, t < lc ? db + (t0 + t) * dss : db, t < lc ? 4 : 0);
  };

  for (int i = tid; i < SF; i += THREADS) St0[i] = 0.f;
  load(0, 0);
  cp_commit();
  for (int c = 0; c < nch; ++c) {
    const int st = STAGES == 2 ? c & 1 : 0;
    if (STAGES == 2) {
      if (c + 1 < nch) load(c + 1, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const Stage<T> sg(raw + st * pl.stage_bytes(), pl);
    const int t0 = c * L, lc = S - t0 < L ? S - t0 : L;
    const float* Sold = St0 + (c & 1) * SF;
    float* Snew = St0 + ((c + 1) & 1) * SF;

    if (warp == 0) {   // inclusive cumsum of dta, two steps per lane
      const int t = 2 * lane;
      const float a0 = t < Lp ? sg.d[t] : 0.f;
      const float a1 = t + 1 < Lp ? sg.d[t + 1] : 0.f;
      const float pair = a0 + a1;
      float incl = pair;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      const float last = __shfl_sync(0xffffffffu, incl, 31);
      const float excl = incl - pair;
      if (t < Lp) {
        cs[t] = excl + a0;
        ecs[t] = expf(excl + a0);
        wv[t] = round_to<T>(expf(last - (excl + a0)));
      }
      if (t + 1 < Lp) {
        cs[t + 1] = incl;
        ecs[t + 1] = expf(incl);
        wv[t + 1] = round_to<T>(expf(last - incl));
      }
    }
    __syncthreads();
    const float decay = expf(cs[Lp - 1]);

    // M^T[s][t] = (s <= t) G^T[s][t] exp(cs_t - cs_s), rounded to T, in
    // place; XW = x exp(cs_last - cs)
    for (int i = tid; i < Lp * Lp; i += THREADS) {
      const int s = i / Lp, t = i - s * Lp;
      float* gp = sg.G + s * LS + t;
      *gp = s <= t ? round_to<T>(*gp * expf(cs[t] - cs[s])) : 0.f;
    }
    for (int i = tid; i < Lp * PT; i += THREADS)
      XW[i] = to_f32(sg.x[i]) * wv[i / PT];
    __syncthreads();

    // The output and the state update read disjoint results: warps 0-3 take
    // y, warps 4-7 the new state, each thread a 4 x 4 (y) or 8 x 4 (state)
    // register tile, so that each value read from shared memory feeds 4 or
    // 8 FMAs.
    constexpr int HALF = THREADS / 2;
    if (tid < HALF) {
      // y rows t .. t + 3 x columns p .. p + 3:
      // round_T(M x) + round_T(exp(cs) (C state))
      for (int g = tid; g < (Lp / 4) * (PT / 4); g += HALF) {
        const int t = 4 * (g / (PT / 4)), p = 4 * (g % (PT / 4));
        float yi[4][4] = {}, ye[4][4] = {};
        for (int s = 0; s <= t + 3; ++s) {
          const float4 mv = ld4(sg.G + s * LS + t);        // M[t .. t + 3][s]
          const float4 xv = ld4(sg.x + s * PT + p);
          const float ms[4] = {mv.x, mv.y, mv.z, mv.w}, xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int j = 0; j < 4; ++j) yi[a][j] = fmaf(ms[a], xs[j], yi[a][j]);
        }
        const T* crow = sg.C + t * NS;
        for (int n = 0; n < N; n += 4) {
          float4 cv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = ld4(crow + a * NS + n);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 sv = ld4(Sold + Plan<T>::state_row(p + j, SS) + n);
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              ye[a][j] = fmaf(cv[a].x, sv.x, ye[a][j]);
              ye[a][j] = fmaf(cv[a].y, sv.y, ye[a][j]);
              ye[a][j] = fmaf(cv[a].z, sv.z, ye[a][j]);
              ye[a][j] = fmaf(cv[a].w, sv.w, ye[a][j]);
            }
          }
        }
        if (p < pv) {
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            if (t + a >= lc) continue;
            float out[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              out[j] = round_to<T>(yi[a][j]) + round_to<T>(ye[a][j] * ecs[t + a]);
            st4(yb + (t0 + t + a) * yss + p, out);
          }
        }
      }
    } else {
      // state rows p .. p + 7 x columns n .. n + 3:
      // state exp(cs_last) + round_T(sum_t XW_t (x) B_t)
      const int N4 = N / 4;
      for (int g = tid - HALF; g < (PT / 8) * N4; g += HALF) {
        const int p = 8 * (g / N4), n = 4 * (g % N4);
        float acc[8][4] = {};
        for (int t = 0; t < Lp; ++t) {
          const float4 xa = ld4(XW + t * PT + p), xb = ld4(XW + t * PT + p + 4);
          const float4 bv = ld4(sg.B + t * NS + n);
          const float xs[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            acc[a][0] = fmaf(xs[a], bv.x, acc[a][0]);
            acc[a][1] = fmaf(xs[a], bv.y, acc[a][1]);
            acc[a][2] = fmaf(xs[a], bv.z, acc[a][2]);
            acc[a][3] = fmaf(xs[a], bv.w, acc[a][3]);
          }
        }
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const int r = Plan<T>::state_row(p + a, SS) + n;
          const float4 so = ld4(Sold + r);
          *reinterpret_cast<float4*>(Snew + r) = make_float4(
              so.x * decay + round_to<T>(acc[a][0]), so.y * decay + round_to<T>(acc[a][1]),
              so.z * decay + round_to<T>(acc[a][2]), so.w * decay + round_to<T>(acc[a][3]));
        }
      }
    }
    __syncthreads();   // this stage, M, XW and the old state are free again
    if (STAGES == 1 && c + 1 < nch) {
      load(c + 1, 0);
      cp_commit();
    }
  }
}

template <typename T, int STAGES>
int launch_chunks(const void* x, const float* dta, const void* Bm, const void* Cm,
                  const float* G, void* y, int B, int S, int H, int P, int N, int L,
                  const long long* st, cudaStream_t stream) {
  const size_t bytes = Plan<T>(N, L).bytes(STAGES);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunks<T, STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_chunks<T, STAGES><<<dim3((P + PT - 1) / PT, H, B), THREADS, bytes, stream>>>(
      static_cast<const T*>(x), dta, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      G, static_cast<T*>(y), S, P, N, L, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], st[12]);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const float* dta, const void* Bm, const void* Cm, void* y,
           float* G, int B, int S, int H, int P, int N, int L, int stages,
           const long long* st, cudaStream_t stream) {
  const size_t cb_bytes = cb_smem_bytes(N, L);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_cb<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cb_bytes);
  if (err != cudaSuccess) return (int)err;
  const int nch = (S + L - 1) / L;
  ssd_cb<T><<<dim3(nch, B), THREADS, cb_bytes, stream>>>(
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), G, S, N, L, st[6], st[7],
      st[8], st[9]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (stages == 2)
    return launch_chunks<T, 2>(x, dta, Bm, Cm, G, y, B, S, H, P, N, L, st, stream);
  return launch_chunks<T, 1>(x, dta, Bm, Cm, G, y, B, S, H, P, N, L, st, stream);
}

}  // namespace

// Shared-memory bytes of the chunk walk (`stages` 1 or 2) and of the C B^T
// pass at these widths, so the wrapper can pick the stage count and refuse
// widths that do not fit before launching. dtype: 0 float32, 1 bfloat16.
extern "C" long long ssd_scan_smem_bytes(int dtype, int N, int L, int stages) {
  const size_t walk = dtype == 0 ? Plan<float>(N, L).bytes(stages)
                                 : Plan<__nv_bfloat16>(N, L).bytes(stages);
  const size_t cb = cb_smem_bytes(N, L);
  return (long long)(walk > cb ? walk : cb);
}

// Floats of the G = C B^T scratch the wrapper allocates: (B, chunks, lp, lp).
extern "C" long long ssd_scan_scratch_floats(int B, int S, int L) {
  const long long lp = pad4(L);
  return (long long)B * ((S + L - 1) / L) * lp * lp;
}

// dtype: 0 float32, 1 bfloat16 (x, B, C and y; dta is float32). L is the
// chunk, 1 <= L <= 64; P and N are multiples of 4; stages is 1 or 2.
// strides, in elements: x (batch, seq, head), dta (batch, seq, head),
// B (batch, seq), C (batch, seq), y (batch, seq, head); the innermost
// stride is 1. x, B and C start 16-byte aligned and their strides are
// multiples of 16 bytes. G is the scratch above. Returns the CUDA error
// code (0 = launched).
extern "C" int ssd_scan_launch(const void* x, const void* dta, const void* Bm,
                               const void* Cm, void* y, void* G, int dtype, int B,
                               int S, int H, int P, int N, int L, int stages,
                               const long long* strides, void* stream) {
  if (L < 1 || L > LMAX || P % 4 || N % 4 || (stages != 1 && stages != 2))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dta);
  float* g = static_cast<float*>(G);
  if (dtype == 0)
    return launch<float>(x, d, Bm, Cm, y, g, B, S, H, P, N, L, stages, strides, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, d, Bm, Cm, y, g, B, S, H, P, N, L, stages, strides, s);
  return (int)cudaErrorInvalidValue;
}

// Flash-attention forward on Hopper's tensor cores (sm_90a), bf16, called
// through a plain C entry point (ctypes).
//
// Replaces, for bf16 inputs at head dims 64, 128 and 256, the JAX
// package's Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd (body
// `_kernel`): grouped-query attention with an online softmax, optional
// logit soft-cap, causal mask with a query offset, a sliding window given
// as a runtime integer and a KV-length mask; running max, normaliser and
// accumulator in f32, output in bf16. flash_attention.cu computes the same
// function on the CUDA cores and keeps f32 and the small head dims.
//
// What bounds it on the card: operations. At gemma2-2b widths (D = 256,
// 8 query / 4 KV heads, S = T = 4096, causal) the two products are
// 68.7 GFLOP against ~50 MB of bf16 inputs and output: 0.069 ms at the
// 989 TFLOP/s of the bf16 tensor cores, 0.015 ms of memory traffic.
//
// Design:
//   * One CTA per (128-row query tile, query head, batch), heaviest causal
//     tiles first. Three warpgroups: warpgroup 0 is the producer (one
//     thread issues every copy), warpgroups 1 and 2 each own 64 query rows.
//     `setmaxnreg` moves registers from the producer (24) to the consumers
//     (240): the O accumulator alone is 128 registers a thread at D = 256.
//   * TMA loads (cp.async.bulk.tensor, 4-d maps over the model layout
//     (B, S, H, D) through the tensors' own strides, so no transposes)
//     complete on mbarriers. The Q tile (128 x D) is loaded once; K and V
//     tiles of 64 keys go through a ring of 2 stages. K and V each have a
//     "full" barrier the producer's copies complete and an "empty" barrier
//     the consumers release, and the producer loads K(i) then V(i - 1), the
//     order in which the consumers are done with them. Q plus the ring is
//     192 KiB at D = 256. A 128-byte swizzle row holds 64 bf16, so each
//     tile arrives as D / 64 boxes of 64 columns, 1024-byte aligned.
//   * S = Q K^T: wgmma m64n64k16 bf16 -> f32, both operands K-major in
//     shared memory (descriptor stride 1024 B between 8-row groups; the
//     start address steps 32 B per 16 columns inside a swizzle atom).
//   * Online softmax on the accumulator fragment in f32, in log2 units:
//     each thread holds two rows, reduced over the 4 lanes of a quad. The
//     soft-cap applies to the f32 scores. The per-element mask runs only on
//     tiles that straddle the causal diagonal, the window edge, kv_len or
//     T (TMA fills rows past T with zeros, which would give logit 0, so
//     keys >= T are masked there); tiles masked for every row of the CTA
//     are never loaded, and a warpgroup only waits out those its own rows
//     cannot see. Masked logits are -inf; the row max is taken as 0 while
//     nothing is visible and the normaliser as 1 where it is 0, so fully
//     masked rows come out exactly 0, as in the oracle.
//   * O += P V: P is rounded to bf16 (the Pallas kernel casts p to v's
//     type) and repacked from the S accumulator fragment into the register
//     A operand of wgmma m64nDk16; the normaliser sums the unrounded p. V
//     is stored key-major, so it is an MN-major B operand (transposed form;
//     descriptor: 1024 B between 8-key groups, 8 KiB between 64-column
//     atoms).
//   * Each step issues S(i) and O += P V(i - 1) as one batch; a
//     warpgroup's softmax then overlaps the other warpgroup's products.
//   * Epilogue: O / l in f32 (by the reciprocal), stored as bf16 pairs,
//     predicated on the ragged last query tile.
// Ping-pong scheduling of the two warpgroups, a persistent grid and packing
// the query heads of one KV head into a CTA are later steps.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;              // query rows per CTA
constexpr int BK = 64;               // keys per stage
constexpr int STAGES = 2;
constexpr int WG = 128;              // threads of a warpgroup
constexpr int THREADS = 3 * WG;      // producer + two consumers
constexpr int ROW = 128;             // bytes of one swizzle row: 64 bf16
constexpr float LOG2E = 1.4426950408889634f;
constexpr int PRODUCER_REGS = 24;    // 128 x 24 + 256 x 240 <= 65536
constexpr int CONSUMER_REGS = 240;

template <int D>
struct Layout {
  static constexpr int ATOMS = D / 64;                 // 64-column blocks
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int NBARS = 1 + 4 * STAGES;         // q; k, v full; k, v empty
  static constexpr int BYTES = BAR_OFF + 8 * NBARS + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// (A bounded wait that traps would also do, but a trap in the consumers'
// region makes ptxas keep them to the launch's 168 registers: at D = 256
// that spills and serializes the wgmmas.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | (static_cast<uint64_t>(lbo >> 4) << 16)
       | (static_cast<uint64_t>(sbo >> 4) << 32)
       | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving register reads and writes across the
// asynchronous products that own these registers
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 1 / x by the special-function unit (no division subroutine in the
// consumers' register region)
__device__ __forceinline__ float rcp(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void wgmma_ss_m64n64(float* d, uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n64(float* d, const uint32_t* a, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n128(float* d, const uint32_t* a, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n256(float* d, const uint32_t* a, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a, uint64_t db) {
  if constexpr (D == 64) wgmma_rs_m64n64(o, a, db, 1);
  else if constexpr (D == 128) wgmma_rs_m64n128(o, a, db, 1);
  else wgmma_rs_m64n256(o, a, db, 1);
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

struct Masks {
  int S, Tn, causal;
  long long q_offset, window, kv_len;

  // KV tiles [beg, end) that any of query rows [r0, r1) can see
  __device__ __forceinline__ void tiles(int r0, int r1, int& beg, int& end) const {
    beg = end = 0;
    if (r1 > S) r1 = S;
    if (r1 <= r0) return;
    long long kend = Tn < kv_len ? Tn : kv_len;
    const long long qlast = q_offset + r1 - 1;
    if (causal && qlast + 1 < kend) kend = qlast + 1;
    long long kbeg = q_offset + r0 - window + 1;
    if (kbeg < 0) kbeg = 0;
    if (kbeg >= kend) return;
    beg = static_cast<int>(kbeg / BK);
    end = static_cast<int>((kend + BK - 1) / BK);
  }

  __device__ __forceinline__ bool visible(long long qpos, long long key) const {
    return key < Tn && key < kv_len && (!causal || key <= qpos) && qpos - key < window;
  }
};

// Online softmax of one 64 x 64 score tile (raw q.k in s) for the thread's
// two rows; returns the factors that rebase O to the new row maxima and
// leaves P, rounded to bf16, in the A operand of each k16 step of P V.
// s[4 j + e] is row (e < 2 ? qp0 : qp1), key k0 + 8 j + 2 qd + (e & 1).
struct Softmax {
  float m0 = -INFINITY, m1 = -INFINITY;   // running maxima, log2 units
  float l0 = 0.f, l1 = 0.f;                // per-thread partial normalisers

  __device__ __forceinline__ void tile(float (&s)[32], uint32_t (&pa)[4][4], float& a0,
                                       float& a1, float scale, float cap, float inv_cap,
                                       bool edge, const Masks& mk, int k0, int qd,
                                       long long qp0, long long qp1) {
    if (cap > 0.f) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = cap * LOG2E * tanhf(s[i] * scale * inv_cap);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= scale * LOG2E;
    }
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long key = k0 + 8 * j + 2 * qd + (e & 1);
          if (!mk.visible(e < 2 ? qp0 : qp1, key)) s[4 * j + e] = -INFINITY;
        }
    }
    float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x0 = fmaxf(x0, fmaxf(s[4 * j], s[4 * j + 1]));
      x1 = fmaxf(x1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    x0 = fmaxf(m0, quad_max(x0));
    x1 = fmaxf(m1, quad_max(x1));
    const float u0 = x0 == -INFINITY ? 0.f : x0;   // nothing visible yet
    const float u1 = x1 == -INFINITY ? 0.f : x1;
    a0 = exp2f(m0 - u0);
    a1 = exp2f(m1 - u1);
    m0 = x0;
    m1 = x1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = exp2f(s[4 * j] - u0);
      s[4 * j + 1] = exp2f(s[4 * j + 1] - u0);
      s[4 * j + 2] = exp2f(s[4 * j + 2] - u1);
      s[4 * j + 3] = exp2f(s[4 * j + 3] - u1);
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = a0 * l0 + sum0;   // the unrounded p
    l1 = a1 * l1 + sum1;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  }
};

__device__ __forceinline__ void fence_pa(uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(pa[k][i]) :: "memory");
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, int group,
               long long osb, long long oss, long long osh,
               float scale, float cap, float inv_cap, Masks mk) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + L::K_OFF, sV = base + L::V_OFF;
  const uint32_t q_full = base + L::BAR_OFF;
  // the ring: tile i of the CTA's key range sits in stage i % STAGES; K and
  // V have their own "full" and "empty" barriers, since the consumers are
  // done with K(i) a tile before they are done with V(i)
  auto k_full = [&](int i) { return q_full + 8u * (1 + i % STAGES); };
  auto v_full = [&](int i) { return q_full + 8u * (1 + STAGES + i % STAGES); };
  auto k_empty = [&](int i) { return q_full + 8u * (1 + 2 * STAGES + i % STAGES); };
  auto v_empty = [&](int i) { return q_full + 8u * (1 + 3 * STAGES + i % STAGES); };
  auto phase = [](int i) { return static_cast<uint32_t>((i / STAGES) & 1); };
  auto k_tile = [&](int i) { return sK + (i % STAGES) * L::KV_BYTES; };
  auto v_tile = [&](int i) { return sV + (i % STAGES) * L::KV_BYTES; };

  const int nq = (mk.S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  int tbeg, tend;
  mk.tiles(q0, q0 + BQ, tbeg, tend);
  const int n = tend - tbeg;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 2 * WG);
      mbar_init(v_empty(s), 2 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, broadcast from lane 0 so that the compiler sees a
  // warp-uniform branch and gives each side its own register budget
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / WG, 0);
  if (wg == 0) {
    // ---- producer: K(i) then V(i - 1), the order the consumers free them
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int a = 0; a < L::ATOMS; ++a)
        tma_load(sQ + a * BQ * ROW, &tq, q_full, a * 64, q0, h, b);
      for (int i = 0; i <= n; ++i) {
        if (i < n) {
          if (i >= STAGES) mbar_wait(k_empty(i), phase(i) ^ 1);
          mbar_expect_tx(k_full(i), L::KV_BYTES);
          for (int a = 0; a < L::ATOMS; ++a)
            tma_load(k_tile(i) + a * BK * ROW, &tk, k_full(i), a * 64, (tbeg + i) * BK, hk, b);
        }
        if (i >= 1) {
          const int j = i - 1;
          if (j >= STAGES) mbar_wait(v_empty(j), phase(j) ^ 1);
          mbar_expect_tx(v_full(j), L::KV_BYTES);
          for (int a = 0; a < L::ATOMS; ++a)
            tma_load(v_tile(j) + a * BK * ROW, &tv, v_full(j), a * 64, (tbeg + j) * BK, hk, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c owns query rows q0 + 64 c + [0, 64) ---
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;
    const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
    const int g = lane / 4, qd = lane % 4;
    const int r0 = q0 + 64 * c;                    // first row of this warpgroup
    const int row0 = r0 + 16 * warp + g;           // the thread's rows: row0, row0 + 8
    const long long qp0 = mk.q_offset + row0, qp1 = qp0 + 8;
    const long long qf = mk.q_offset + r0;
    const long long ql = mk.q_offset + (r0 + 64 < mk.S ? r0 + 64 : mk.S) - 1;
    int wbeg, wend;                                // the tiles this warpgroup sees
    mk.tiles(r0, r0 + 64, wbeg, wend);
    // as ring indices: tiles [iw, iw + nw) of the CTA's [0, n); a warpgroup
    // that sees none (rows past S, or masked) skips them all
    const int nw = wend - wbeg;
    const int iw = nw > 0 ? wbeg - tbeg : n;
    const uint32_t qa = sQ + 64 * c * ROW;

    auto edge = [&](int i) {                       // needs the per-element mask
      const int k0 = (tbeg + i) * BK;
      return k0 + BK > mk.Tn || k0 + BK > mk.kv_len || (mk.causal && k0 + BK - 1 > qf)
             || ql - k0 >= mk.window;
    };
    auto issue_qk = [&](int i, float (&s)[32]) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss_m64n64(s, smem_desc(qa + (kk / 4) * BQ * ROW + col, 16, 1024),
                        smem_desc(k_tile(i) + (kk / 4) * BK * ROW + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int i, float (&acc)[D / 2], const uint32_t (&pa)[4][4]) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv<D>(acc, pa[kk], smem_desc(v_tile(i) + kk * 16 * ROW, BK * ROW, 1024));
      wgmma_commit();
    };
    auto skip = [&](int i) {                       // a tile no row here sees
      mbar_wait(k_full(i), phase(i));
      mbar_wait(v_full(i), phase(i));
      mbar_arrive(k_empty(i));
      mbar_arrive(v_empty(i));
    };

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    Softmax sm;
    mbar_wait(q_full, 0);
    for (int i = 0; i < iw; ++i) skip(i);
    if (nw > 0) {
      // S(i) = Q K(i)^T is issued together with O += P V(i - 1), one wait for
      // both; the softmax of one warpgroup overlaps the other's products.
      // (Waiting for S(i) alone and running its softmax under P V(i - 1) is
      // valid PTX, but ptxas then serializes every wgmma of the loop, C7513,
      // and a trial on the card was slower.)
      float s[32];
      uint32_t pa[4][4];
      float a0, a1;
      mbar_wait(k_full(iw), phase(iw));
      wgmma_fence();
      issue_qk(iw, s);
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(k_empty(iw));
      sm.tile(s, pa, a0, a1, scale, cap, inv_cap, edge(iw), mk, (tbeg + iw) * BK, qd, qp0, qp1);
      for (int i = iw + 1; i < iw + nw; ++i) {
        // both waits before the fence: a wait loop between the two issues
        // makes ptxas serialize them
        mbar_wait(k_full(i), phase(i));
        mbar_wait(v_full(i - 1), phase(i - 1));
        fence_regs(acc);
        fence_pa(pa);
        wgmma_fence();
        issue_qk(i, s);
        issue_pv(i - 1, acc, pa);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(acc);
        fence_pa(pa);
        mbar_arrive(k_empty(i));
        mbar_arrive(v_empty(i - 1));
        sm.tile(s, pa, a0, a1, scale, cap, inv_cap, edge(i), mk, (tbeg + i) * BK, qd, qp0, qp1);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j] *= a0;
          acc[4 * j + 1] *= a0;
          acc[4 * j + 2] *= a1;
          acc[4 * j + 3] *= a1;
        }
      }
      const int il = iw + nw - 1;
      mbar_wait(v_full(il), phase(il));
      fence_regs(acc);
      fence_pa(pa);
      wgmma_fence();
      issue_pv(il, acc, pa);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_pa(pa);
      mbar_arrive(v_empty(il));
    }
    for (int i = iw + nw; i < n; ++i) skip(i);

    // epilogue: O / l, fully masked rows (l == 0) stay 0
    const float l0 = quad_sum(sm.l0), l1 = quad_sum(sm.l1);
    const float d0 = l0 == 0.f ? 1.f : rcp(l0), d1 = l1 == 0.f ? 1.f : rcp(l1);
    __nv_bfloat16* ob = o + b * osb + h * osh + 2 * qd;
    if (row0 < mk.S) {
      uint32_t* p = reinterpret_cast<uint32_t*>(ob + row0 * oss);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) p[4 * j] = pack_bf16(acc[4 * j] * d0, acc[4 * j + 1] * d0);
    }
    if (row0 + 8 < mk.S) {
      uint32_t* p = reinterpret_cast<uint32_t*>(ob + (row0 + 8) * oss);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        p[4 * j] = pack_bf16(acc[4 * j + 2] * d1, acc[4 * j + 3] * d1);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call; the library is not linked
// against libcuda, so it is fetched through the runtime's entry-point query.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d map over (D, rows, heads, batch) of a bf16 tensor in model layout;
// `st` are its (batch, seq, head) strides in elements. Boxes are 64 columns
// (one 128-byte swizzle row) by `box_rows` rows of one head and batch.
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int D, int rows,
            int heads, int batch, const long long* st, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 2, (cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int Tn,
           int H, int Hkv, const long long* st, float scale, float cap, int causal,
           long long q_offset, long long window, long long kv_len, cudaStream_t stream) {
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap mq, mkk, mv;
  // with no keys no K/V tile is ever loaded; the maps only need to be valid
  const int rows_kv = Tn > 0 ? Tn : 1;
  if (!encode(enc, &mq, q, D, S, H, B, st, BQ)
      || !encode(enc, &mkk, Tn > 0 ? k : q, D, rows_kv, Hkv, B, Tn > 0 ? st + 3 : st, BK)
      || !encode(enc, &mv, Tn > 0 ? v : q, D, rows_kv, Hkv, B, Tn > 0 ? st + 6 : st, BK))
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const Masks mk{S, Tn, causal, q_offset, window, kv_len};
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_sm90<D><<<grid, THREADS, bytes, stream>>>(
      mq, mkk, mv, static_cast<__nv_bfloat16*>(o), H / Hkv, st[9], st[10], st[11], scale,
      cap, cap > 0.f ? 1.f / cap : 0.f, mk);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only; D in {64, 128, 256}. strides: q (batch, seq, head), then k, v,
// o likewise, in elements; the head_dim stride is 1, the others multiples
// of 8 (16 bytes, as TMA wants), the pointers 16-byte aligned. window and
// kv_len are "no limit" when at least T. Returns the CUDA error code
// (0 = launched).
extern "C" int flash_attention_sm90_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S, int Tn, int H,
    int Hkv, int D, const long long* strides, float scale, float cap, int causal,
    long long q_offset, long long window, long long kv_len, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:  return launch<64>(q, k, v, o, B, S, Tn, H, Hkv, strides, scale, cap, causal, q_offset, window, kv_len, s);
    case 128: return launch<128>(q, k, v, o, B, S, Tn, H, Hkv, strides, scale, cap, causal, q_offset, window, kv_len, s);
    case 256: return launch<256>(q, k, v, o, B, S, Tn, H, Hkv, strides, scale, cap, causal, q_offset, window, kv_len, s);
    default:  return (int)cudaErrorInvalidValue;
  }
}

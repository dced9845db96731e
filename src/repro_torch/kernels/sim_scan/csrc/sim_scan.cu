// Fused AR(1) scan + tail/spike mixture for simulated collective durations.
//
// Replaces the TPU kernel src/repro/kernels/sim_scan/kernel.py
// (sim_durations_scan, Pallas body _kernel): same function, batched over
// rows (one row per launch epoch of a cost-model term).
//
//   s_i = coeff * s_{i-1} + eps_i           (s_{-1} = state[row])
//   t_i = t0[row] * exp(s_i) * tail_i * spike_i
//
// Bound on an H100: device memory. Each element reads four float64 inputs
// (eps, u_tail, u_mag, u_spike) and writes two (t, s): 48 B per element,
// about 15 float64 operations, so at 3.35 TB/s an (R=30, n=1e5) call
// moving 144 MB cannot take less than ~43 us. The noise is read once and
// t/s written once: the mixture runs in the same pass as the scan.
//
// Design. The Pallas grid walked 128-element chunks in order with the
// carry in VMEM and used the closed form a^j * cumsum(eps / a^j), which
// needs a first-order switch for |coeff| < 0.005 (a^-j overflows). Here
// one block owns one row and loops over chunks of THREADS * ITEMS
// elements, carrying the AR(1) state in shared memory. Inside a chunk the
// recurrence is an inclusive scan of affine maps (a, b) under
// (a1, b1) o (a2, b2) = (a1*a2, b1*a2 + b2): each thread scans ITEMS
// neighbours serially, lanes combine with __shfl_up_sync, warps through
// shared memory, and the chunk's maps are applied to the carry. No
// rescaling, so it is exact for every |coeff| < 1.
//
// The association order is the one the plain version (../ref.py) uses,
// and the build passes --fmad=false so that no multiply-add is fused: the
// kernel and the plain version round alike and agree to the last bit on
// s, which is what lets them be held at rtol 1e-12 even at coeff -> -1.
//
// One block per row leaves most SMs idle at R=30; a decoupled look-back
// across blocks is the step to the memory bound.

#include <cuda_runtime.h>

#ifndef SIM_SCAN_THREADS
#error "build with -DSIM_SCAN_THREADS=... (set in repro_torch/kernels/sim_scan/ref.py)"
#endif
#ifndef SIM_SCAN_ITEMS
#error "build with -DSIM_SCAN_ITEMS=... (set in repro_torch/kernels/sim_scan/ref.py)"
#endif

#define THREADS SIM_SCAN_THREADS
#define ITEMS SIM_SCAN_ITEMS
#define WARPS (THREADS / 32)
#define CHUNK (THREADS * ITEMS)
#define FULL_MASK 0xffffffffu

static_assert(THREADS % 32 == 0 && WARPS <= 32, "THREADS: whole warps, at most 32");

// (pa, pb) o (a, b), in place on (a, b)
__device__ __forceinline__ void compose(double pa, double pb, double &a, double &b) {
    b = pb * a + b;
    a = pa * a;
}

// Hillis-Steele inclusive scan over the lanes of a warp, up to `width`.
__device__ __forceinline__ void warp_scan(double &a, double &b, int lane, int width) {
    for (int d = 1; d < width; d <<= 1) {
        double pa = __shfl_up_sync(FULL_MASK, a, d);
        double pb = __shfl_up_sync(FULL_MASK, b, d);
        if (lane < d) { pa = 1.0; pb = 0.0; }
        compose(pa, pb, a, b);
    }
}

__global__ void __launch_bounds__(THREADS) sim_scan_kernel(
    const double* __restrict__ eps, const double* __restrict__ u_tail,
    const double* __restrict__ u_mag, const double* __restrict__ u_spike,
    const double* __restrict__ state, const double* __restrict__ t0,
    double* __restrict__ t_out, double* __restrict__ s_out, long long n,
    double coeff, double tail_prob, double tail_shift, double spike_prob,
    double spike_scale) {
    __shared__ double warp_a[WARPS];
    __shared__ double warp_b[WARPS];
    __shared__ double carry_sh;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const long long off = (long long)blockIdx.x * n;
    const double t0r = t0[blockIdx.x];
    double carry = state[blockIdx.x];

    for (long long base = 0; base < n; base += CHUNK) {
        const long long i0 = base + (long long)tid * ITEMS;
        double A[ITEMS], B[ITEMS];
        // serial scan of this thread's neighbours (zeros past the end:
        // they only feed positions that are never stored)
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
            const double x = (i0 + k < n) ? eps[off + i0 + k] : 0.0;
            if (k == 0) {
                A[0] = coeff;
                B[0] = x;
            } else {
                A[k] = A[k - 1] * coeff;
                B[k] = B[k - 1] * coeff + x;
            }
        }

        // lanes: inclusive scan of the thread totals, then exclusive
        double la = A[ITEMS - 1], lb = B[ITEMS - 1];
        warp_scan(la, lb, lane, 32);
        if (lane == 31) { warp_a[warp] = la; warp_b[warp] = lb; }
        double xa = __shfl_up_sync(FULL_MASK, la, 1);
        double xb = __shfl_up_sync(FULL_MASK, lb, 1);
        if (lane == 0) { xa = 1.0; xb = 0.0; }
        __syncthreads();

        // warps: the same over the warp totals, by warp 0
        if (warp == 0) {
            double wa = lane < WARPS ? warp_a[lane] : 1.0;
            double wb = lane < WARPS ? warp_b[lane] : 0.0;
            warp_scan(wa, wb, lane, WARPS);
            double ya = __shfl_up_sync(FULL_MASK, wa, 1);
            double yb = __shfl_up_sync(FULL_MASK, wb, 1);
            if (lane == 0) { ya = 1.0; yb = 0.0; }
            if (lane < WARPS) { warp_a[lane] = ya; warp_b[lane] = yb; }
        }
        __syncthreads();

        // this thread's prefix (warp prefix o lane prefix), then each item
        const double wa = warp_a[warp], wb = warp_b[warp];
        const double pa = wa * xa;
        const double pb = wb * xa + xb;
        double s = 0.0;
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
            const double ea = pa * A[k];
            const double eb = pb * A[k] + B[k];
            s = ea * carry + eb;
            const long long i = i0 + k;
            if (i < n) {
                double t = t0r * exp(s);
                const double mag = 1.0 + tail_shift * (0.7 + 0.6 * u_mag[off + i]);
                if (u_tail[off + i] < tail_prob) t = t * mag;
                if (u_spike[off + i] < spike_prob) t = t * spike_scale;
                t_out[off + i] = t;
                s_out[off + i] = s;
            }
        }
        if (tid == THREADS - 1) carry_sh = s;
        __syncthreads();
        carry = carry_sh;
    }
}

extern "C" int sim_scan_launch(
    const double* eps, const double* u_tail, const double* u_mag,
    const double* u_spike, const double* state, const double* t0,
    double* t_out, double* s_out, long long rows, long long n, double coeff,
    double tail_prob, double tail_shift, double spike_prob,
    double spike_scale, void* stream) {
    sim_scan_kernel<<<(unsigned)rows, THREADS, 0, (cudaStream_t)stream>>>(
        eps, u_tail, u_mag, u_spike, state, t0, t_out, s_out, n, coeff,
        tail_prob, tail_shift, spike_prob, spike_scale);
    return (int)cudaGetLastError();
}

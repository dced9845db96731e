// Fused AR(1) scan + tail/spike mixture for simulated collective durations.
//
// Replaces the TPU kernel src/repro/kernels/sim_scan/kernel.py:86
// (sim_durations_scan, Pallas body _kernel): same function, batched over
// rows (one row per launch epoch of a cost-model term).
//
//   s_i = coeff * s_{i-1} + eps_i           (s_{-1} = state[row])
//   t_i = t0[row] * exp(s_i) * tail_i * spike_i
//
// Bound on an H100: device memory. Each element reads four float64 inputs
// (eps, u_tail, u_mag, u_spike) and writes two (t, s): 48 B per element,
// about 12 float64 operations, so at 3.35 TB/s an (R=30, n=1e5) call
// moving 144 MB cannot take less than ~43 us. The noise is read once and
// t/s written once: the mixture runs in the same pass as the scan.
//
// Design: one pass over the whole card. The Pallas grid walked 128-element
// chunks in order with the carry in VMEM; blocks on Hopper run in parallel
// in no order, so here every block takes one tile of CHUNK = THREADS *
// ITEMS elements of one row, R * ceil(n / CHUNK) tiles in all (2940 at the
// main path's R=30, n=1e5; 98 on an R=1 top-up), and the carry crosses
// tiles by a decoupled look-back.
//
//  - Tile order: a block takes its tile index from a global atomic
//    counter, row-major, not from blockIdx. Every tile it waits on was
//    taken by a block that is already running, so the wait cannot
//    deadlock.
//  - Loads: every input of the tile is loaded into registers first (16-byte
//    double2 loads where the row is 16-byte aligned, scalar ones on a
//    misaligned row or the ragged end). The uniforms are cut at once to
//    the tail magnitude and two bits, so few registers stay live.
//  - Inside a tile: the recurrence is an inclusive scan of affine maps
//    (a, b) under (a1, b1) o (a2, b2) = (a1*a2, b1*a2 + b2): each thread
//    scans ITEMS neighbours serially, lanes combine with __shfl_up_sync,
//    warps through shared memory. Element i gets the map (Ea_i, Eb_i) from
//    the tile's carry-in to s_i; the last one is the tile's aggregate.
//    No rescaling, so it is exact for every |coeff| < 1.
//  - Across tiles: a status record per tile (flag 0 empty, 1 aggregate,
//    2 inclusive; the aggregate (A, B); the end state S). A tile
//    publishes its aggregate as soon as it has it; then its last warp
//    reads SPAN predecessors' records a step, nearest first, to the
//    nearest inclusive tile k (or the row's state), and applies the
//    aggregates of tiles k+1 .. i-1 to that scalar in forward order,
//    c = A_m * c + B_m (staged through shared memory). Only aggregates
//    are waited for, never an end state, so no chain of publishes runs
//    along a row. Every INCLUSIVE_EVERY-th tile then publishes
//    S = A_i * c + B_i, after the block's barrier: the end states bound
//    the walk on long rows. A record's values are written, then its flag
//    with st.release; a reader takes the flag with ld.acquire, then the
//    values. Each release stalls its thread; on the card a __threadfence()
//    before it, or an end state from every tile, cost a few percent more.
//  - Bit-identical carries: the look-back never composes aggregates with
//    each other. Applying them one by one to the scalar performs exactly
//    the multiplications and additions of the serial carry chain
//    (ref.py, carry_chain), whichever tile k it stops at, so the result
//    does not depend on timing and is the same on every run.
//
// The association order is the one the plain version (../ref.py) uses,
// and the build passes --fmad=false so that no multiply-add is fused: the
// kernel and the plain version round alike and agree to the last bit on
// s, which is what lets them be held at rtol 1e-12 even at coeff -> -1.

#include <cuda_runtime.h>
#include <stdint.h>

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
#define INCLUSIVE_EVERY 4          // tiles that publish their end state S
#define LOOK 4                     // predecessors a look-back lane reads a step
#define SPAN (32 * LOOK)
#define FULL_MASK 0xffffffffu

static_assert(THREADS % 32 == 0 && WARPS <= 32, "THREADS: whole warps, at most 32");
static_assert(ITEMS % 2 == 0, "ITEMS: even, for the double2 loads");

enum { EMPTY = 0, AGGREGATE = 1, INCLUSIVE = 2 };

// One tile's look-back record, 32 bytes; the wrapper zeroes them.
struct TileStatus {
    double a, b;    // aggregate: the tile maps its carry-in c to a*c + b
    double s;       // inclusive end state, valid once flag == INCLUSIVE
    int flag;
    int pad;
};

// One step's aggregates, staged for the serial steps: slot q of a step.
struct Window {
    double a[SPAN], b[SPAN];
};

__device__ __forceinline__ int load_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

// The values are written before the call; they become visible with the flag.
__device__ __forceinline__ void publish(TileStatus* rec, int flag) {
    asm volatile("st.release.gpu.global.s32 [%0], %1;" :: "l"(&rec->flag), "r"(flag) : "memory");
}

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

// ITEMS consecutive elements from i0 of a row; zeros past n.
__device__ __forceinline__ void load_items(const double* __restrict__ row,
                                           long long i0, long long n,
                                           bool vec, double (&v)[ITEMS]) {
    if (vec && i0 + ITEMS <= n) {
        const double2* p = reinterpret_cast<const double2*>(row + i0);
#pragma unroll
        for (int k = 0; k < ITEMS / 2; ++k) {
            const double2 x = p[k];
            v[2 * k] = x.x;
            v[2 * k + 1] = x.y;
        }
    } else {
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) v[k] = (i0 + k < n) ? row[i0 + k] : 0.0;
    }
}

__device__ __forceinline__ void store_items(double* __restrict__ row,
                                            long long i0, long long n,
                                            bool vec, const double (&v)[ITEMS]) {
    if (vec && i0 + ITEMS <= n) {
        double2* p = reinterpret_cast<double2*>(row + i0);
#pragma unroll
        for (int k = 0; k < ITEMS / 2; ++k) p[k] = make_double2(v[2 * k], v[2 * k + 1]);
    } else {
#pragma unroll
        for (int k = 0; k < ITEMS; ++k)
            if (i0 + k < n) row[i0 + k] = v[k];
    }
}

// Stages the aggregates of this lane's slots below `want` (tile[r] >= 0;
// else the identity), whose flags f[r] were read with ld.acquire: the
// loads of those already published go out together, a tile still empty
// is waited for on its own.
__device__ __forceinline__ void stage_aggregates(TileStatus* rs, const int (&tile)[LOOK],
                                                 const int (&slot)[LOOK], int want,
                                                 const int (&f)[LOOK], Window &w) {
    double a[LOOK], b[LOOK];
#pragma unroll
    for (int r = 0; r < LOOK; ++r) {
        a[r] = 1.0;
        b[r] = 0.0;
        if (slot[r] < want && tile[r] >= 0 && f[r] != EMPTY) {
            a[r] = __ldcg(&rs[tile[r]].a);
            b[r] = __ldcg(&rs[tile[r]].b);
        }
    }
#pragma unroll
    for (int r = 0; r < LOOK; ++r) {
        if (slot[r] < want && tile[r] >= 0 && f[r] == EMPTY) {
            while (load_acquire(&rs[tile[r]].flag) == EMPTY) __nanosleep(20);
            a[r] = __ldcg(&rs[tile[r]].a);
            b[r] = __ldcg(&rs[tile[r]].b);
        }
    }
#pragma unroll
    for (int r = 0; r < LOOK; ++r) {
        if (slot[r] < want) {
            w.a[slot[r]] = a[r];
            w.b[slot[r]] = b[r];
        }
    }
    __syncwarp();
}

// The carry into tile j of a row (j >= 1), by one whole warp. `rs` is the
// row's status records; every lane returns the same value.
__device__ double look_back(TileStatus* rs, int j, double state, int lane,
                            Window &w) {
    // walk back SPAN tiles a step, slot q = lane + 32 r holding tile
    // base - q, to the nearest inclusive tile k (k = -1 is the row's state,
    // always reached, so the walk itself never waits)
    int base = j - 1;
    double c;
    for (;;) {
        int tile[LOOK], slot[LOOK], f[LOOK];
        int src = SPAN;                       // the nearest inclusive slot
#pragma unroll
        for (int r = 0; r < LOOK; ++r) {
            slot[r] = lane + 32 * r;
            tile[r] = base - slot[r];
            f[r] = tile[r] == -1 ? INCLUSIVE : EMPTY;
            if (tile[r] >= 0) f[r] = load_acquire(&rs[tile[r]].flag);
        }
#pragma unroll
        for (int r = LOOK - 1; r >= 0; --r) {
            const unsigned m = __ballot_sync(FULL_MASK, f[r] == INCLUSIVE);
            if (m) src = 32 * r + __ffs(m) - 1;
        }
        if (src < SPAN) {
            const int k = base - src;
            double s = state;
            if (k >= 0 && lane == (src & 31)) s = __ldcg(&rs[k].s);
            // then the tiles after k in this step: slots src-1 .. 0
            stage_aggregates(rs, tile, slot, src, f, w);
            c = __shfl_sync(FULL_MASK, s, src & 31);
#pragma unroll 8
            for (int q = src - 1; q >= 0; --q) c = w.a[q] * c + w.b[q];
            __syncwarp();
            break;
        }
        base -= SPAN;
    }

    // then the steps between k's and tile j, in order: the serial chain's
    // own multiplications and additions
    for (int first = base + 1; first < j; first += SPAN) {
        const int cnt = min(SPAN, j - first);
        int tile[LOOK], slot[LOOK], f[LOOK];
#pragma unroll
        for (int r = 0; r < LOOK; ++r) {
            slot[r] = lane + 32 * r;          // slot q holds tile first + q
            tile[r] = slot[r] < cnt ? first + slot[r] : -2;
            f[r] = tile[r] >= 0 ? load_acquire(&rs[tile[r]].flag) : EMPTY;
        }
        stage_aggregates(rs, tile, slot, cnt, f, w);
#pragma unroll 8
        for (int q = 0; q < cnt; ++q) c = w.a[q] * c + w.b[q];
        __syncwarp();
    }
    return c;
}

__global__ void __launch_bounds__(THREADS) sim_scan_kernel(
    const double* __restrict__ eps, const double* __restrict__ u_tail,
    const double* __restrict__ u_mag, const double* __restrict__ u_spike,
    const double* __restrict__ state, const double* __restrict__ t0,
    double* __restrict__ t_out, double* __restrict__ s_out,
    TileStatus* __restrict__ status, unsigned* __restrict__ counter,
    long long n, int tiles, double coeff, double tail_prob,
    double tail_shift, double spike_prob, double spike_scale) {
    __shared__ double warp_a[WARPS];
    __shared__ double warp_b[WARPS];
    __shared__ double carry_sh;
    __shared__ unsigned tile_sh;
    __shared__ Window window;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    if (tid == 0) tile_sh = atomicAdd(counter, 1u);
    __syncthreads();
    const unsigned tile = tile_sh;
    const long long row = tile / (unsigned)tiles;
    const int j = (int)(tile % (unsigned)tiles);
    const long long off = row * n;
    const long long i0 = (long long)j * CHUNK + (long long)tid * ITEMS;
    const bool vec = ((reinterpret_cast<uintptr_t>(eps + off)
                       | reinterpret_cast<uintptr_t>(u_tail + off)
                       | reinterpret_cast<uintptr_t>(u_mag + off)
                       | reinterpret_cast<uintptr_t>(u_spike + off)
                       | reinterpret_cast<uintptr_t>(t_out + off)
                       | reinterpret_cast<uintptr_t>(s_out + off)) & 15) == 0;

    // every load of the tile first; the uniforms are cut at once to the
    // tail magnitude and two bits a thread, which frees their registers
    double x[ITEMS], mag[ITEMS];
    unsigned tail = 0, spike = 0;
    {
        double ut[ITEMS], um[ITEMS], us[ITEMS];
        load_items(eps + off, i0, n, vec, x);
        load_items(u_tail + off, i0, n, vec, ut);
        load_items(u_mag + off, i0, n, vec, um);
        load_items(u_spike + off, i0, n, vec, us);
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
            mag[k] = 1.0 + tail_shift * (0.7 + 0.6 * um[k]);
            tail |= (unsigned)(ut[k] < tail_prob) << k;
            spike |= (unsigned)(us[k] < spike_prob) << k;
        }
    }

    // serial scan of this thread's neighbours (zeros past the end: they
    // only feed positions that are never stored)
    double A[ITEMS], B[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        if (k == 0) {
            A[0] = coeff;
            B[0] = x[0];
        } else {
            A[k] = A[k - 1] * coeff;
            B[k] = B[k - 1] * coeff + x[k];
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

    // this thread's prefix (warp prefix o lane prefix), then each item's
    // map from the tile's carry-in: (Ea, Eb) in place of (A, B)
    const double wa = warp_a[warp], wb = warp_b[warp];
    const double pa = wa * xa;
    const double pb = wb * xa + xb;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        B[k] = pb * A[k] + B[k];
        A[k] = pa * A[k];
    }

    // the carry-in, by the last warp: publish the aggregate (the last
    // element's map), then look back
    TileStatus* rs = status + row * tiles;
    double agg_a = 0.0, agg_b = 0.0;
    if (warp == WARPS - 1) {
        agg_a = __shfl_sync(FULL_MASK, A[ITEMS - 1], 31);
        agg_b = __shfl_sync(FULL_MASK, B[ITEMS - 1], 31);
        const double st = state[row];
        if (lane == 0) {
            rs[j].a = agg_a;
            rs[j].b = agg_b;
            publish(&rs[j], AGGREGATE);
        }
        const double carry = j > 0 ? look_back(rs, j, st, lane, window) : st;
        if (lane == 0) carry_sh = carry;
    }
    __syncthreads();
    const double carry = carry_sh;
    // every INCLUSIVE_EVERY-th tile publishes its end state, after the
    // barrier, so the other warps go on to their outputs meanwhile
    if (tid == THREADS - 32 && j % INCLUSIVE_EVERY == INCLUSIVE_EVERY - 1) {
        rs[j].s = agg_a * carry + agg_b;
        publish(&rs[j], INCLUSIVE);
    }

    const double t0r = t0[row];
    double s[ITEMS], t[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        s[k] = A[k] * carry + B[k];
        double d = t0r * exp(s[k]);
        if (tail >> k & 1u) d = d * mag[k];
        if (spike >> k & 1u) d = d * spike_scale;
        t[k] = d;
    }
    store_items(t_out + off, i0, n, vec, t);
    store_items(s_out + off, i0, n, vec, s);
}

// `scratch` holds (rows * ceil(n / CHUNK) + 1) zeroed 32-byte records:
// the tile counter in the first, the tiles' status records after it.
extern "C" int sim_scan_launch(
    const double* eps, const double* u_tail, const double* u_mag,
    const double* u_spike, const double* state, const double* t0,
    double* t_out, double* s_out, void* scratch, long long rows, long long n,
    double coeff, double tail_prob, double tail_shift, double spike_prob,
    double spike_scale, void* stream) {
    // the wrapper checks that rows * tiles fits the grid
    const long long tiles = (n + CHUNK - 1) / CHUNK;
    if (rows <= 0 || n <= 0) return 0;
    TileStatus* recs = static_cast<TileStatus*>(scratch);
    sim_scan_kernel<<<(unsigned)(rows * tiles), THREADS, 0, (cudaStream_t)stream>>>(
        eps, u_tail, u_mag, u_spike, state, t0, t_out, s_out, recs + 1,
        reinterpret_cast<unsigned*>(recs), n, (int)tiles, coeff, tail_prob,
        tail_shift, spike_prob, spike_scale);
    return (int)cudaGetLastError();
}

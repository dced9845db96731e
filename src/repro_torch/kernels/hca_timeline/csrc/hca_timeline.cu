// The true-time timelines of one round of HCA's clock-sync tree, one block
// per (ref, client) pair.
//
// Replaces no TPU kernel: the JAX package runs HCA's tree on the host in
// numpy, one pair at a time (src/repro/core/sync/hca.py,
// learn_model_hca). The port runs each round's pairs together on the card
// (repro_torch/core/sync/hca_device.py); this kernel is the part of that
// round that is a recurrence, so that it rounds as the host's numpy does.
//
// For each pair, from the pair's true times (t_ref, t_cli), on the
// latencies the host drew for it (one row, in the order they were drawn):
//
//   1. `warmup` ping-pongs, then `counted` ping-pongs whose send and
//      receive times are written out (SimNet.pingpong_batch, as
//      compute_rtt runs them);
//   2. the fitpoint sweep, `nseg` segments of `nx` ping-pongs (jk.py,
//      _fitpoint_sweep_true): within a segment the server's times are a
//      running sum; across segments one scalar max per segment;
//   3. the server's and client's times after the sweep.
//
// Every sum is taken in the order numpy takes it (np.cumsum and the
// sweep's loop add one term at a time, left to right), and the build
// passes --fmad=false so that no multiply-add is fused: on the same
// latencies the kernel returns the host path's true times to the bit.
// That keeps the models the tree fits on the card within rounding of the
// host's (the latencies themselves come from the card's exp, which may
// differ from the host's in the last bit).
//
// Bound on an H100: latency, not bandwidth. A round reads every latency
// once (8 B each: 66 MB at p 512's first round of 256 pairs, 200 x 40
// fitpoints, about 20 us at 3.35 TB/s) and writes 16 B per sweep
// exchange; the sequential parts (110 ping-pongs and 200 segment starts
// a pair, on one thread) are chains of dependent loads and adds: about
// 50 us at one pair, 171 us at 256 (chip_smoke.py phase 3b).
// Design: one block per pair; phase A, thread 0: the ping-pongs; phase B,
// all threads, one segment each: the segment's running sum; phase C,
// thread 0: the segment starts; phase D, all threads: the sweep's times.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128

// Python's max(a, b): a unless b is larger.
__device__ __forceinline__ double pymax(double a, double b) { return b > a ? b : a; }

// n >= 1 back-to-back client->server->client exchanges from (tc, tr), as
// SimNet.pingpong_batch computes them; send/recv written when given.
__device__ void pingpongs(const double* l1, const double* l2, long long n,
                          double oh, double oh3, double& tc, double& tr,
                          double* send_out, double* recv_out) {
    const double send0 = tc + oh;
    const double srv0 = pymax(tr, send0 + l1[0]) + oh;
    const double recv0 = (srv0 + l2[0]) + oh;
    if (send_out) {
        send_out[0] = send0;
        recv_out[0] = recv0;
    }
    double run = 0.0, prev = recv0, last_srv = srv0;
    for (long long i = 1; i < n; ++i) {
        run = run + ((oh3 + l1[i]) + l2[i]);      // np.cumsum(3 * oh + lat1 + lat2)
        const double recv = recv0 + run;
        const double send = prev + oh;
        last_srv = (send + l1[i]) + oh;
        if (send_out) {
            send_out[i] = send;
            recv_out[i] = recv;
        }
        prev = recv;
    }
    tc = prev;
    tr = last_srv;
}

__global__ void __launch_bounds__(THREADS)
hca_timeline_kernel(const double* __restrict__ lat, long long row_len,
                    long long o_w2, long long o_c1, long long o_c2, long long o_s1,
                    long long o_s2, long long nx, const double* __restrict__ t_ref,
                    const double* __restrict__ t_cli, double oh, double oh3,
                    double* __restrict__ c_send, double* __restrict__ c_recv,
                    double* __restrict__ srv, double* __restrict__ recv,
                    double* __restrict__ seg, double* __restrict__ t_ref_out,
                    double* __restrict__ t_cli_out) {
    // the row's blocks, in the order the host drew them (ref.py's row_edges)
    const long long warmup = o_w2, counted = o_c2 - o_c1;
    const long long F = o_s2 - o_s1, nseg = F / nx;
    const long long pair = blockIdx.x;
    const double* row = lat + pair * row_len;
    const double* w1 = row;
    const double* w2 = row + o_w2;
    const double* c1 = row + o_c1;
    const double* c2 = row + o_c2;
    const double* s1 = row + o_s1;
    const double* s2 = row + o_s2;
    double* ssl = seg + pair * 3 * nseg;           // each segment's last server time - its first
    double* srl = ssl + nseg;                      // each segment's last receive time - its first server time
    double* start = srl + nseg;                    // each segment's first server time
    double* srv_p = srv + pair * F;
    double* recv_p = recv + pair * F;

    // phase B: each segment's running sum, srv_j - srv_0 (stored in srv)
    for (long long s = threadIdx.x; s < nseg; s += blockDim.x) {
        const double* a1 = s1 + s * nx;
        const double* a2 = s2 + s * nx;
        double* o = srv_p + s * nx;
        double run = 0.0;
        o[0] = 0.0;
        for (long long j = 1; j < nx; ++j) {
            run = run + ((a2[j - 1] + a1[j]) + oh3);
            o[j] = run;
        }
        ssl[s] = run;
        srl[s] = (run + a2[nx - 1]) + oh;
    }
    __syncthreads();

    // phases A and C: the ping-pongs, then the segments' starts, in order
    if (threadIdx.x == 0) {
        double tc = t_cli[pair], tr = t_ref[pair];
        if (warmup > 0) pingpongs(w1, w2, warmup, oh, oh3, tc, tr, nullptr, nullptr);
        if (counted > 0)
            pingpongs(c1, c2, counted, oh, oh3, tc, tr, c_send + pair * counted,
                      c_recv + pair * counted);
        for (long long s = 0; s < nseg; ++s) {
            const double send0 = tc + oh;
            const double s0 = pymax(tr, send0 + s1[s * nx]) + oh;
            start[s] = s0;
            tr = s0 + ssl[s];
            tc = s0 + srl[s];
        }
        t_ref_out[pair] = tr;
        t_cli_out[pair] = tc;
    }
    __syncthreads();

    // phase D: srv = start + (srv_j - srv_0), recv = srv + lat2 + oh
    for (long long e = threadIdx.x; e < F; e += blockDim.x) {
        const double v = start[e / nx] + srv_p[e];
        srv_p[e] = v;
        recv_p[e] = (v + s2[e]) + oh;
    }
}

extern "C" int hca_timeline_launch(
    const double* lat, long long pairs, long long row_len, long long o_w2,
    long long o_c1, long long o_c2, long long o_s1, long long o_s2, long long nx,
    const double* t_ref, const double* t_cli, double oh, double oh3,
    double* c_send, double* c_recv,
    double* srv, double* recv, double* seg, double* t_ref_out,
    double* t_cli_out, void* stream) {
    // the wrapper checks the shapes and that pairs fits the grid
    if (pairs <= 0) return 0;
    hca_timeline_kernel<<<(unsigned)pairs, THREADS, 0, (cudaStream_t)stream>>>(
        lat, row_len, o_w2, o_c1, o_c2, o_s1, o_s2, nx, t_ref, t_cli, oh, oh3, c_send,
        c_recv, srv, recv, seg, t_ref_out, t_cli_out);
    return (int)cudaGetLastError();
}

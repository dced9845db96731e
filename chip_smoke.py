#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build the kernels from
this checkout, hold each against its plain PyTorch version on the card,
drive the paths (the simulated measurement campaign, the kernel A/B
campaign, on random-walk clocks campaigns and the barrier scheme, the
factor sweeps, drift audit and calibration over the campaign, the
performance-guideline family and the fault-tolerant sweep fleet) at sizes
users run, and check what comes out.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases, each of which raises (exit code 1) on failure:

  1. device: the card's name and power limit, torch / CUDA / nvcc versions;
  2. build: the ``sim_scan``, ``flash_attention`` (CUDA cores, bf16 at
     head dims 16 and 32), ``flash_attention_sm90`` (tensor cores, bf16),
     ``flash_attention_tf32`` (tensor cores, f32 in 3xTF32) and
     ``ssd_scan`` CUDA sources, from ``src/repro_torch/kernels`` into
     ``build/kernels/``,
     one ``nvcc`` each, all started together; each build's time and its
     ptxas lines (registers, spills, shared memory, performance warnings);
  3. ``sim_scan`` against its plain version on the card over a grid of
     AR(1) coefficients and shapes (R in {1, 30, 200}, lengths around one
     tile and 1e5), each case launched twice and held bit-identical, then
     its times at the main path's two shapes (the fused R = 30 call and an
     R = 1 top-up, n = 1e5) beside its memory bound;
  4. both engines on the card against the port on the CPU, noise-free
     from the same state (a device-only fault shows here), and the fused
     engine against the per-epoch one on the card under live noise, bit
     for bit;
  5. the archived reference audit campaign
     (``benchmarks/reference_archive/run-000.jsonl``) on the card: each
     cell's median of per-epoch medians within ±10% of the archive's, and
     no cell DRIFTED under the port's own ``audit_tables``;
  6. the main path at a size users run: p = 512 ranks, 30 launch epochs,
     nrep = 100 000, hca sync, allreduce/bcast/alltoall at 4096 B, fused,
     with its time split into host sync, sampling and window, and the
     shapes ``sim_scan`` was launched at; one epoch of the same shape
     through the CPU path for scale and as a cross-check;
  7. ``flash_attention`` against its plain version on the card over the
     reference's shape grid (GQA, MQA, MHA, head dims 16-256), f32 and
     bf16, sliding window, soft-cap, decode, ragged and fully masked rows
     (which must be 0), at the reference's bounds, plus the bf16
     tensor-core instance's own grid at head dims 64, 128 and 256, the f32
     (3xTF32) instance's on the same grid at head dims 16-256, and both
     instances' layout probes; each call checked to have run through the
     instance its type and head dim select; then the f32 and bf16 times
     at gemma2-2b widths (S = T = 4096, causal) beside the bound, the
     plain version and ``scaled_dot_product_attention``;
  8. ``ssd_scan`` against its plain version over the reference's grid,
     head dims that are not multiples of the p-tile, ragged chunks and the
     sequential recurrence, f32 and bf16; then its times at mamba2-1.3b
     widths (S = 1024 and 4096, chunk 64) in both types beside its bound
     and the plain version;
  9. the kernel A/B path: the kernel guideline family
     (``flash_attention#cuda ⪯ flash_attention#ref``, ``ssd_scan#cuda ⪯
     ssd_scan#ref``) through ``verify_guidelines`` at gemma2-2b and
     mamba2-1.3b widths, S in {1024, 4096}, with a store, first in the
     reference's f32 (the 3xTF32 flash instance), then in bf16 (the
     bf16 tensor-core flash instance); a
     violated guideline (a kernel slower than its plain version) is
     printed, not failed;
 10. random-walk clocks (``rw_sigma`` 1e-7) through the per-epoch engine:
     card == CPU at atol 1e-12, noise-free from the same state (drift
     paths grown on the host, inverted and read on the card), and the
     fused engine's refusal;
 11. random-walk campaigns: phase 5's archive spec on walking clocks
     (each cell within ±10%, every record per epoch), then p = 512, 4
     epochs, nrep = 100 000, hca, allreduce at 4096 B, with its wall split
     into clock sync, drift-path growth and uploads, device spans and
     top-ups, its invalid fraction, ``sim_scan`` launches and peak memory;
 12. the barrier scheme: ``run_barrier_timed`` card == CPU at atol 1e-12,
     noise-free, on affine and walking clocks; then Figs. 11-12's settings
     at p = 512, nrep 10 000 (the barrier's local-max mean must exceed the
     window scheme's global mean) with both barriers' skew profiles;
 13. factor sweeps: the stock sweep (tuning, sync_method, window_us,
     dtype; 16 cells) at p = 512, nrep 10 000, 6 epochs, allreduce at 512
     and 4096 B, with a store (sync_method then tuning MATTERS, as the
     reference ranks them at this width; each axis's verdict, effect size
     and Holm p, each cell's wall and invalid fraction), then the
     reference's racing smoke sweep (tuning x dtype, p = 8), its replay
     from the store (nothing measured, the same verdicts) and its twin on
     two spawned workers (per-cell tables bit-equal);
 14. the drift audit: phase 5's campaign registered into a copy of
     ``benchmarks/reference_archive/`` and audited against it (no cell
     DRIFTED), then the mis-tuned bcast control (exactly bcast DRIFTED);
 15. the sim calibration at the reference's spec
     (``benchmarks/reference_calibration.json``): ``op.alpha`` within 10%
     of its 6.25e-06, no held-out cell DRIFTED, and a replay from the
     store that measures nothing;
 16. the PGMPI guideline family (``SIM_GUIDELINES``) at p = 512, nrep
     1e4, 8 epochs: the honest library (10 cells, none VIOLATED), then an
     inflated alltoall (only the mock-up bound VIOLATED) and an inflated
     allgather (pattern containment above 1, not significant at this
     width), each cell's verdict the reference's at p = 512; walls,
     ratios, Holm p, invalid fractions and ``sim_scan`` launches;
 17. the fault-tolerant fleet: the serial tuning x dtype sweep at p = 512,
     nrep 1e4 (4 cells, fused); the same sweep on three workers forked
     from a fork server under the CI chaos spec (every record's exact
     times equal the serial run's, none quarantined, the shards
     compacted, no launch in this process), which sets the lease for the
     rest of the phase from the measured start-up and heartbeat gaps; the
     CI quarantine spec at p = 8 on two workers (cells 0 and 2
     quarantined, the survivors equal serial, a fault-free resume
     measures exactly those two); a straggler on every first attempt
     (the run ends long before the stall); the in-process fleet under
     soft crashes (equal to serial);
 18. a ``kernels`` JSON line for every kernel of the paths, flash and SSD
     once per type; ``sim_scan``'s entry counts its launches on the main
     path, on the two paths of phases 11 and 12, on the three of phases
     13-15 and on phases 16 and 17 (this process only).

Every timed kernel in phases 3, 7 and 8 has ``nvidia-smi``'s SM clock
(now and max), power draw and temperature, sampled right before and after
it, printed beside its time.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
``nvidia-smi``'s name and power limit. Without a GPU, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import copy
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP64_FLOPS = 34e12          # H100 SXM float64 outside the tensor cores
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
TF32_FLOPS = 495e12         # H100 SXM TF32 tensor cores, dense (3 per f32 FLOP in 3xTF32)
BF16_FLOPS = 989e12         # H100 SXM bf16 tensor cores, dense

# gemma2-2b attention widths (src/repro/configs/gemma2_2b.py): 8 query
# heads, 4 KV heads, head_dim 256; mamba2-1.3b SSD widths
# (src/repro/configs/mamba2_1_3b.py): d_inner 4096 / head_dim 64 = 64
# heads, head_dim 64, state 128.
GEMMA2_ATTN = dict(heads=8, kv_heads=4, head_dim=256)
MAMBA2_SSD = dict(heads=64, head_dim=64, state_dim=128)
AB_SEQS = (1024, 4096)
NOISE_FREE = dict(noise_sigma=0.0, tail_prob=0.0, spike_prob=0.0,
                  rank_imbalance=0.0, epoch_bias_sigma=0.0, autocorr=0.0)
RW_SIGMA = 1e-7          # s/sqrt(s), the reference's windowed rw micro-bench


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def clocks() -> str:
    """The card's SM clock (now, max), power draw and temperature."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def clocked(timer) -> tuple[float, str]:
    """``timer()`` (a time in ms) with ``nvidia-smi`` sampled right before
    and after it: ``(ms, "[before -> after]")``."""
    before = clocks()
    ms = timer()
    return ms, f"[sm clock, max, power, temp: {before} -> {clocks()}]"


def cuda_ms(fn, reps: int, queued: bool = False) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, after a warm-up.

    ``queued``: the stream is held by a spin kernel (~100 us per call)
    while the host queues the calls, so the events time the device's work
    back to back, not the host's enqueue rate, for calls shorter than
    their host overhead."""
    import torch

    fn()
    if queued:
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2e5 * reps))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def trace(torch, fn, reps=5) -> tuple[dict, float]:
    """``torch.profiler`` over ``reps`` calls of ``fn`` after a warm-up:
    device time per call of each kernel (by name, cut to 60 characters)
    and the share of the calls' CUDA-event span the kernels fill."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    span = start.elapsed_time(end)
    per_kernel = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        per_kernel[e.key[:60]] = per_kernel.get(e.key[:60], 0.0) + us / 1e3 / reps
    return per_kernel, sum(per_kernel.values()) * reps / span if span else 0.0


def trace_line(per_kernel, busy) -> str:
    if not per_kernel:
        return "the profiler recorded no device time"
    return ("; ".join(f"{k} {v:.4f} ms/call" for k, v in
                      sorted(per_kernel.items(), key=lambda kv: -kv[1]))
            + f"; kernels fill {busy:.3f} of the calls' span")


class Spans:
    """CUDA events around each call of a wrapped function: the device time
    from the first operation a step enqueues to its last, idle gaps
    included. Only this script wraps; the library carries no timers."""

    def __init__(self):
        self.events: dict[str, list] = {}

    def wrap(self, name, fn):
        import torch

        def timed(*args, **kw):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.events.setdefault(name, []).append((start, end))
            return out
        return timed

    def ms(self, name) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events.get(name, []))


def phase_device(torch):
    from repro_torch.kernels.build import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"# [1 device] {smi()} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | nvcc: {nvcc} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.flash_attention.kernel import load_kernel as load_flash
    from repro_torch.kernels.flash_attention.kernel import load_kernel_sm90 as load_flash90
    from repro_torch.kernels.flash_attention.kernel import load_kernel_tf32 as load_flash32
    from repro_torch.kernels.sim_scan.kernel import load_kernel as load_sim
    from repro_torch.kernels.ssd_scan.kernel import load_kernel as load_ssd

    def timed(load):
        t = time.perf_counter()
        _, log = load()
        return time.perf_counter() - t, log

    t0 = time.perf_counter()
    loads = dict(sim_scan=load_sim, flash_attention=load_flash,
                 flash_attention_sm90=load_flash90, flash_attention_tf32=load_flash32,
                 ssd_scan=load_ssd)
    with ThreadPoolExecutor(len(loads)) as pool:     # one nvcc per source at once
        futures = {name: pool.submit(timed, load) for name, load in loads.items()}
        results = {name: f.result() for name, f in futures.items()}
    def short(line):
        """A ptxas line with the mangled kernel name cut to its name and
        template arguments (``flash_fwd_sm90ILi256E``)."""
        line = line.strip().removeprefix("ptxas info    : ")
        m = re.search(r"'_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+\d+(\w+?I\w*?E)E*v\w*'", line)
        return line[:m.start()] + m.group(1) if m else line[:80]

    for name, (secs, log) in results.items():
        info = [short(ln) for ln in log.splitlines()
                if "registers" in ln or "spill" in ln or "entry function" in ln
                or "Performance" in ln]
        print(f"# [2 build] {name} built and loaded in {secs:.2f} s; "
              + " | ".join(info))
    print(f"# [2 build] all {len(loads)} in {time.perf_counter() - t0:.2f} s")


def scan_inputs(torch, R, n, gen):
    f64 = dict(dtype=torch.float64, device="cuda")
    return dict(eps=0.04 * torch.randn(R, n, generator=gen, **f64),
                u_tail=torch.rand(R, n, generator=gen, **f64),
                u_mag=torch.rand(R, n, generator=gen, **f64),
                u_spike=torch.rand(R, n, generator=gen, **f64),
                state=0.1 * torch.randn(R, generator=gen, **f64),
                t0=1e-5 + 2e-5 * torch.rand(R, generator=gen, **f64))


def scan_call(fn, x, coeff):
    return fn(x["eps"], x["u_tail"], x["u_mag"], x["u_spike"], coeff=coeff,
              state=x["state"], t0=x["t0"], tail_prob=0.08, tail_shift=0.35,
              spike_prob=0.003, spike_scale=8.0)


def phase_kernel(torch) -> dict:
    from repro_torch.kernels.sim_scan import sim_durations_ref, sim_durations_scan
    from repro_torch.kernels.sim_scan.ref import ITEMS, THREADS

    chunk = THREADS * ITEMS          # one tile of the kernel
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2015)
    launches0 = sim_durations_scan.launches
    n_cases, max_err, max_s_err = 0, 0.0, 0.0
    for coeff in (0.35, 0.0, -0.5, 0.9, 0.004, -0.999):
        for n in (32, 1000, chunk - 1, chunk, chunk + 1, 100_000):
            for R in (1, 30, 200):    # 200: more rows than the card has SMs
                x = scan_inputs(torch, R, n, gen)
                t, s = scan_call(sim_durations_scan, x, coeff)
                t2, s2 = scan_call(sim_durations_scan, x, coeff)
                torch.cuda.synchronize()
                what = f"coeff={coeff} R={R} n={n}"
                require(torch.equal(t, t2) and torch.equal(s, s2),
                        f"sim_scan {what}: two launches bit-identical")
                tr, sr = scan_call(sim_durations_ref, x, coeff)
                n_cases += 1
                require(torch.allclose(t, tr, rtol=1e-12, atol=1e-18),
                        f"sim_scan t vs plain, {what}: "
                        f"max |err| {(t - tr).abs().max().item():.3e}")
                require(torch.allclose(s, sr, rtol=1e-12, atol=1e-14),
                        f"sim_scan s vs plain, {what}: "
                        f"max |err| {(s - sr).abs().max().item():.3e}")
                s_err = (s - sr).abs().max().item()
                max_s_err = max(max_s_err, s_err)
                max_err = max(max_err, (t - tr).abs().max().item(), s_err)
                del x, t, s, t2, s2, tr, sr
    require(sim_durations_scan.launches - launches0 == 2 * n_cases,
            "sim_scan launch counter rose once per call")
    torch.cuda.empty_cache()
    print(f"# [3 kernel] sim_scan == plain on {n_cases} cases (R 1/30/200, n 32 to "
          f"1e5 around the {chunk}-element tile; rtol 1e-12; atol 1e-18 t, 1e-14 s), "
          f"max |err| {max_err:.3e}, s max |err| {max_s_err:.3e}; every case "
          "launched twice, bit-identical")

    rows = {}
    for R, n in ((30, 100_000), (1, 100_000)):   # the fused call; a top-up
        x = scan_inputs(torch, R, n, gen)
        kernel = lambda: scan_call(sim_durations_scan, x, 0.35)  # noqa: E731
        ms, clk = clocked(lambda: cuda_ms(kernel, 100, queued=True))
        loop_ms = cuda_ms(kernel, 100)
        plain_ms = cuda_ms(lambda: scan_call(sim_durations_ref, x, 0.35), 5)
        nbytes = R * n * 6 * 8 + 2 * R * 8        # 4 inputs + 2 outputs, f64
        nops = R * n * 12                         # scan 2, exp 1, mixture 9
        bound_ms = max(nbytes / HBM_BYTES_PER_S, nops / FP64_FLOPS) * 1e3
        rows[R] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        print(f"# [3 kernel] sim_scan R={R} n={n}: kernel {ms:.4f} ms (calls queued "
              f"ahead; {loop_ms:.4f} ms as a plain loop of calls) {clk}, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB at "
              f"3.35 TB/s), {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, "
              f"{bound_ms / ms:.3f} of the bound")
        del x
    r30, r1 = rows[30], rows[1]
    return dict(name="sim_scan", route="cuda",
                source="src/repro_torch/kernels/sim_scan/csrc/sim_scan.cu",
                replaces="src/repro/kernels/sim_scan/kernel.py:87",
                max_abs_err=max_err, ms=r30["ms"], plain_ms=r30["plain_ms"],
                bound_ms=r30["bound_ms"], bound_by="bytes", library_ms=None,
                ms_r1=r1["ms"], plain_ms_r1=r1["plain_ms"], bound_ms_r1=r1["bound_ms"])


def phase_engines(torch):
    import numpy as np

    from repro_torch.core import SimNet, make_op, make_sync
    from repro_torch.simengine import run_windowed_epochs_torch, run_windowed_torch

    def epochs(E, p, **op_kw):
        out = []
        for e in range(E):
            net = SimNet(p, seed=5 + 1000 * e)
            sync = make_sync("hca", n_fitpts=100, n_exchanges=20).synchronize(net)
            out.append((net, sync, make_op("allreduce", **op_kw)))
        return out

    cpu = epochs(1, 16, **NOISE_FREE)
    gpu = copy.deepcopy(cpu)
    a = run_windowed_torch(*cpu[0], 4096, 2000, 300e-6, device="cpu")
    b = run_windowed_torch(*gpu[0], 4096, 2000, 300e-6, device="cuda")
    require(np.array_equal(a.errors, b.errors), "per-epoch error flags cuda == cpu")
    for k in ("times", "start_true", "end_true", "start_global_est",
              "end_global_est"):
        err = np.abs(getattr(a, k) - getattr(b, k)).max()
        require(err <= 1e-12, f"per-epoch {k} cuda vs cpu |err| {err:.3e} <= 1e-12")
    require(np.abs(cpu[0][0].t - gpu[0][0].t).max() <= 1e-12, "per-epoch net.t")

    cpu = epochs(3, 16, **NOISE_FREE)
    gpu = copy.deepcopy(cpu)
    ref = [run_windowed_torch(*c, 4096, 5000, 300e-6, device="cpu") for c in cpu]
    fused = run_windowed_epochs_torch(*map(list, zip(*gpu)), 4096, 5000,
                                      300e-6, device="cuda")
    for r, f in zip(ref, fused):
        require(np.array_equal(r.errors, f.errors), "fused error flags cuda == cpu")
        require(np.allclose(f.times, r.times, rtol=1e-5, atol=0),
                "fused times on cuda vs per-epoch on cpu within rtol 1e-5")
    # live noise: on the card, the fused engine is the per-epoch engine bit
    # for bit (lanes drawn bit-identically, the same float64 window), which
    # the fleet's "faulted attempts (per epoch) == serial (fused)" rests on
    live = epochs(4, 64)
    fused_live = copy.deepcopy(live)
    per_epoch = [run_windowed_torch(*c, 4096, 20_000, 400e-6, device="cuda") for c in live]
    fused = run_windowed_epochs_torch(*map(list, zip(*fused_live)), 4096, 20_000,
                                      400e-6, device="cuda")
    for (net_u, _, op_u), (net_f, _, op_f), u, f in zip(live, fused_live, per_epoch, fused):
        require(np.array_equal(u.times, f.times) and np.array_equal(u.errors, f.errors)
                and np.array_equal(net_u.t, net_f.t) and op_u._ar_state == op_f._ar_state,
                "live noise: fused == per-epoch on the card, bit for bit")
    print("# [4 engines] noise-free: per-epoch cuda == cpu at atol 1e-12 "
          "(p=16, nrep 2000); fused cuda == per-epoch cpu at rtol 1e-5 "
          "(3 epochs, nrep 5000), identical error flags; live noise: fused == "
          "per-epoch on the card bit for bit (4 epochs, p=64, nrep 20 000)")


def phase_gate(torch):
    import numpy as np

    from repro_torch.campaign import Campaign, CampaignSpec, ResultStore, TorchSimBackend
    from repro_torch.core import ExperimentDesign, TestCase
    from repro_torch.history import audit_tables
    from repro_torch.kernels.sim_scan import sim_durations_scan

    archive = ResultStore(ROOT / "benchmarks" / "reference_archive"
                          / "run-000.jsonl").to_table()
    cases = [TestCase(op, m) for op in ("allreduce", "bcast", "alltoall")
             for m in (512, 4096)]
    backend = TorchSimBackend(p=8, seed0=0, sync_kw=dict(n_fitpts=60, n_exchanges=20))
    launches0 = sim_durations_scan.launches
    res = Campaign(CampaignSpec(cases, ExperimentDesign(n_launch_epochs=12, nrep=40,
                                                        seed=0), name="repro-audit"),
                   backend).run()
    launches = sim_durations_scan.launches - launches0
    require(launches > 0, "gate campaign launched sim_scan")
    require(all(r.meta["engine"] == "torch" and r.meta["device"].startswith("cuda")
                for r in res.records), "gate records say engine=torch on cuda")
    cells = []
    for case in cases:
        ours = float(np.median(res.table.medians(case)))
        theirs = float(np.median(archive.medians(case)))
        ratio = ours / theirs
        require(abs(ratio - 1.0) <= 0.10,
                f"gate {case.op}/{case.msize}: median ratio {ratio:.4f} within ±10%")
        cells.append(f"{case.op}/{case.msize} {ratio:.4f}")
    report = audit_tables(archive, res.table)
    require(not report.drifted(), "gate: the port's audit finds no DRIFTED cell")
    n_eq = sum(c.verdict == "EQUIVALENT" for c in report.cells)
    print(f"# [5 gate] archive spec on the card ({launches} sim_scan launches): "
          "median-of-epoch-medians ratio to the archive: " + ", ".join(cells)
          + f"; the port's audit_tables (TOST ±10%, Holm): {n_eq}/{len(report.cells)} "
          "EQUIVALENT, 0 DRIFTED")


def phase_main_path(torch) -> int:
    import numpy as np

    from repro_torch import simengine
    from repro_torch.campaign import Campaign, CampaignSpec, TorchSimBackend
    from repro_torch.campaign import backends
    from repro_torch.core import ExperimentDesign, TestCase
    from repro_torch.kernels.sim_scan import sim_durations_scan

    p, epochs, nrep = 512, 30, 100_000
    cases = [TestCase(op, 4096) for op in ("allreduce", "bcast", "alltoall")]
    spans = Spans()
    host: dict[str, list] = {}

    def host_timed(name, fn):
        def timed(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            host.setdefault(name, []).append(time.perf_counter() - t)
            return out
        return timed

    # the kernel's launches by shape, and its device span by row count
    shapes: collections.Counter = collections.Counter()
    by_rows: dict = {}
    kernel = simengine.sim_durations_scan

    def kernel_by_shape(eps, *args, **kw):
        R, n = eps.shape
        if R and n:                 # an empty call launches nothing
            shapes[R, n] += 1
        if R not in by_rows:
            by_rows[R] = spans.wrap(f"sim_scan R={R}", kernel)
        return by_rows[R](eps, *args, **kw)

    # (module, attribute, wrapper): device spans inside the engine, host
    # time of each step the backend calls
    patches = [(simengine, name, spans.wrap(name, getattr(simengine, name)))
               for name in ("_sample", "_window")]
    patches.append((simengine, "sim_durations_scan", kernel_by_shape))
    patches += [(backends, name, host_timed(name, getattr(backends, name)))
                for name in ("run_windowed_epochs_torch", "run_windowed_torch")]
    patches.append((backends.TorchSimBackend, "make_epoch",
                    host_timed("make_epoch", backends.TorchSimBackend.make_epoch)))
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        spec = CampaignSpec(cases, ExperimentDesign(n_launch_epochs=epochs, nrep=nrep,
                                                    seed=0), name="main-path")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sim_durations_scan.launches = 0
        t = time.perf_counter()
        res = Campaign(spec, TorchSimBackend(p=p, seed0=0)).run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = sim_durations_scan.launches
        peak = torch.cuda.max_memory_allocated()
    finally:
        for obj, name, fn in originals:
            setattr(obj, name, fn)
    sample_ms = spans.ms("_sample")
    rows_ms = {R: spans.ms(f"sim_scan R={R}") for R in sorted(by_rows)}
    kernel_ms = sum(rows_ms.values())
    window_ms = spans.ms("_window")
    sync_s = host.get("make_epoch", [])
    fused_s = host.get("run_windowed_epochs_torch", [])
    topup_s = host.get("run_windowed_torch", [])

    require(launches > 0, "main path launched sim_scan")
    require(len(res.records) == epochs * len(cases), "one record per case x epoch")
    for r in res.records:
        require(r.meta["engine"] == "torch" and r.meta["device"].startswith("cuda")
                and r.meta["fused"], "main-path records: engine=torch, cuda, fused")
        # at most nrep valid times survive the window discards and top-ups
        require(0 < r.times.size <= nrep and np.isfinite(r.times).all()
                and (r.times > 0).all(),
                f"main-path {r.case.op} epoch {r.epoch}: {r.times.size} valid "
                f"times, finite and positive")
    kept = {c.op: [r.times.size / nrep for r in res.records if r.case.op == c.op]
            for c in cases}
    print(f"# [6 main path] p={p} epochs={epochs} nrep={nrep} hca fused "
          f"allreduce/bcast/alltoall@4096: wall {wall:.2f} s = host sync "
          f"{sum(sync_s):.2f} s ({len(sync_s)} epochs) + fused engine calls "
          f"{sum(fused_s):.2f} s ({len(fused_s)} calls) + per-epoch top-up calls "
          f"{sum(topup_s):.2f} s ({len(topup_s)} calls) + rest "
          f"{wall - sum(sync_s) - sum(fused_s) - sum(topup_s):.2f} s; device spans: sampling "
          f"{sample_ms / 1e3:.3f} s (sim_scan kernel {kernel_ms / 1e3:.4f} s), "
          f"window {window_ms / 1e3:.3f} s; kernel share of device spans "
          f"{kernel_ms / (sample_ms + window_ms):.4f}, of wall "
          f"{kernel_ms / 1e3 / wall:.5f}; sim_scan launches {launches}; peak "
          f"device memory {peak / 2**30:.2f} GiB; "
          f"dispatches {res.meta['dispatch']}; valid share per record after "
          "top-ups (min/mean): " + ", ".join(
              f"{op} {min(v):.4f}/{sum(v) / len(v):.4f}" for op, v in kept.items()))

    require(sum(shapes.values()) == launches, "every sim_scan launch seen by shape")
    groups = []
    for R, ms in rows_ms.items():
        ns = sorted(n for (r, n), c in shapes.items() if r == R for _ in range(c))
        groups.append(f"R={R}: {len(ns)} launches, n {ns[0]}/{ns[len(ns) // 2]}/"
                      f"{ns[-1]} (min/median/max), device span {ms / 1e3:.4f} s "
                      f"({ms / len(ns):.4f} ms per launch)")
    print("# [6 sim_scan] launches by rows: " + "; ".join(groups)
          + "; most launched shapes (R, n): " + ", ".join(
              f"{k} x{c}" for k, c in shapes.most_common(5)))

    # one epoch of the same shape through the CPU path: epoch 0 has the same
    # host state and case order, so its medians must agree with the card's
    cpu_spec = CampaignSpec(cases, ExperimentDesign(n_launch_epochs=1, nrep=nrep,
                                                    seed=0), name="main-path-cpu")
    t = time.perf_counter()
    cpu = Campaign(cpu_spec, TorchSimBackend(p=p, seed0=0, device="cpu")).run()
    cpu_s = time.perf_counter() - t
    gpu0 = {(r.case.op, r.epoch): r for r in res.records if r.epoch == 0}
    ratios = []
    for r in cpu.records:
        ratio = float(np.median(gpu0[(r.case.op, 0)].times) / np.median(r.times))
        require(abs(ratio - 1.0) < 0.05,
                f"epoch-0 median {r.case.op}: cuda/cpu {ratio:.4f} within 5%")
        ratios.append(f"{r.case.op} {ratio:.4f}")
    print(f"# [6 cpu] one epoch of the same shape on the CPU path: {cpu_s:.2f} s "
          f"(card: {wall / epochs:.2f} s per epoch); epoch-0 median cuda/cpu: "
          + ", ".join(ratios))
    return launches


def rel_err(a, b) -> float:
    """max |a - b| / max |b|, in float32."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def attn_bound_ms(b, s, t, h, hkv, d, nbytes, flops_peak, causal=True,
                  q_offset=0):
    """Least time for attention: the two products over the (q, k) pairs the
    mask leaves, or q, k, v read and o written once, whichever is longer."""
    if causal:
        pairs = sum(min(t, q_offset + i + 1) for i in range(s))
    else:
        pairs = s * t
    flops = 4.0 * b * h * d * pairs
    moved = nbytes * (2 * b * s * h * d + 2 * b * t * hkv * d)
    return bound(flops, flops_peak, moved) + (flops, moved)


def bound(flops, flops_peak, moved) -> tuple[float, str]:
    """``(bound_ms, bound_by)``: the larger of operations over the peak rate
    and bytes over the memory rate."""
    ops_ms = flops / flops_peak * 1e3
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def visible_keys(torch, s, t, q_offset=0, causal=True, window=None, kv_len=None, **_):
    """``(vis, dead)``: the (s, t) mask of keys each query row sees, and the
    rows that see none."""
    qpos = torch.arange(s, device="cuda")[:, None] + q_offset
    kpos = torch.arange(t, device="cuda")[None, :]
    vis = torch.ones(s, t, dtype=torch.bool, device="cuda")
    if causal:
        vis &= kpos <= qpos
    if window is not None:
        vis &= (qpos - kpos) < window
    if kv_len is not None:
        vis &= kpos < kv_len
    return vis, ~vis.any(dim=1)


def phase_flash(torch) -> tuple[dict, dict]:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.flash_attention.kernel import kernel_instance

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2024)

    def rnd(*shape, dtype=torch.float32, scale=1.0):
        x = scale * torch.randn(*shape, generator=gen, device="cuda")
        return x.to(dtype)

    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    cases = []   # (label, q, k, v, kw, tolerance[, plain version in f32])
    for b, s, h, hkv, d in ((2, 256, 4, 2, 64), (1, 512, 8, 1, 64),
                            (2, 128, 4, 4, 128), (1, 256, 8, 2, 32),
                            (1, 256, 8, 4, 256), (1, 128, 4, 2, 16)):
        for dt in (torch.float32, torch.bfloat16):
            cases.append((f"b{b} s{s} h{h}/{hkv} d{d} {dt}".replace("torch.", ""),
                          rnd(b, s, h, d, dtype=dt), rnd(b, s, hkv, d, dtype=dt),
                          rnd(b, s, hkv, d, dtype=dt), {}, tol[dt]))
    for w in (32, 128):
        cases.append((f"window {w}", rnd(2, 256, 4, 64), rnd(2, 256, 2, 64),
                      rnd(2, 256, 2, 64), dict(window=w), 2e-5))
    # bf16 soft-cap: the plain version, like the JAX oracle, rounds the
    # logits to bf16 before the cap (its einsum returns the input type), an
    # error of up to 0.125 in a logit near 30; the kernels, like the Pallas
    # kernel, keep logits in f32. So it is held against the plain version
    # run in f32 on the same bf16 values, at the bf16 bound.
    for dt in (torch.float32, torch.bfloat16):
        cases.append((f"softcap 30 {dt}".replace("torch.", ""),
                      rnd(1, 256, 4, 64, dtype=dt, scale=3),
                      rnd(1, 256, 4, 64, dtype=dt, scale=3), rnd(1, 256, 4, 64, dtype=dt),
                      dict(logit_cap=30.0), 3e-5 if dt == torch.float32 else 2e-2,
                      dt == torch.bfloat16))
    cases.append(("decode q_offset 100 kv_len 172", rnd(2, 128, 4, 64),
                  rnd(2, 256, 2, 64), rnd(2, 256, 2, 64),
                  dict(q_offset=100, kv_len=172), 2e-5))
    for dt in (torch.float32, torch.bfloat16):
        cases.append((f"decode S=1 gemma2 {dt}".replace("torch.", ""),
                      rnd(2, 1, 8, 256, dtype=dt), rnd(2, 300, 4, 256, dtype=dt),
                      rnd(2, 300, 4, 256, dtype=dt),
                      dict(q_offset=171, kv_len=172, window=4096), tol[dt]))
    cases.append(("non-causal ragged S=100 T=77", rnd(1, 100, 4, 32),
                  rnd(1, 77, 2, 32), rnd(1, 77, 2, 32), dict(causal=False), 2e-5))
    cases.append(("gemma2 S=1024 f32", rnd(1, 1024, 8, 256), rnd(1, 1024, 4, 256),
                  rnd(1, 1024, 4, 256), {}, 2e-5))
    cases.append(("gemma2 S=1024 bf16", *(rnd(1, 1024, n, 256, dtype=torch.bfloat16)
                                          for n in (8, 4, 4)), {}, 2e-2))
    # the tensor-core instance at each of its head dims: ragged S and T (not
    # multiples of 128 or 64), GQA groups 1, 2 and 8, a window under one
    # tile, decode and prefill at an offset, soft-cap (against the plain
    # version in f32, as above), fully masked rows
    # (the f32 tensor-core instance on the same grid at every head dim, at
    # the f32 bounds: 2e-5, 3e-5 with soft-cap, against the plain version)
    bf16 = torch.bfloat16
    grid = (("causal ragged S=T=200 group 2", (2, 200, 200, 4, 2), {}),
            ("non-causal S=100 T=77 group 8", (1, 100, 77, 8, 1), dict(causal=False)),
            ("causal S=T=384 group 1", (1, 384, 384, 4, 4), {}),
            ("window 32", (2, 256, 256, 4, 2), dict(window=32)),
            ("decode S=1", (2, 1, 300, 8, 4), dict(q_offset=171, kv_len=172)),
            ("prefill q_offset 100 kv_len 172", (1, 130, 256, 4, 2),
             dict(q_offset=100, kv_len=172)),
            ("softcap 30", (1, 256, 256, 4, 2), dict(logit_cap=30.0)))
    for dt, dims in ((bf16, (64, 128, 256)), (torch.float32, (16, 32, 64, 128, 256))):
        for d in dims:
            for label, (b, s, t, h, hkv), kw in grid:
                scale = 3 if "logit_cap" in kw else 1
                limit = 2e-2 if dt == bf16 else (3e-5 if "logit_cap" in kw else 2e-5)
                cases.append((f"{str(dt)[6:]} d{d} {label}",
                              rnd(b, s, h, d, dtype=dt, scale=scale),
                              rnd(b, t, hkv, d, dtype=dt, scale=scale),
                              rnd(b, t, hkv, d, dtype=dt), kw, limit,
                              dt == bf16 and "logit_cap" in kw))
    # fully masked rows: a window of 4 under kv_len 32 leaves rows >= 35
    # without a key; kv_len 0 leaves every row without one
    masked = [("fully masked rows (window 4, kv_len 32)", rnd(1, 128, 4, 64),
               rnd(1, 128, 2, 64), rnd(1, 128, 2, 64), dict(window=4, kv_len=32), 2e-5),
              ("fully masked rows (kv_len 0) bf16", *(rnd(1, 64, n, 128, dtype=bf16)
                                                      for n in (4, 1, 1)),
               dict(kv_len=0), 2e-2)]
    masked += [(f"fully masked rows (window 4, kv_len 32) bf16 d{d}",
                *(rnd(1, 192, n, d, dtype=bf16) for n in (4, 2, 2)),
                dict(window=4, kv_len=32), 2e-2) for d in (64, 128, 256)]
    masked += [(f"fully masked rows (window 4, kv_len 32) f32 d{d}",
                *(rnd(1, 192, n, d) for n in (4, 2, 2)),
                dict(window=4, kv_len=32), 2e-5) for d in (16, 32, 64, 128, 256)]
    masked.append(("fully masked rows (kv_len 0) f32", *(rnd(1, 64, n, 256) for n in (4, 1, 1)),
                   dict(kv_len=0), 2e-5))

    def rms_ratio(out, ref32):
        """RMS(err) / RMS(ref) against the plain version run in f32 on the
        same bf16 values: the reference's bf16 bound of 2e-2 is near the
        size of an output (|o| ~ 0.03 on long causal rows), so bf16 cases
        are also held at 1e-2 of the data's own scale."""
        err = (out.float() - ref32).pow(2).mean().sqrt().item()
        return err, ref32.pow(2).mean().sqrt().item()

    launches0 = flash_attention.launches
    max_err = 0.0
    bf16_err, bf16_rms = 0.0, 0.0
    n_masked_rows = 0
    by_instance = dict.fromkeys(flash_attention.launches_by_instance, 0)
    for label, q, k, v, kw, limit, *plain_in_f32 in cases + masked:
        before = dict(flash_attention.launches_by_instance)
        out = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = kernel_instance(q.dtype, q.shape[3])
        require(flash_attention.launches_by_instance[want] == before[want] + 1,
                f"flash {label}: ran through the {want} instance")
        by_instance[want] += 1
        if plain_in_f32 and plain_in_f32[0]:
            ref = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        else:
            ref = flash_attention_ref(q, k, v, **kw)
        require(out.dtype == q.dtype and out.shape == q.shape
                and torch.isfinite(out.float()).all(), f"flash {label}: finite, shape, type")
        err = (out.float() - ref.float()).abs().max().item()
        require(torch.allclose(out.float(), ref.float(), rtol=limit, atol=limit),
                f"flash {label}: max |err| {err:.3e} within {limit}")
        if q.dtype == torch.float32:
            max_err = max(max_err, err)
        else:
            ref32 = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
            rms, scale = rms_ratio(out, ref32)
            require(rms <= 1e-2 * scale, f"flash {label}: RMS err {rms:.3e} <= 1e-2 "
                    f"RMS(plain in f32) {scale:.3e}")
            bf16_err, bf16_rms = max(bf16_err, err), max(bf16_rms, rms / max(scale, 1e-30))
            del ref32
        _, dead = visible_keys(torch, q.shape[1], k.shape[1], **kw)
        n_masked_rows += int(dead.sum()) * q.shape[0] * q.shape[2]
        require(bool((out[:, dead] == 0).all()),
                f"flash {label}: fully masked rows are exactly 0")
    require(n_masked_rows > 0, "the grid had fully masked rows")

    # layout probes for the tensor-core instances: q = k = 0, so every
    # visible key has weight exactly 1 before the normaliser. V[t, c] = c / 4
    # (exact in bf16 and TF32) must give every output element its column's
    # c / 4; V[t, c] = t mod 256 every output row the mean of its visible
    # keys' indices, exactly in f32 (integer sums, one IEEE division) and to
    # the bf16 rounding of the output (2^-8 relative) in bf16. A swizzle,
    # descriptor, fragment, key-permutation or padding error moves a column
    # or a row.
    n_probes = dict(wgmma_bf16=0, tf32x3=0)
    for dt, dims in ((bf16, (64, 128, 256)), (torch.float32, (16, 32, 64, 128, 256))):
        for d in dims:
            b, s, t, h, hkv = 1, 300, 300, 4, 2
            q = torch.zeros(b, s, h, d, dtype=dt, device="cuda")
            k = torch.zeros(b, t, hkv, d, dtype=dt, device="cuda")
            cols = (torch.arange(d, device="cuda", dtype=torch.float32) / 4).expand(t, d)
            index = (torch.arange(t, device="cuda", dtype=torch.float32) % 256)[:, None].expand(t, d)
            for probe, vals in (("column", cols), ("row", index)):
                v = vals[None, :, None, :].expand(b, t, hkv, d).to(dt).contiguous()
                for kw in ({}, dict(window=40), dict(causal=False)):
                    out = flash_attention(q, k, v, **kw).float()
                    n_probes[kernel_instance(dt, d)] += 1
                    what = f"flash layout probe ({probe}) {str(dt)[6:]} d{d} {kw}"
                    if probe == "column":
                        require(torch.equal(out, cols[:1].expand(b, s, h, d)),
                                f"{what}: out == c / 4")
                        continue
                    vis, _ = visible_keys(torch, s, t, **kw)
                    mean = (vis.double() * index[None, :, 0].double()).sum(1) / vis.sum(1)
                    want = mean[None, :, None, None].expand(b, s, h, d).float()
                    err = (out - want).abs().max().item()
                    if dt == bf16:
                        require(torch.allclose(out, want, rtol=2 ** -8, atol=0),
                                f"{what}: out == mean visible index, max |err| {err:.3e}")
                    else:
                        require(torch.equal(out, want),
                                f"{what}: out == mean visible index exactly, max |err| {err:.3e}")
    q, k, v = cases[0][1:4]
    a = flash_attention(q, k, v, block_q=128, block_k=128)
    bq = flash_attention(q, k, v, block_q=256, block_k=512)
    require(torch.equal(a, bq), "flash result independent of block_q/block_k")
    n_calls = len(cases) + len(masked) + sum(n_probes.values()) + 2
    require(flash_attention.launches - launches0 == n_calls,
            "flash launch counter rose once per call")

    # gemma2-2b widths, the A/B path's longest case
    b, s, h, hkv, d = 1, 4096, 8, 4, 256
    rows = {}
    # f32 in 3xTF32: three TF32 operations for each f32 one
    for dt, peak in ((torch.float32, TF32_FLOPS / 3), (torch.bfloat16, BF16_FLOPS)):
        q, k, v = rnd(b, s, h, d, dtype=dt), rnd(b, s, hkv, d, dtype=dt), rnd(b, s, hkv, d, dtype=dt)
        out = flash_attention(q, k, v)
        ref = flash_attention_ref(q, k, v)
        err = (out.float() - ref.float()).abs().max().item()
        require(torch.allclose(out.float(), ref.float(), rtol=tol[dt], atol=tol[dt]),
                f"flash gemma2 S=4096 {dt}: max |err| {err:.3e} within {tol[dt]}")
        del ref
        rms = None
        if dt == torch.float32:
            max_err = max(max_err, err)
        else:
            ref32 = flash_attention_ref(q.float(), k.float(), v.float())
            rms, scale = rms_ratio(out, ref32)
            del ref32
            require(rms <= 1e-2 * scale, f"flash gemma2 S=4096 bf16: RMS err {rms:.3e} "
                    f"<= 1e-2 RMS(plain in f32) {scale:.3e}")
            rms /= scale
            bf16_err, bf16_rms = max(bf16_err, err), max(bf16_rms, rms)
        del out
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms, clk = clocked(lambda: cuda_ms(lambda: flash_attention(q, k, v), 20))
        plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v), 3)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 20)
        bound_ms, bound_by, flops, moved = attn_bound_ms(b, s, s, h, hkv, d,
                                                         q.element_size(), peak)
        rows[dt] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                        bound_by=bound_by, flops=flops, moved=moved, err=err, rms=rms, clk=clk,
                        trace=trace(torch, lambda: flash_attention(q, k, v)))
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    f32, bf = rows[torch.float32], rows[torch.bfloat16]
    print(f"# [7 flash] == plain on {len(cases) + len(masked)} cases (through "
          + ", ".join(f"{k} {n}" for k, n in by_instance.items())
          + f"; f32 2e-5, soft-cap 3e-5, bf16 2e-2 and "
          f"RMS err <= 1e-2 RMS of the plain version in f32), max |err| f32 "
          f"{max_err:.3e}, bf16 {bf16_err:.3e}, bf16 RMS err / RMS {bf16_rms:.3e}; "
          f"{n_masked_rows} fully masked rows exactly 0; layout probes exact "
          f"({n_probes['tf32x3']} tf32x3, {n_probes['wgmma_bf16']} wgmma_bf16); "
          "block_q/block_k invariant")
    for name, r in (("f32 (tf32x3)", f32), ("bf16 (wgmma_bf16)", bf)):
        print(f"# [7 flash] gemma2-2b B=1 H=8/4 D=256 S=T=4096 causal {name}: kernel "
              f"{r['ms']:.4f} ms {r['clk']}, plain {r['plain_ms']:.4f} ms, sdpa "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']} ({r['flops'] / 1e9:.2f} GFLOP"
              + (" x 3 TF32 at 495 TFLOP/s" if r is f32 else "")
              + f", {r['moved'] / 1e6:.1f} MB); "
              f"kernel {r['flops'] / r['ms'] / 1e9:.2f} TFLOP/s, sdpa "
              f"{r['flops'] / r['library_ms'] / 1e9:.2f} TFLOP/s; max |err| {r['err']:.3e}"
              + (f", RMS err / RMS {r['rms']:.3e}" if r["rms"] is not None else ""))
        print(f"# [7 trace] {name}: " + trace_line(*r["trace"]))
    common = dict(route="cuda", replaces="src/repro/kernels/flash_attention/kernel.py:113")
    tf32 = dict(name="flash_attention", dtype="float32",
                source="src/repro_torch/kernels/flash_attention/csrc/flash_attention_tf32.cu",
                max_abs_err=max_err, **common,
                **{k: f32[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    wgmma = dict(name="flash_attention_bf16", dtype="bfloat16",
                 source="src/repro_torch/kernels/flash_attention/csrc/flash_attention_sm90.cu",
                 max_abs_err=bf16_err, **common,
                 **{k: bf[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    return tf32, wgmma


def ssd_flops_bytes(b, s, h, p, n, chunk, nbytes):
    """Operations of the chunked SSD form (C B^T once per chunk, shared by
    the heads; the intra product over the lower triangle; the inter term
    and the state update) and the bytes read and written once."""
    nc, tail = divmod(s, chunk)
    tri = nc * chunk * (chunk + 1) // 2 + tail * (tail + 1) // 2
    flops = 2.0 * b * (tri * n + h * tri * p + 2 * h * s * p * n)
    moved = nbytes * (2 * b * s * h * p + 2 * b * s * n) + 4 * b * s * h
    return flops, moved


def phase_ssd(torch) -> tuple[dict, dict]:
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2405)

    def rnd(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device="cuda")).to(dtype)

    def inputs(b, s, h, p, n, dtype, decay=0.1):
        return (rnd(b, s, h, p, dtype=dtype), -rnd(b, s, h).abs() * decay,
                rnd(b, s, n, dtype=dtype), rnd(b, s, n, dtype=dtype))

    bounds = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
    launches0 = ssd_scan.launches
    n_calls, worst = 0, {torch.float32: 0.0, torch.bfloat16: 0.0}
    abs_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    # the reference's grid, ragged last chunks, head dims 8 and 24 (not
    # multiples of the p-tile) and mamba2-1.3b widths at both A/B lengths
    grid = [(2, 128, 8, 16, 32, 32, 4), (1, 256, 16, 32, 64, 64, 8),
            (2, 256, 8, 64, 128, 128, 8), (1, 200, 4, 64, 128, 64, 4),
            (2, 200, 4, 8, 64, 64, 2), (1, 130, 3, 24, 32, 48, 1),
            (1, 1024, 64, 64, 128, 64, 8), (1, 4096, 64, 64, 128, 64, 8)]
    for b, s, h, p, n, chunk, hg in grid:
        for dt in (torch.float32, torch.bfloat16):
            x, dta, B, C = inputs(b, s, h, p, n, dt)
            y = ssd_scan(x, dta, B, C, chunk=chunk, head_group=hg)
            torch.cuda.synchronize()
            yr, _ = ssd_chunked(x, dta, B, C, chunk)
            n_calls += 1
            require(y.dtype == dt and y.shape == x.shape and torch.isfinite(y.float()).all(),
                    f"ssd b{b} s{s} h{h} p{p} n{n} {dt}: finite, shape, type")
            err = rel_err(y, yr)
            worst[dt] = max(worst[dt], err)
            require(err < bounds[dt], f"ssd b{b} s{s} h{h} p{p} n{n} chunk {chunk} "
                    f"{dt}: max err / max|y| {err:.3e} < {bounds[dt]}")
            abs_err[dt] = max(abs_err[dt], (y.float() - yr.float()).abs().max().item())
    # head_group is a TPU tiling choice: the result must not depend on it
    x, dta, B, C = inputs(1, 256, 16, 32, 64, torch.float32)
    require(torch.equal(ssd_scan(x, dta, B, C, chunk=64, head_group=1),
                        ssd_scan(x, dta, B, C, chunk=64, head_group=16)),
            "ssd result independent of head_group")
    n_calls += 2
    # the sequential recurrence (the reference's test at its bound, 2e-4)
    b, s, h, p, n = 1, 64, 2, 8, 16
    x, dta, B, C = inputs(b, s, h, p, n, torch.float32, decay=0.2)
    y = ssd_scan(x, dta, B, C, chunk=16).double().cpu()
    n_calls += 1
    xs, ds, Bs, Cs = (t.double().cpu() for t in (x, dta, B, C))
    state = torch.zeros(b, h, p, n, dtype=torch.float64)
    y_naive = torch.zeros(b, s, h, p, dtype=torch.float64)
    for t in range(s):
        state = state * ds[:, t].exp()[:, :, None, None] \
            + torch.einsum("bhp,bn->bhpn", xs[:, t], Bs[:, t])
        y_naive[:, t] = torch.einsum("bhpn,bn->bhp", state, Cs[:, t])
    require(torch.allclose(y, y_naive, rtol=2e-4, atol=2e-4),
            f"ssd == sequential recurrence: max |err| {(y - y_naive).abs().max():.3e}")
    require(ssd_scan.launches - launches0 == n_calls,
            "ssd launch counter rose once per call")

    h, p, n, chunk = 64, 64, 128, 64                     # mamba2-1.3b, A/B chunk
    rows = {}
    for s in AB_SEQS:
        for dt in (torch.float32, torch.bfloat16):
            x, dta, B, C = inputs(1, s, h, p, n, dt)
            ms, clk = clocked(lambda: cuda_ms(
                lambda: ssd_scan(x, dta, B, C, chunk=chunk, head_group=8), 20))
            plain_ms = cuda_ms(lambda: ssd_chunked(x, dta, B, C, chunk), 5)
            flops, moved = ssd_flops_bytes(1, s, h, p, n, chunk, x.element_size())
            peak = FP32_FLOPS if dt == torch.float32 else BF16_FLOPS
            bound_ms, bound_by = bound(flops, peak, moved)
            rows[s, dt] = dict(ms=ms, plain_ms=plain_ms, flops=flops, moved=moved, clk=clk,
                               bound_ms=bound_ms, bound_by=bound_by,
                               trace=trace(torch, lambda: ssd_scan(x, dta, B, C, chunk=chunk)))
    print(f"# [8 ssd] == plain on {n_calls - 3} cases (max err / max|y| f32 "
          f"{worst[torch.float32]:.3e} < 1e-5, bf16 {worst[torch.bfloat16]:.3e} < 3e-2), "
          f"max |err| f32 {abs_err[torch.float32]:.3e}, bf16 {abs_err[torch.bfloat16]:.3e}; "
          "== sequential recurrence (2e-4); "
          "head_group invariant")
    for (s, dt), r in rows.items():
        print(f"# [8 ssd] mamba2-1.3b b=1 s={s} h=64 p=64 n=128 chunk 64 "
              f"{str(dt).replace('torch.', '')}: kernel {r['ms']:.4f} ms {r['clk']}, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
              f"({r['flops'] / 1e9:.2f} GFLOP, {r['moved'] / 1e6:.1f} MB); kernel "
              f"{r['flops'] / r['ms'] / 1e9:.2f} TFLOP/s")
        print(f"# [8 trace] s={s} {str(dt).replace('torch.', '')}: " + trace_line(*r["trace"]))
    out = []
    for name, dt in (("ssd_scan", torch.float32), ("ssd_scan_bf16", torch.bfloat16)):
        r = rows[AB_SEQS[-1], dt]
        out.append(dict(name=name, dtype=str(dt).replace("torch.", ""), route="cuda",
                        source="src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                        replaces="src/repro/kernels/ssd_scan/kernel.py:88",
                        max_abs_err=abs_err[dt], ms=r["ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None))
    return tuple(out)


def phase_ab(torch, dtype="float32") -> dict:
    """The kernel guideline family at ``dtype`` (the reference's float32,
    or bfloat16, which the tensor-core flash instance serves); returns the
    main path's launch counts: by op, and flash by instance."""
    import dataclasses
    import tempfile

    import numpy as np

    from repro_torch.campaign import ResultStore, TorchKernelBackend
    from repro_torch.core import ExperimentDesign
    from repro_torch.guidelines import (format_report, format_violations,
                                        default_guidelines, verify_guidelines)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ops import make_benchmark_op
    from repro_torch.kernels.ssd_scan import ssd_scan

    # the reference CLI's kernel design (benchmarks/run.py guidelines)
    design = ExperimentDesign(n_launch_epochs=6, nrep_min=10, nrep_max=40,
                              rel_ci_target=0.10, seed=0)
    family = {g.lhs.split("#")[0]: dataclasses.replace(g, msizes=AB_SEQS)
              for g in default_guidelines("kernel")}
    runs = (("flash_attention", flash_attention, GEMMA2_ATTN),
            ("ssd_scan", ssd_scan, MAMBA2_SSD))

    # the objects the A/B times, on its own inputs (epoch 0's seed): the
    # #cuda callable agrees with the #ref one at the f32 bounds
    agree = []
    for op, _, widths in runs:
        for seq in AB_SEQS:
            fn = {impl: make_benchmark_op(op, impl, seq=seq, batch=1, seed=0,
                                          dtype=getattr(torch, dtype), **widths)
                  for impl in ("cuda", "ref")}
            require(all(torch.equal(a, b) for a, b in
                        zip(fn["cuda"].inputs, fn["ref"].inputs)),
                    f"A/B {op}@{seq}: both sides draw the same inputs")
            out, ref = fn["cuda"](), fn["ref"]()
            out, ref = out.float(), ref.float()
            require(out.shape == ref.shape and torch.isfinite(out).all(),
                    f"A/B {op}@{seq}: finite, shape")
            if op == "flash_attention":
                err = (out - ref).abs().max().item()
                lim = 2e-5 if dtype == "float32" else 2e-2
                require(torch.allclose(out, ref, rtol=lim, atol=lim),
                        f"A/B {op}@{seq}: #cuda == #ref, max |err| {err:.3e} within {lim}")
            else:
                err = rel_err(out, ref)
                lim = 1e-5 if dtype == "float32" else 3e-2
                require(err < lim, f"A/B {op}@{seq}: #cuda == #ref, max err / "
                        f"max|y| {err:.3e} < {lim}")
            agree.append(f"{op}@{seq} {err:.3e}")
            del fn, out, ref
            torch.cuda.empty_cache()
    tag = f"[9 A/B {dtype}]"
    print(f"# {tag} the timed #cuda and #ref callables agree on the A/B's inputs "
          "(flash max |err|, ssd max err / max|y|): " + ", ".join(agree))

    reports, walls = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "ab.jsonl"
        torch.cuda.synchronize()
        flash_attention.launches = ssd_scan.launches = 0
        for name in flash_attention.launches_by_instance:
            flash_attention.launches_by_instance[name] = 0
        for op, kernel, widths in runs:
            backend = TorchKernelBackend(batch=1, seed0=0, dtype=dtype, **widths)
            t = time.perf_counter()
            report = verify_guidelines([family[op]], backend, design=design,
                                       store=ResultStore(path), name=f"ab-{op}-{dtype}")
            torch.cuda.synchronize()
            walls[op] = time.perf_counter() - t
            reports[op] = report
            require(report.n_measured == 2 * len(AB_SEQS) * design.n_launch_epochs,
                    f"A/B {op}: every cell measured ({report.n_measured})")
            require(all(v.n_epochs == design.n_launch_epochs for v in report.verdicts),
                    f"A/B {op}: every cell has one record per epoch")
            print(format_report(report, title=f"kernel A/B [{op}, {dtype}] {widths}"))
            if not report.ok:
                print(format_violations(report))
        launches = dict(flash_attention=flash_attention.launches,
                        ssd_scan=ssd_scan.launches,
                        **flash_attention.launches_by_instance)
        snap = ResultStore(path).snapshot()
    for op in ("flash_attention", "ssd_scan"):
        require(launches[op] > 0, f"A/B {op}: the kernel launched on the #cuda side")
    instance = "tf32x3" if dtype == "float32" else "wgmma_bf16"
    require(launches[instance] == launches["flash_attention"],
            f"A/B flash_attention {dtype}: every launch through the {instance} instance")
    n_records = sum(len(r) for r in snap.records.values())
    expect = sum(r.n_measured for r in reports.values())
    require(n_records == expect,
            f"A/B store reloads with every record ({n_records} of {expect})")
    for op, report in reports.items():
        recs = snap.records[report.fingerprint]
        require(all(r.times.size >= design.nrep_min and np.isfinite(r.times).all()
                    and r.meta.get("device", "").startswith("cuda") for r in recs),
                f"A/B {op}: records finite, >= nrep_min, on cuda")
        timed = {impl: sum(float(r.times.sum()) for r in recs if r.case.op.endswith(impl))
                 for impl in ("#cuda", "#ref")}
        reps = {impl: sum(r.times.size for r in recs if r.case.op.endswith(impl))
                for impl in ("#cuda", "#ref")}
        build = sum(r.meta["build_s"] for r in recs)
        print(f"# {tag} {op}: wall {walls[op]:.2f} s = building inputs "
              f"{build:.2f} s ({len(recs)} builds) + timed kernel calls "
              f"{timed['#cuda']:.2f} s ({reps['#cuda']} calls) + timed plain calls "
              f"{timed['#ref']:.2f} s ({reps['#ref']} calls) + rest (warm-ups, "
              f"epoch isolation, store, statistics) "
              f"{walls[op] - build - timed['#cuda'] - timed['#ref']:.2f} s; "
              f"kernel launches {launches[op]}")
    print(f"# {tag} store reloaded with {n_records} records; flash launches by "
          f"instance {launches['tf32x3']} tf32x3, {launches['wgmma_bf16']} wgmma_bf16, "
          f"{launches['simt']} simt; "
          "verdicts: " + ", ".join(
        f"{v.guideline.name}@{v.msize} {v.verdict} ratio {v.ratio:.3f}"
        for r in reports.values() for v in r.verdicts))
    return launches


def same_run(a, b, fields, what):
    """``a`` and ``b`` agree at atol 1e-12 on ``fields``, with equal flags
    where they carry them; returns the largest difference."""
    import numpy as np

    if hasattr(a, "errors"):
        require(np.array_equal(a.errors, b.errors), f"{what}: error flags equal")
    worst = 0.0
    for k in fields:
        x, y = getattr(a, k), getattr(b, k)
        require(x.shape == y.shape and np.array_equal(np.isnan(x), np.isnan(y)),
                f"{what} {k}: shapes and NaNs equal")
        err = float(np.nanmax(np.abs(x - y))) if x.size else 0.0
        require(err <= 1e-12, f"{what} {k}: |err| {err:.3e} <= 1e-12")
        worst = max(worst, err)
    return worst


def phase_rw_engines(torch, device="cuda", p=16, nrep=2000):
    """Random-walk clocks through the per-epoch engine on the card against
    the port on the CPU, noise-free from the same state; the fused engine
    must refuse them."""
    import numpy as np

    from repro_torch.core import ClockParams, SimNet, make_op, make_sync
    from repro_torch.simengine import (SimTorchUnavailable, run_windowed_epochs_torch,
                                       run_windowed_torch)

    t = time.perf_counter()
    net = SimNet(p, seed=5, clocks=ClockParams(rw_sigma=RW_SIGMA))
    sync = make_sync("hca", n_fitpts=100, n_exchanges=20).synchronize(net)
    cpu = (net, sync, make_op("allreduce", **NOISE_FREE))
    dev = copy.deepcopy(cpu)
    worst = 0.0
    for chunk in (nrep, nrep // 3):          # a second call on the grown paths
        a = run_windowed_torch(*cpu, 4096, chunk, 300e-6, device="cpu")
        b = run_windowed_torch(*dev, 4096, chunk, 300e-6, device=device)
        worst = max(worst, same_run(a, b, ("times", "start_true", "end_true",
                                           "start_global_est", "end_global_est"),
                                    f"rw per-epoch nrep {chunk}"))
        err = float(np.abs(cpu[0].t - dev[0].t).max())
        require(err <= 1e-12, f"rw per-epoch net.t |err| {err:.3e} <= 1e-12")
    require(all(np.array_equal(c._path.x, g._path.x)
                for c, g in zip(cpu[0].clocks, dev[0].clocks)),
            "drift paths grown identically for both devices")
    try:
        run_windowed_epochs_torch([dev[0]], [dev[1]], [dev[2]], 4096, 100, 300e-6,
                                  device=device)
    except SimTorchUnavailable:
        pass
    else:
        require(False, "the fused engine refuses walking clocks")
    print(f"# [10 rw engines] rw_sigma {RW_SIGMA:g}, p={p}, hca, noise-free: per-epoch "
          f"{device} == cpu at atol 1e-12 (nrep {nrep} then {nrep // 3} on the grown "
          f"paths; max |err| {worst:.3e}), identical flags and net.t; fused engine "
          f"raised SimTorchUnavailable; {time.perf_counter() - t:.2f} s")


def phase_rw_campaign(torch, device="cuda", p=512, epochs=4, nrep=100_000) -> int:
    """Walking clocks through the campaign: the archive gate, then one
    campaign at full width per epoch; returns its sim_scan launches."""
    import numpy as np

    from repro_torch import simengine
    from repro_torch.campaign import (Campaign, CampaignSpec, ResultStore,
                                      TorchSimBackend, backends)
    from repro_torch.core import ExperimentDesign, TestCase
    from repro_torch.kernels.sim_scan import sim_durations_scan

    on_card = device == "cuda"
    t = time.perf_counter()
    archive = ResultStore(ROOT / "benchmarks" / "reference_archive"
                          / "run-000.jsonl").to_table()
    cases = [TestCase(op, m) for op in ("allreduce", "bcast", "alltoall")
             for m in (512, 4096)]
    backend = TorchSimBackend(p=8, seed0=0, sync_kw=dict(n_fitpts=60, n_exchanges=20),
                              clock_kw=dict(rw_sigma=RW_SIGMA), device=device)
    res = Campaign(CampaignSpec(cases, ExperimentDesign(n_launch_epochs=12, nrep=40,
                                                        seed=0), name="repro-audit-rw"),
                   backend).run()
    require(all(r.meta["engine"] == "torch" and r.meta["device"].startswith(device)
                and r.meta["fused"] is False for r in res.records),
            f"rw gate records: engine=torch, {device}, fused=False")
    cells = []
    for case in cases:
        ratio = float(np.median(res.table.medians(case))
                      / np.median(archive.medians(case)))
        require(abs(ratio - 1.0) <= 0.10,
                f"rw gate {case.op}/{case.msize}: median ratio {ratio:.4f} within ±10%")
        cells.append(f"{case.op}/{case.msize} {ratio:.4f}")
    print(f"# [11 rw gate] archive spec, clock_kw rw_sigma {RW_SIGMA:g}, per epoch on "
          f"{device}: median-of-epoch-medians ratio to the archive: " + ", ".join(cells)
          + f"; {time.perf_counter() - t:.2f} s")

    spans = Spans() if on_card else None
    host: dict[str, list] = collections.defaultdict(list)
    runs: list = []
    topping = [False]

    def host_timed(name, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            host[name].append(time.perf_counter() - t0)
            return out
        return timed

    def engine_call(*args, **kw):
        t0 = time.perf_counter()
        out = rwt(*args, **kw)
        host["top-up calls" if topping[0] else "first calls"].append(
            time.perf_counter() - t0)
        runs.append(out)
        return out

    def top_up(*args, **kw):
        topping[0] = True
        try:
            return top_up0(*args, **kw)
        finally:
            topping[0] = False

    rwt, top_up0 = backends.run_windowed_torch, backends.TorchSimBackend._top_up
    patches = [(simengine, name, host_timed(name, getattr(simengine, name)))
               for name in ("grow_paths_for_deadlines", "grow_paths_for_reads")]
    patches.append((simengine._DevicePaths, "upload",
                    host_timed("upload", simengine._DevicePaths.upload)))
    if on_card:
        patches += [(simengine, name, spans.wrap(name, getattr(simengine, name)))
                    for name in ("_sample", "_window")]
    patches += [(backends, "run_windowed_torch", engine_call),
                (backends.TorchSimBackend, "_top_up", top_up),
                (backends.TorchSimBackend, "make_epoch",
                 host_timed("make_epoch", backends.TorchSimBackend.make_epoch))]
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        spec = CampaignSpec([TestCase("allreduce", 4096)],
                            ExperimentDesign(n_launch_epochs=epochs, nrep=nrep, seed=0),
                            name="rw-campaign")
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        sim_durations_scan.launches = 0
        t = time.perf_counter()
        res = Campaign(spec, TorchSimBackend(p=p, seed0=0, clock_kw=dict(rw_sigma=RW_SIGMA),
                                             device=device)).run()
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = sim_durations_scan.launches
        peak = torch.cuda.max_memory_allocated() if on_card else 0
    finally:
        for obj, name, fn in originals:
            setattr(obj, name, fn)
    if on_card:
        require(launches > 0, "rw campaign launched sim_scan")
    require(len(res.records) == epochs, "rw campaign: one record per epoch")
    for r in res.records:
        require(r.meta["fused"] is False and r.meta["device"].startswith(device)
                and 0 < r.times.size <= nrep and np.isfinite(r.times).all()
                and (r.times > 0).all(),
                f"rw campaign epoch {r.epoch}: per epoch on {device}, "
                f"{r.times.size} valid times, finite and positive")
    s = {k: sum(v) for k, v in host.items()}
    n = {k: len(v) for k, v in host.items()}
    engine_s = s["first calls"] + s.get("top-up calls", 0.0)
    measured = sum(r.times.size for r in runs)
    invalid = sum(int(np.count_nonzero(r.errors)) for r in runs)
    dev_spans = (f"device spans: sampling {spans.ms('_sample') / 1e3:.3f} s, window "
                 f"{spans.ms('_window') / 1e3:.3f} s" if on_card else "no device spans (CPU)")
    print(f"# [11 rw campaign] p={p} epochs={epochs} nrep={nrep} hca rw_sigma "
          f"{RW_SIGMA:g} allreduce@4096, per epoch: wall {wall:.2f} s = clock sync "
          f"{s['make_epoch']:.2f} s ({n['make_epoch']} epochs) + engine first calls "
          f"{s['first calls']:.2f} s ({n['first calls']}) + top-up calls "
          f"{s.get('top-up calls', 0.0):.2f} s ({n.get('top-up calls', 0)}) + rest "
          f"{wall - s['make_epoch'] - engine_s:.2f} s; inside the engine calls: "
          f"drift-path growth on the host {s['grow_paths_for_deadlines']:.2f} s "
          f"(deadlines) + {s['grow_paths_for_reads']:.2f} s (reads), path uploads "
          f"{s['upload']:.2f} s ({n['upload']} in {len(runs)} calls), {dev_spans}; "
          f"invalid fraction {invalid / measured:.4f} ({invalid} of {measured}); "
          f"sim_scan launches {launches}; peak device memory {peak / 2**30:.2f} GiB")
    return launches


def phase_barrier(torch, device="cuda", p=512, nrep=10_000, probes=1000) -> int:
    """The barrier scheme: noise-free card == CPU on affine and walking
    clocks, then Figs. 11-12's settings at full width; returns the barrier
    run's sim_scan launches."""
    import numpy as np

    from repro_torch.core import (ClockParams, SimNet, make_op, make_sync,
                                  probe_barrier_skew, run_barrier_timed)
    from repro_torch.kernels.sim_scan import sim_durations_scan
    from repro_torch.simengine import run_windowed_torch

    t = time.perf_counter()
    worst = 0.0
    for rw in (0.0, RW_SIGMA):
        for library in (True, False):
            net = SimNet(16, seed=5, clocks=ClockParams(rw_sigma=rw))
            sync = make_sync("hca", n_fitpts=100, n_exchanges=20).synchronize(net)
            cpu = (net, make_op("allreduce", **NOISE_FREE))
            dev = copy.deepcopy((net, make_op("allreduce", **NOISE_FREE)))
            kw = dict(sync=sync, use_library_barrier=library)
            a = run_barrier_timed(*cpu, 4096, 300, device="cpu", **kw)
            b = run_barrier_timed(*dev, 4096, 300, device=device, **kw)
            what = f"barrier rw_sigma {rw:g} {'library' if library else 'dissemination'}"
            worst = max(worst, same_run(a, b, ("times_local", "times_global",
                                               "barrier_exit_true", "start_true",
                                               "end_true"), what))
            err = float(np.abs(cpu[0].t - dev[0].t).max())
            require(err <= 1e-12, f"{what}: net.t |err| {err:.3e} <= 1e-12")
    print(f"# [12 barrier] noise-free op, p=16, nrep 300: run_barrier_timed {device} == "
          f"cpu at atol 1e-12 (max |err| {worst:.3e}) on affine and walking (rw_sigma "
          f"{RW_SIGMA:g}, lazy) clocks, library and dissemination barriers; "
          f"{time.perf_counter() - t:.2f} s")

    # Figs. 11-12 (benchmarks/suite.py bench_fig11_12_barrier, its SYNC_KW)
    # at full width
    t = time.perf_counter()
    op_kw = dict(rank_imbalance=0.01, noise_sigma=0.01, tail_prob=0.0)
    net = SimNet(p, seed=11)
    sync = make_sync("hca", n_fitpts=200, n_exchanges=40).synchronize(net)
    t_sync = time.perf_counter() - t
    t = time.perf_counter()
    wr = run_windowed_torch(net, sync, make_op("allreduce", **op_kw), 32768, nrep,
                            500e-6, device=device)
    t_window = time.perf_counter() - t
    net2 = SimNet(p, seed=11)
    sim_durations_scan.launches = 0
    t = time.perf_counter()
    br = run_barrier_timed(net2, make_op("allreduce", **op_kw), 32768, nrep,
                           barrier_exit_skew=40e-6, device=device)
    t_barrier = time.perf_counter() - t
    launches = sim_durations_scan.launches
    if device == "cuda":
        require(launches > 0, "barrier scheme launched sim_scan")
    t = time.perf_counter()
    lib = probe_barrier_skew(SimNet(p, seed=12), nrep=probes, barrier_exit_skew=40e-6)
    dis = probe_barrier_skew(SimNet(p, seed=12), nrep=probes, use_library_barrier=False)
    t_probe = time.perf_counter() - t
    window_mean = float(wr.valid_times.mean())
    barrier_mean = float(br.times_local.mean())
    require(wr.valid_times.size > 0 and np.isfinite(br.times_local).all()
            and br.times_local.shape == (nrep,), "barrier and window runs finite")
    require(barrier_mean > window_mean,
            f"Fig. 11: barrier local-max mean {barrier_mean * 1e6:.3f} us > window "
            f"global mean {window_mean * 1e6:.3f} us")
    lib_max, dis_max = float(lib.mean(axis=0).max()), float(dis.mean(axis=0).max())
    require(lib_max > dis_max, "Fig. 12: the library barrier's exit skew exceeds "
            "the dissemination barrier's")
    print(f"# [12 barrier] p={p} nrep {nrep} allreduce@32768 {op_kw}: window (hca "
          f"200x40, 500 us) global mean {window_mean * 1e6:.3f} us ({wr.invalid_fraction:.4f} "
          f"invalid), barrier (library, 40 us exit skew) local-max mean "
          f"{barrier_mean * 1e6:.3f} us: {barrier_mean / window_mean:.3f}x; exit skew, "
          f"largest per-rank mean over {probes} barriers: library "
          f"{lib_max * 1e6:.3f} us, dissemination {dis_max * 1e6:.3f} us; sim_scan "
          f"launches {launches}; hca sync {t_sync:.2f} s, window {t_window:.2f} s, "
          f"barrier {t_barrier:.2f} s, probes {t_probe:.2f} s")
    return launches

AUDIT_OPS = ("allreduce", "bcast", "alltoall")
FAST_SYNC = dict(n_fitpts=60, n_exchanges=20)   # benchmarks/run.py audit, calibrate


def cell_tables(res) -> dict:
    """Each sweep cell's Algorithm-6 table as plain tuples, by cell index."""
    return {c.cell.index: sorted((s.case.op, s.case.msize, s.epoch, s.mean, s.median,
                                  s.n_kept, s.n_raw) for s in c.table.summaries)
            for c in res.cells}


def phase_sweeps(torch, device="cuda", p=512, nrep=10_000) -> int:
    """Factor sweeps: the stock sweep at full width, then the reference's
    racing smoke sweep, its replay from the store and its twin on two
    spawned workers; returns sim_scan's launches in this process."""
    import tempfile

    import numpy as np

    from repro_torch.campaign import ResultStore, SweepScheduler, backends, sweep
    from repro_torch.core import NREP_SPENT
    from repro_torch.kernels.sim_scan import sim_durations_scan
    from repro_torch.sweeps import (cells_from_result, default_sim_sweep,
                                    format_factor_report, interaction_screen,
                                    main_effects)

    on_card = device == "cuda"
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sweeps_"))
    # each cell's campaign wall, and the window flags of every engine call in it
    cell_wall: dict = collections.defaultdict(float)
    cell_flags: dict = collections.defaultdict(list)
    current = [None]
    run0 = sweep.Campaign.run

    def timed_run(self, *args, **kw):
        current[0] = self.spec.name
        t0 = time.perf_counter()
        try:
            return run0(self, *args, **kw)
        finally:
            cell_wall[self.spec.name] += time.perf_counter() - t0

    def flagged(fn, fused):
        def call(*args, **kw):
            out = fn(*args, **kw)
            cell_flags[current[0]] += [np.asarray(r.errors) for r in (out if fused else [out])]
            return out
        return call

    patches = [(sweep.Campaign, "run", timed_run),
               (backends, "run_windowed_epochs_torch",
                flagged(backends.run_windowed_epochs_torch, True)),
               (backends, "run_windowed_torch", flagged(backends.run_windowed_torch, False))]
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        spec, backend = default_sim_sweep(seed=0, p=p, nrep=nrep, n_launch_epochs=6,
                                          device=device)
        sim_durations_scan.launches = 0
        t = time.perf_counter()
        res = SweepScheduler(spec, backend, ResultStore(tmp / "sweep.jsonl")).run()
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = sim_durations_scan.launches
    finally:
        for obj, name, fn in originals:
            setattr(obj, name, fn)
    n_cells = len(spec.grid.cells())
    require(len(res.cells) == n_cells == res.n_cells_measured,
            f"sweep: all {n_cells} cells measured")
    for c in res.cells:
        meds = [c.table.medians(case) for case in spec.cases]
        require(all(m.size == 6 and np.isfinite(m).all() and (m > 0).all() for m in meds),
                f"sweep cell {c.cell.index}: six finite positive epoch medians per case")
    if on_card:
        require(launches > 0, "sweep launched sim_scan")
    cells = cells_from_result(res)
    effects = main_effects(cells)
    # At p = 512 both packages rank the sync method above the seeded
    # mis-tuning (hca at 60 x 20 fitpoints reads windows ~2.7x longer than
    # skampi there); tuning ranks first at the stock sweep's p = 8.
    # `python tests/test_torch_sweeps.py --p 512` prints both rankings.
    order = [e.axis for e in effects[:2]]
    require(order == ["sync_method", "tuning"] and all(e.significant for e in effects[:2]),
            f"sweep: sync_method then tuning, both MATTERS, as in the reference at "
            f"p = 512 (got {[(e.axis, e.verdict) for e in effects]})")
    axes = ", ".join(ax.name for ax in spec.grid.axes)
    print(format_factor_report(effects, interaction_screen(cells),
                               title=f"[13 sweep] factor impact [{axes}]"))
    print(f"# [13 sweep] p={p} nrep={nrep} 6 epochs, allreduce@{[c.msize for c in spec.cases]}"
          f", {n_cells} cells on {device}: wall {wall:.2f} s, sim_scan launches "
          f"{launches}; axes (verdict, |Cliff's delta|, Holm p): " + "; ".join(
              f"{e.axis} {e.verdict} {e.effect_size:.3f} {e.p_holm:.3g}" for e in effects)
          + f"; null control dtype p_holm {[e.p_holm for e in effects if e.axis == 'dtype'][0]:.4g}")
    for c in res.cells:
        name = spec.cell_spec(c.cell, spec.design).name
        flags = np.concatenate(cell_flags[name])
        print(f"# [13 sweep] cell {c.cell.index:2d} {c.levels()}: wall "
              f"{cell_wall[name]:.2f} s, invalid fraction "
              f"{np.count_nonzero(flags) / flags.size:.4f} ({flags.size} windows)")

    # the reference's racing smoke sweep (--axes tuning,dtype --policy racing)
    ref = json.loads((ROOT / "benchmarks" / "reference_sweep_verdicts.json").read_text())
    spec_r, backend_r = default_sim_sweep(seed=0, axes=("tuning", "dtype"), device=device)
    t = time.perf_counter()
    l0 = sim_durations_scan.launches
    race = SweepScheduler(spec_r, backend_r, ResultStore(tmp / "race.jsonl"),
                          policy="racing").run()
    race_s = time.perf_counter() - t
    launches += sim_durations_scan.launches - l0
    alloc = race.meta["alloc"]
    require(not alloc["undecided"], "racing sweep: every axis decided")
    print(f"# [13 racing] p=8 nrep 40, tuning x dtype on {device}: verdicts "
          f"{alloc['decisions']}, reference {ref['axes']} "
          f"(equal: {alloc['decisions'] == ref['axes']}); rounds {alloc['n_rounds']} "
          f"{[r['epochs'] for r in alloc['rounds']]}, spent nrep {alloc['spent_nrep']} of "
          f"{alloc['uniform_nrep']}, savings {alloc['savings']:.2f}x; {race_s:.2f} s")

    spent0, l0 = NREP_SPENT.read(), sim_durations_scan.launches
    t = time.perf_counter()
    again = SweepScheduler(spec_r, backend_r, ResultStore(tmp / "race.jsonl"),
                           policy="racing").run()
    replay_s = time.perf_counter() - t
    require(NREP_SPENT.read() == spent0 and sim_durations_scan.launches == l0
            and again.n_cells_measured == 0, "racing replay measures nothing")
    require(again.meta["alloc"]["decisions"] == alloc["decisions"]
            and cell_tables(again) == cell_tables(race),
            "racing replay: the same verdicts and tables from the store")

    l0 = sim_durations_scan.launches
    t = time.perf_counter()
    par = SweepScheduler(spec_r, backend_r, ResultStore(tmp / "race2.jsonl"), n_workers=2,
                         policy="racing").run()
    par_s = time.perf_counter() - t
    in_parent = sim_durations_scan.launches - l0
    require(cell_tables(par) == cell_tables(race)
            and par.meta["alloc"]["decisions"] == alloc["decisions"],
            "racing on 2 workers: per-cell tables bit-equal to the serial run's")
    if on_card and all(r["n_cells"] > 1 for r in alloc["rounds"]):
        require(in_parent == 0, "racing on 2 workers: every round ran in the workers")
    print(f"# [13 racing] replay from the store: 0 nrep, 0 launches, same verdicts "
          f"({replay_s:.2f} s); 2 spawned workers: {len(par.cells)} cell tables "
          f"bit-equal to the serial run's, {in_parent} launches in this process "
          f"({par_s:.2f} s)")
    return launches


def phase_audit(torch, device="cuda") -> int:
    """The drift audit: phase 5's campaign registered into a copy of the
    reference archive and audited against it, then the bcast control;
    returns sim_scan's launches."""
    import shutil
    import tempfile

    from repro_torch.campaign import Campaign, CampaignSpec, ResultStore, TorchSimBackend
    from repro_torch.core import ExperimentDesign, TestCase
    from repro_torch.history import (CONTROL_TAG, RunArchive, audit_runs,
                                     format_audit_report)
    from repro_torch.kernels.sim_scan import sim_durations_scan

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_audit_")) / "archive"
    shutil.copytree(ROOT / "benchmarks" / "reference_archive", root)
    archive = RunArchive(root)
    cases = [TestCase(op, m) for op in AUDIT_OPS for m in (512, 4096)]
    design = ExperimentDesign(n_launch_epochs=12, nrep=40, seed=0)
    reports = {}
    sim_durations_scan.launches = 0
    for name, per_op_kw, tag in (("run", {}, None),
                                 ("control", {"bcast": dict(alpha=12e-6, gamma=6e-6)},
                                  CONTROL_TAG)):
        t = time.perf_counter()
        backend = TorchSimBackend(p=8, seed0=0, per_op_kw=per_op_kw, sync_kw=FAST_SYNC,
                                  device=device)
        store = ResultStore(archive.new_store_path())
        res = Campaign(CampaignSpec(cases, design, name="repro-audit"), backend,
                       store).run()
        require(all(r.meta["device"].startswith(device) for r in res.records),
                f"audit {name}: records on {device}")
        entry = archive.register(store.path, tag=tag)
        report = audit_runs(archive, entry, baseline_tag="reference")
        reports[name] = report
        print(format_audit_report(report, title=f"[14 audit] {name} on {device} "
                                                f"({time.perf_counter() - t:.2f} s)"))
    launches = sim_durations_scan.launches
    if device == "cuda":
        require(launches > 0, "audit campaigns launched sim_scan")
    require(not reports["run"].drifted(), "audit: no cell DRIFTED against the archive")
    drifted = sorted((c.op, c.msize) for c in reports["control"].drifted())
    require(drifted == [("bcast", 512), ("bcast", 4096)],
            f"audit control: exactly the bcast cells DRIFTED (got {drifted})")
    n_eq = sum(c.verdict == "EQUIVALENT" for c in reports["run"].cells)
    print(f"# [14 audit] {n_eq}/{len(reports['run'].cells)} EQUIVALENT, 0 DRIFTED "
          f"against the reference archive; control DRIFTED {drifted}; sim_scan launches "
          f"{launches}")
    return launches


def phase_calibrate(torch, device="cuda") -> int:
    """The sim calibration at the reference's spec (benchmarks/run.py
    calibrate --target sim), then its replay from the store; returns
    sim_scan's launches of the fit."""
    import tempfile

    from repro_torch.calibrate import calibrate, default_space
    from repro_torch.campaign import ResultStore, TorchSimBackend
    from repro_torch.core import NREP_SPENT, ExperimentDesign, TestCase
    from repro_torch.history import RunArchive, format_audit_report
    from repro_torch.kernels.sim_scan import sim_durations_scan

    ref = json.loads((ROOT / "benchmarks" / "reference_calibration.json").read_text())
    archive = RunArchive(Path(tempfile.mkdtemp(prefix="chip_smoke_calib_")) / "archive")
    space = default_space(base=TorchSimBackend(p=8, seed0=0, sync_kw=FAST_SYNC,
                                               device=device), names=["op.alpha"])
    target = TorchSimBackend(p=8, seed0=7919, sync_kw=FAST_SYNC, device=device,
                             op_kw=dict(alpha=6e-6, noise_sigma=0.09, tail_prob=0.16))
    cases = [TestCase(op, m) for op in ("allreduce", "bcast") for m in (512, 4096)]
    design = ExperimentDesign(n_launch_epochs=24, nrep=30, seed=0)
    store = ResultStore(archive.new_store_path(stem="calib"))
    kw = dict(cases=cases, design=design, store=store, archive=archive, seed=0,
              max_rounds=6)
    sim_durations_scan.launches = 0
    t = time.perf_counter()
    result = calibrate(space, target, **kw)
    wall = time.perf_counter() - t
    launches = sim_durations_scan.launches
    alpha, want = result.params["op.alpha"], ref["params"]["op.alpha"]
    print(format_audit_report(result.report, title=f"[15 calibrate] certification on "
                                                   f"{result.n_heldout_epochs} held-out "
                                                   f"epochs, {device}"))
    print(f"# [15 calibrate] fitted op.alpha {alpha:.6g} (reference {want:.6g}, truth 6e-06)"
          f", objective {result.objective:.6f}, {len(result.rounds)} rounds, spent nrep "
          f"{result.spent_nrep}, verdict {result.verdict}, sim_scan launches {launches}, "
          f"wall {wall:.2f} s")
    if device == "cuda":
        require(launches > 0, "calibration launched sim_scan")
    require(result.ok, "calibration: no held-out cell DRIFTED")
    require(abs(alpha / want - 1.0) <= 0.10,
            f"calibration: op.alpha {alpha:.6g} within 10% of {want:.6g}")

    spent0, l0 = NREP_SPENT.read(), sim_durations_scan.launches
    t = time.perf_counter()
    again = calibrate(space, target, **kw)
    require(again.n_rounds_resumed == len(again.rounds) == len(result.rounds)
            and again.params == result.params, "calibration replay: every round "
            "replayed, the same fit")
    require(NREP_SPENT.read() == spent0 and sim_durations_scan.launches == l0,
            "calibration replay measures nothing")
    print(f"# [15 calibrate] replay from the store: {again.n_rounds_resumed} of "
          f"{len(again.rounds)} rounds replayed, 0 nrep, 0 launches "
          f"({time.perf_counter() - t:.2f} s)")
    return launches


GUIDELINE_MOCK = dict(name="alltoall_mock_bound", lhs="alltoall",
                      rhs="allreduce*2+bcast*2",
                      description="mock-up bound: alltoall ⪯ allreduce(2m)+bcast(2m)")

# The verdicts the reference gives at p = 512 on the same specs (its
# SimBackend on the CPU, nrep 1e4, 8 epochs, stock sync: `python
# tests/test_torch_sim_guidelines.py --p 512 --nrep 10000` prints both
# packages'). At this width the epochs' spread swamps most margins: no
# honest cell is VIOLATED but none holds with a significant margin
# (holds(~)), where all ten hold(<) at p = 8; the inflated alltoall still
# breaks exactly the mock-up bound, and the inflated allgather leaves
# pattern containment at a ratio of ~1.38 but not significantly (Holm p
# ~0.2 over 8 epochs), so nothing is VIOLATED there.
GUIDELINE_VERDICTS_P512 = {
    "honest": ["holds(~)"] * 10,
    "alltoall": ["holds(<)", "holds(<)", "holds(~)", "holds(~)", "holds(~)", "VIOLATED"],
    "allgather": ["holds(~)", "holds(<)", "holds(~)", "holds(~)", "holds(~)"],
}


def phase_guidelines(torch, device="cuda", p=512, nrep=10_000) -> int:
    """The PGMPI guideline family on the simulated campaign at p = 512: the
    honest library, then the two seeded mis-tunings of the reference's
    tests; returns sim_scan's launches."""
    import numpy as np

    from repro_torch.campaign import TorchSimBackend, backends
    from repro_torch.core import ExperimentDesign
    from repro_torch.guidelines import SIM_GUIDELINES, Guideline, verify_guidelines
    from repro_torch.kernels.sim_scan import sim_durations_scan

    design = ExperimentDesign(n_launch_epochs=8, nrep=nrep)
    specs = [("honest", SIM_GUIDELINES, (1024, 8192), {}),
             ("alltoall", (*SIM_GUIDELINES, Guideline(**GUIDELINE_MOCK)), (1024,),
              {"alltoall": dict(alpha=12e-6, gamma=10e-6)}),
             ("allgather", SIM_GUIDELINES, (1024,),
              {"allgather": dict(alpha=9e-6, gamma=8e-6)})]
    flags: list = []

    def flagged(fn, fused):
        def call(*args, **kw):
            out = fn(*args, **kw)
            flags.extend(np.asarray(r.errors) for r in (out if fused else [out]))
            return out
        return call

    patches = [(backends, "run_windowed_epochs_torch",
                flagged(backends.run_windowed_epochs_torch, True)),
               (backends, "run_windowed_torch", flagged(backends.run_windowed_torch, False))]
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    sim_durations_scan.launches = 0
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    reports = {}
    try:
        for name, family, msizes, per_op_kw in specs:
            flags.clear()
            l0 = sim_durations_scan.launches
            t = time.perf_counter()
            report = verify_guidelines(family, TorchSimBackend(p=p, device=device,
                                                               per_op_kw=per_op_kw),
                                       design=design, msizes=msizes)
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t
            reports[name] = report
            allflags = np.concatenate(flags)
            print(f"# [16 guidelines] {name} (per_op_kw {per_op_kw}) p={p} nrep={nrep} "
                  f"8 epochs, msizes {list(msizes)} on {device}: wall {wall:.2f} s, "
                  f"{report.n_measured} records, invalid fraction "
                  f"{np.count_nonzero(allflags) / allflags.size:.4f} ({allflags.size} "
                  f"windows), sim_scan launches {sim_durations_scan.launches - l0}; cells: "
                  + "; ".join(f"{v.guideline.name}@{v.msize} {v.verdict} ratio "
                              f"{v.ratio:.4f} Holm p {v.p_holm:.3g} p(<) "
                              f"{v.p_confirmed:.3g}" for v in report.verdicts))
    finally:
        for obj, name, fn in originals:
            setattr(obj, name, fn)
    launches = sim_durations_scan.launches
    if device == "cuda":
        require(launches > 0, "guideline campaigns launched sim_scan")
    honest = reports["honest"]
    require(len(honest.verdicts) == 10 and honest.ok, "honest library: 10 cells, none VIOLATED")
    for name, report in reports.items():
        got = [v.verdict for v in report.verdicts]
        want = GUIDELINE_VERDICTS_P512[name]
        require(got == want, f"guidelines {name}: verdicts {got}, the reference's at p = "
                             f"{p}: {want}")
    require([v.guideline.name for v in reports["alltoall"].violations()]
            == ["alltoall_mock_bound"], "inflated alltoall: only alltoall_mock_bound VIOLATED")
    require(not reports["allgather"].violations()
            and reports["allgather"].verdicts[0].ratio > 1.0,
            "inflated allgather: allgather_pat_alltoall above 1 but, as in the "
            "reference at p = 512, not VIOLATED")
    return launches


def store_dump(store) -> dict:
    """Every record of every campaign in a store, exact times included."""
    import numpy as np

    return {fp: sorted((r.case.op, r.case.msize, r.epoch,
                        tuple(np.asarray(r.times, np.float64).tolist()))
                       for r in store.records(fp))
            for fp in store.fingerprints()}


def phase_fleet(torch, device="cuda", p=512, nrep=10_000) -> int:
    """The fault-tolerant fleet: the serial sweep at p = 512, the same sweep
    on three workers under the CI chaos spec, the CI quarantine spec at
    p = 8 with its fault-free resume, a straggler, and the in-process
    fleet under soft crashes; returns sim_scan's launches in this
    process."""
    from repro_torch.fleet.scheduler import stop_worker_server

    try:
        return _fleet_runs(torch, device, p, nrep)
    finally:
        stop_worker_server()        # the fork server the workers forked from


def _fleet_runs(torch, device, p, nrep) -> int:
    import tempfile
    import warnings

    from repro_torch.campaign import ResultStore, SweepScheduler
    from repro_torch.fleet import FaultPlan, FleetConfig, FleetScheduler
    from repro_torch.kernels.sim_scan import sim_durations_scan
    from repro_torch.sweeps import default_sim_sweep

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_fleet_"))
    on_card = device == "cuda"

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def line(tag, res, wall, launches):
        f = res.fleet
        attempts = f["n_done"] + f["n_failed_attempts"]
        hb = ("" if f["first_heartbeat_s"] is None else
              f", longest start to first heartbeat {f['first_heartbeat_s']:.3f} s, "
              f"longest heartbeat gap "
              + ("none" if f["heartbeat_gap_s"] is None else f"{f['heartbeat_gap_s']:.3f} s")
              + f" ({f['n_heartbeats']} heartbeats), fork server ready in "
              + f"{f['server_start_s']:.2f} s")
        print(f"# [17 fleet] {tag}: wall {wall:.2f} s, {f['start_method']}, "
              f"{f['n_workers']} workers, ttl {f['lease_ttl']:.2f} s, {attempts} attempts, "
              f"{f['n_failed_attempts']} failed, {f['n_quarantined']} quarantined, "
              f"{f['n_corrupt_shard_lines']} corrupt shard lines{hb}; sim_scan launches "
              f"in this process {launches}")

    spec, backend = default_sim_sweep(seed=0, axes=("tuning", "dtype"), msizes=(4096,),
                                      n_launch_epochs=2, nrep=nrep, p=p, device=device)
    # (a) serial
    sim_durations_scan.launches = 0
    serial, wall = timed(lambda: SweepScheduler(spec, backend,
                                                ResultStore(tmp / "serial.jsonl")).run())
    launches = sim_durations_scan.launches
    ref = store_dump(ResultStore(tmp / "serial.jsonl"))
    require(len(serial.cells) == serial.n_cells_measured == 4, "serial: 4 cells measured")
    if on_card:
        require(launches > 0, "serial sweep launched sim_scan")
    print(f"# [17 fleet] (a) serial p={p} nrep={nrep} 2 epochs allreduce@4096, tuning x "
          f"dtype, 4 cells (fused): wall {wall:.2f} s; sim_scan launches {launches}")

    # (b) three workers under the CI chaos spec, at the reference's default ttl
    store = ResultStore(tmp / "chaos.jsonl")
    cfg = FleetConfig(n_workers=3, faults=FaultPlan.parse("crash=0.5,raise=0.3,seed=7"))
    l0 = sim_durations_scan.launches
    chaos, wall = timed(lambda: FleetScheduler(spec, backend, store, cfg).run())
    in_parent = sim_durations_scan.launches - l0
    line("(b) chaos crash=0.5,raise=0.3,seed=7", chaos, wall, in_parent)
    require(not chaos.quarantined and chaos.n_cells_measured == 4,
            "chaos: 4 cells measured, none quarantined")
    require(chaos.fleet["n_failed_attempts"] >= 1, "chaos: faults struck")
    require(chaos.fleet["start_method"] == "forkserver", "chaos: workers from the fork server")
    if on_card:
        require(in_parent == 0, "chaos: no sim_scan launch in this process (no serial fallback)")
    require(store_dump(store) == ref, "chaos fleet (per epoch, in workers) == serial (fused), "
                                      "every record's exact times")
    require(not (tmp / "chaos-shards").exists(), "chaos: shard directory compacted away")
    # the lease for the rest of the phase: three times the longest start-up or
    # heartbeat gap measured under chaos, at least 1 s
    observed = max(chaos.fleet["first_heartbeat_s"] or 0.0,
                   chaos.fleet["heartbeat_gap_s"] or 0.0)
    ttl = max(1.0, 3.0 * observed)
    print(f"# [17 fleet] lease ttl chosen {ttl:.2f} s = 3 x the longest start-up or "
          f"heartbeat gap under chaos ({observed:.3f} s), at least 1 s")

    # (c) the CI quarantine spec at the stock p = 8 on two workers, then resume
    spec8, backend8 = default_sim_sweep(seed=0, axes=("tuning", "dtype"), device=device)
    l0 = sim_durations_scan.launches
    serial8, wall8 = timed(lambda: SweepScheduler(spec8, backend8,
                                                  ResultStore(tmp / "serial8.jsonl")).run())
    launches += sim_durations_scan.launches - l0
    ref8 = store_dump(ResultStore(tmp / "serial8.jsonl"))
    fps = {c.cell.index: c.fingerprint for c in serial8.cells}
    store = ResultStore(tmp / "quarantine.jsonl")
    plan = FaultPlan.parse("crash=0.5,within_calls=1,max_faulty_attempts=99,seed=26")
    l0 = sim_durations_scan.launches
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        quar, wall = timed(lambda: FleetScheduler(
            spec8, backend8, store, FleetConfig(n_workers=2, lease_ttl=ttl,
                                                faults=plan)).run())
    in_parent = sim_durations_scan.launches - l0
    line("(c) quarantine crash=0.5,within_calls=1,max_faulty_attempts=99,seed=26 at p=8 "
         f"(serial reference {wall8:.2f} s)", quar, wall, in_parent)
    require(set(quar.quarantined) == {0, 2}, f"quarantine: cells 0 and 2 (got "
                                             f"{sorted(quar.quarantined)})")
    for idx, info in quar.quarantined.items():
        require(info["fingerprint"] == fps[idx] and info["attempts"] == 3,
                f"quarantined cell {idx}: its fingerprint, 3 attempts")
    require(sum("quarantining sweep cell" in str(w.message) for w in caught) == 2,
            "quarantine: both cells reported")
    got = store_dump(store)
    require(all(fps[i] not in got for i in (0, 2))
            and all(got[fps[i]] == ref8[fps[i]] for i in (1, 3)),
            "quarantine: no partial records; the survivors' records == serial")
    if on_card:
        require(in_parent == 0, "quarantine: no sim_scan launch in this process")
    l0 = sim_durations_scan.launches
    resumed, wall = timed(lambda: FleetScheduler(
        spec8, backend8, store, FleetConfig(n_workers=2, lease_ttl=ttl)).run())
    in_parent = sim_durations_scan.launches - l0
    line("(c) fault-free resume", resumed, wall, in_parent)
    if on_card:
        require(in_parent == 0, "resume: no sim_scan launch in this process")
    require(resumed.n_cells_measured == 2 and resumed.n_cells_resumed == 2
            and not resumed.quarantined, "resume: measures exactly the 2 quarantined cells")
    require(store_dump(store) == ref8, "resume: the store == serial")

    # (d) a straggler on every first attempt, stalled far past the lease
    stall = 20.0 * ttl
    store = ResultStore(tmp / "straggle.jsonl")
    plan = FaultPlan.parse(f"straggle=1.0,straggle_s={stall},seed=3,within_calls=2")
    l0 = sim_durations_scan.launches
    straggle, wall = timed(lambda: FleetScheduler(
        spec, backend, store, FleetConfig(n_workers=3, lease_ttl=ttl, faults=plan)).run())
    in_parent = sim_durations_scan.launches - l0
    line(f"(d) straggler straggle=1.0,straggle_s={stall:.1f}", straggle, wall, in_parent)
    if on_card:
        require(in_parent == 0, "straggler: no sim_scan launch in this process")
    require(straggle.fleet["n_failed_attempts"] >= 1 and not straggle.quarantined,
            "straggler: leases expired, nothing quarantined")
    require(wall < stall / 2, f"straggler: the run ({wall:.1f} s) ended long before the "
                              f"stall ({stall:.1f} s)")
    require(store_dump(store) == ref, "straggler: the store == serial")

    # (e) in-process under soft crashes: the kernel runs in this process
    store = ResultStore(tmp / "inprocess.jsonl")
    plan = FaultPlan.parse("crash=1.0,within_calls=1,seed=0")
    l0 = sim_durations_scan.launches
    inproc, wall = timed(lambda: FleetScheduler(
        spec, backend, store, FleetConfig(n_workers=1, faults=plan)).run())
    in_parent = sim_durations_scan.launches - l0
    launches += in_parent
    line("(e) in-process, soft crashes crash=1.0,within_calls=1", inproc, wall, in_parent)
    require(inproc.fleet["n_failed_attempts"] == 4 and not inproc.quarantined,
            "in-process: one soft crash per cell, none quarantined")
    if on_card:
        require(in_parent > 0, "in-process: sim_scan launched in this process")
    require(store_dump(store) == ref, "in-process fleet (per epoch) == serial (fused)")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    t0 = time.perf_counter()
    phase_device(torch)
    phase_build()
    kernel = phase_kernel(torch)
    phase_engines(torch)
    phase_gate(torch)
    kernel["launches"] = phase_main_path(torch)
    flash, flash_bf16 = phase_flash(torch)
    ssd, ssd_bf16 = phase_ssd(torch)
    # the A/B path in the reference's f32 (the 3xTF32 flash instance), then
    # in bf16 (the bf16 tensor-core one); counts are reset before each
    ab32 = phase_ab(torch, "float32")
    ab16 = phase_ab(torch, "bfloat16")
    flash["launches"], flash_bf16["launches"] = ab32["tf32x3"], ab16["wgmma_bf16"]
    ssd["launches"], ssd_bf16["launches"] = ab32["ssd_scan"], ab16["ssd_scan"]
    # the two paths of random-walk clocks and the barrier scheme
    t = time.perf_counter()
    phase_rw_engines(torch)
    kernel["launches_rw_campaign"] = phase_rw_campaign(torch)
    kernel["launches_barrier"] = phase_barrier(torch)
    print(f"# [10-12] {time.perf_counter() - t:.2f} s")
    # the layers over the campaign: sweeps, the drift audit, the calibration
    t = time.perf_counter()
    kernel["launches_sweep"] = phase_sweeps(torch)
    kernel["launches_audit"] = phase_audit(torch)
    kernel["launches_calibrate"] = phase_calibrate(torch)
    print(f"# [13-15] {time.perf_counter() - t:.2f} s")
    # the guideline family on the simulated campaign, and the fleet
    t = time.perf_counter()
    kernel["launches_guidelines"] = phase_guidelines(torch)
    kernel["launches_fleet"] = phase_fleet(torch)
    print(f"# [16-17] {time.perf_counter() - t:.2f} s")
    print(json.dumps({"kernels": [kernel, flash, flash_bf16, ssd, ssd_bf16]}))
    print(f"# total {time.perf_counter() - t0:.1f} s")
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

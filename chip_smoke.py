#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build the kernels from
this checkout, hold each against its plain PyTorch version on the card,
drive the main path (the simulated measurement campaign) at a size users
run, and check what comes out.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases, each of which raises (exit code 1) on failure:

  1. device: the card's name and power limit, torch / CUDA / nvcc versions;
  2. build: the ``sim_scan`` CUDA kernel, from ``src/repro_torch/kernels``
     into ``build/kernels/``, with its build time;
  3. ``sim_scan`` against its plain version on the card over a grid of
     AR(1) coefficients and shapes, then its time at the main path's shape
     beside its memory bound;
  4. both engines on the card against the port on the CPU, noise-free
     from the same state (a device-only fault shows here);
  5. the archived reference audit campaign
     (``benchmarks/reference_archive/run-000.jsonl``) on the card: each
     cell's median of per-epoch medians within ±10% of the archive's;
  6. the main path at a size users run: p = 512 ranks, 30 launch epochs,
     nrep = 100 000, hca sync, allreduce/bcast/alltoall at 4096 B, fused,
     with its time split into host sync, sampling and window; one epoch of
     the same shape through the CPU path for scale and as a cross-check;
  7. a ``kernels`` JSON line for every kernel of the path.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
``nvidia-smi``'s name and power limit. Without a GPU, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP64_FLOPS = 34e12          # H100 SXM float64 outside the tensor cores


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, after a warm-up."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    from repro_torch.kernels.sim_scan.kernel import load_kernel

    t = time.perf_counter()
    _, log = load_kernel()
    secs = time.perf_counter() - t
    info = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"# [2 build] sim_scan built and loaded in {secs:.2f} s; "
          + " | ".join(info))


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

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2015)
    launches0 = sim_durations_scan.launches
    n_calls, max_err = 0, 0.0
    for coeff in (0.35, 0.0, -0.5, 0.9, 0.004, -0.999):
        for n in (32, 1000, 100_000):
            for R in (1, 30):
                x = scan_inputs(torch, R, n, gen)
                t, s = scan_call(sim_durations_scan, x, coeff)
                torch.cuda.synchronize()
                tr, sr = scan_call(sim_durations_ref, x, coeff)
                n_calls += 1
                require(torch.allclose(t, tr, rtol=1e-12, atol=1e-18),
                        f"sim_scan t vs plain, coeff={coeff} R={R} n={n}: "
                        f"max |err| {(t - tr).abs().max().item():.3e}")
                require(torch.allclose(s, sr, rtol=1e-12, atol=1e-14),
                        f"sim_scan s vs plain, coeff={coeff} R={R} n={n}: "
                        f"max |err| {(s - sr).abs().max().item():.3e}")
                max_err = max(max_err, (t - tr).abs().max().item(),
                              (s - sr).abs().max().item())
    require(sim_durations_scan.launches - launches0 == n_calls,
            "sim_scan launch counter rose once per call")

    R, n = 30, 100_000        # the main path's shape: 30 epochs x nrep 1e5
    x = scan_inputs(torch, R, n, gen)
    ms = cuda_ms(lambda: scan_call(sim_durations_scan, x, 0.35), 50)
    plain_ms = cuda_ms(lambda: scan_call(sim_durations_ref, x, 0.35), 5)
    nbytes = R * n * 6 * 8 + 2 * R * 8        # 4 inputs + 2 outputs, f64
    nops = R * n * 12                         # scan 2, exp 1, mixture 9
    bound_ms = max(nbytes / HBM_BYTES_PER_S, nops / FP64_FLOPS) * 1e3
    print(f"# [3 kernel] sim_scan == plain on {n_calls} cases (rtol 1e-12; "
          f"atol 1e-18 t, 1e-14 s), max |err| {max_err:.3e}; at R={R} "
          f"n={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s), "
          f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s")
    return dict(name="sim_scan", route="cuda",
                source="src/repro_torch/kernels/sim_scan/csrc/sim_scan.cu",
                replaces="src/repro/kernels/sim_scan/kernel.py:86",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None)


def phase_engines(torch):
    import numpy as np

    from repro_torch.core import SimNet, make_op, make_sync
    from repro_torch.simengine import run_windowed_epochs_torch, run_windowed_torch

    noise_free = dict(noise_sigma=0.0, tail_prob=0.0, spike_prob=0.0,
                      rank_imbalance=0.0, epoch_bias_sigma=0.0, autocorr=0.0)

    def epochs(E, p):
        out = []
        for e in range(E):
            net = SimNet(p, seed=5 + 1000 * e)
            sync = make_sync("hca", n_fitpts=100, n_exchanges=20).synchronize(net)
            out.append((net, sync, make_op("allreduce", **noise_free)))
        return out

    cpu = epochs(1, 16)
    gpu = copy.deepcopy(cpu)
    a = run_windowed_torch(*cpu[0], 4096, 2000, 300e-6, device="cpu")
    b = run_windowed_torch(*gpu[0], 4096, 2000, 300e-6, device="cuda")
    require(np.array_equal(a.errors, b.errors), "per-epoch error flags cuda == cpu")
    for k in ("times", "start_true", "end_true", "start_global_est",
              "end_global_est"):
        err = np.abs(getattr(a, k) - getattr(b, k)).max()
        require(err <= 1e-12, f"per-epoch {k} cuda vs cpu |err| {err:.3e} <= 1e-12")
    require(np.abs(cpu[0][0].t - gpu[0][0].t).max() <= 1e-12, "per-epoch net.t")

    cpu = epochs(3, 16)
    gpu = copy.deepcopy(cpu)
    ref = [run_windowed_torch(*c, 4096, 5000, 300e-6, device="cpu") for c in cpu]
    fused = run_windowed_epochs_torch(*map(list, zip(*gpu)), 4096, 5000,
                                      300e-6, device="cuda")
    for r, f in zip(ref, fused):
        require(np.array_equal(r.errors, f.errors), "fused error flags cuda == cpu")
        require(np.allclose(f.times, r.times, rtol=1e-5, atol=0),
                "fused times on cuda vs per-epoch on cpu within rtol 1e-5")
    print("# [4 engines] noise-free: per-epoch cuda == cpu at atol 1e-12 "
          "(p=16, nrep 2000); fused cuda == per-epoch cpu at rtol 1e-5 "
          "(3 epochs, nrep 5000), identical error flags")


def phase_gate(torch):
    import numpy as np

    from repro_torch.campaign import Campaign, CampaignSpec, ResultStore, TorchSimBackend
    from repro_torch.core import ExperimentDesign, TestCase
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
    print(f"# [5 gate] archive spec on the card ({launches} sim_scan launches): "
          "median-of-epoch-medians ratio to the archive: " + ", ".join(cells))


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

    # (module, attribute, wrapper): device spans inside the engine, host
    # time of each step the backend calls
    patches = [(simengine, name, spans.wrap(name, getattr(simengine, name)))
               for name in ("_sample", "_window_fused", "_window",
                            "sim_durations_scan")]
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
    kernel_ms = spans.ms("sim_durations_scan")
    window_ms = spans.ms("_window_fused") + spans.ms("_window")
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
    print(json.dumps({"kernels": [kernel]}))
    print(f"# total {time.perf_counter() - t0:.1f} s")
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

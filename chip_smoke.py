#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build the kernels from
this checkout, hold each against its plain PyTorch version on the card,
drive the two paths (the simulated measurement campaign, and the kernel
A/B campaign) at sizes users run, and check what comes out.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases, each of which raises (exit code 1) on failure:

  1. device: the card's name and power limit, torch / CUDA / nvcc versions;
  2. build: the ``sim_scan``, ``flash_attention`` and ``ssd_scan`` CUDA
     kernels, from ``src/repro_torch/kernels`` into ``build/kernels/``,
     one ``nvcc`` each, all started together; each build's time and its
     ptxas lines (registers, spills, shared memory);
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
  7. ``flash_attention`` against its plain version on the card over the
     reference's shape grid (GQA, MQA, MHA, head dims 16-256), f32 and
     bf16, sliding window, soft-cap, decode, ragged and fully masked rows
     (which must be 0), at the reference's bounds; then its time at
     gemma2-2b widths (S = T = 4096, causal) beside its bound, the plain
     version and ``scaled_dot_product_attention``;
  8. ``ssd_scan`` against its plain version over the reference's grid and
     the sequential recurrence, f32 and bf16; then its time at
     mamba2-1.3b widths (s = 4096, chunk 64) beside its bound and the
     plain version;
  9. the kernel A/B path: the kernel guideline family
     (``flash_attention#cuda ⪯ flash_attention#ref``, ``ssd_scan#cuda ⪯
     ssd_scan#ref``) through ``verify_guidelines`` at gemma2-2b and
     mamba2-1.3b widths, S in {1024, 4096}, with a store; a violated
     guideline (a kernel slower than its plain version) is printed, not
     failed;
 10. a ``kernels`` JSON line for every kernel of both paths.

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
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM bf16 tensor cores, dense

# gemma2-2b attention widths (src/repro/configs/gemma2_2b.py): 8 query
# heads, 4 KV heads, head_dim 256; mamba2-1.3b SSD widths
# (src/repro/configs/mamba2_1_3b.py): d_inner 4096 / head_dim 64 = 64
# heads, head_dim 64, state 128.
GEMMA2_ATTN = dict(heads=8, kv_heads=4, head_dim=256)
MAMBA2_SSD = dict(heads=64, head_dim=64, state_dim=128)
AB_SEQS = (1024, 4096)


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
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.flash_attention.kernel import load_kernel as load_flash
    from repro_torch.kernels.sim_scan.kernel import load_kernel as load_sim
    from repro_torch.kernels.ssd_scan.kernel import load_kernel as load_ssd

    def timed(load):
        t = time.perf_counter()
        _, log = load()
        return time.perf_counter() - t, log

    t0 = time.perf_counter()
    loads = dict(sim_scan=load_sim, flash_attention=load_flash, ssd_scan=load_ssd)
    with ThreadPoolExecutor(len(loads)) as pool:     # one nvcc per source at once
        futures = {name: pool.submit(timed, load) for name, load in loads.items()}
        results = {name: f.result() for name, f in futures.items()}
    for name, (secs, log) in results.items():
        info = [ln.strip().removeprefix("ptxas info    : ")[:72]
                for ln in log.splitlines() if "registers" in ln or "spill" in ln
                or "entry function" in ln]
        print(f"# [2 build] {name} built and loaded in {secs:.2f} s; "
              + " | ".join(info))
    print(f"# [2 build] all three in {time.perf_counter() - t0:.2f} s")


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


def phase_flash(torch) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.flash_attention.kernel import BLOCK_K, BLOCK_Q

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
    # error of up to 0.125 in a logit near 30; the kernel, like the Pallas
    # kernel, keeps logits in f32. So it is held against the plain version
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
    # fully masked rows: a window of 4 under kv_len 32 leaves rows >= 35
    # without a key; kv_len 0 leaves every row without one
    masked = [("fully masked rows (window 4, kv_len 32)", rnd(1, 128, 4, 64),
               rnd(1, 128, 2, 64), rnd(1, 128, 2, 64), dict(window=4, kv_len=32), 2e-5),
              ("fully masked rows (kv_len 0) bf16", *(rnd(1, 64, n, 128, dtype=torch.bfloat16)
                                                      for n in (4, 1, 1)),
               dict(kv_len=0), 2e-2)]
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
    for label, q, k, v, kw, limit, *plain_in_f32 in cases + masked:
        out = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
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
        if "causal" not in kw or kw["causal"]:
            s, t = q.shape[1], k.shape[1]
            qpos = torch.arange(s, device="cuda")[:, None] + kw.get("q_offset", 0)
            kpos = torch.arange(t, device="cuda")[None, :]
            vis = (kpos <= qpos) & (kpos < kw.get("kv_len", t))
            if "window" in kw:
                vis &= (qpos - kpos) < kw["window"]
            dead = ~vis.any(dim=1)
            n_masked_rows += int(dead.sum()) * q.shape[0] * q.shape[2]
            require(bool((out[:, dead] == 0).all()),
                    f"flash {label}: fully masked rows are exactly 0")
    require(n_masked_rows > 0, "the grid had fully masked rows")
    q, k, v = cases[0][1:4]
    a = flash_attention(q, k, v, block_q=128, block_k=128)
    bq = flash_attention(q, k, v, block_q=256, block_k=512)
    require(torch.equal(a, bq), "flash result independent of block_q/block_k")
    n_calls = len(cases) + len(masked) + 2
    require(flash_attention.launches - launches0 == n_calls,
            "flash launch counter rose once per call")

    # gemma2-2b widths, the A/B path's longest case
    b, s, h, hkv, d = 1, 4096, 8, 4, 256
    rows = {}
    for dt, peak in ((torch.float32, FP32_FLOPS), (torch.bfloat16, BF16_FLOPS)):
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
        ms = cuda_ms(lambda: flash_attention(q, k, v), 20)
        plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v), 3)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 20)
        bound_ms, bound_by, flops, moved = attn_bound_ms(b, s, s, h, hkv, d,
                                                         q.element_size(), peak)
        rows[dt] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                        bound_by=bound_by, flops=flops, moved=moved, err=err, rms=rms)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    f32, bf = rows[torch.float32], rows[torch.bfloat16]
    print(f"# [7 flash] == plain on {len(cases) + len(masked)} cases (f32 2e-5, "
          f"soft-cap 3e-5, bf16 2e-2 and RMS err <= 1e-2 RMS of the plain version "
          f"in f32), max |err| f32 {max_err:.3e}, bf16 {bf16_err:.3e}, bf16 "
          f"RMS err / RMS {bf16_rms:.3e}; "
          f"{n_masked_rows} fully masked rows exactly 0; block_q/block_k "
          f"invariant (kernel tile {BLOCK_Q}x{BLOCK_K})")
    for name, r in (("f32", f32), ("bf16", bf)):
        print(f"# [7 flash] gemma2-2b B=1 H=8/4 D=256 S=T=4096 causal {name}: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']} ({r['flops'] / 1e9:.2f} GFLOP, {r['moved'] / 1e6:.1f} MB); "
              f"kernel {r['flops'] / r['ms'] / 1e9:.2f} TFLOP/s; max |err| {r['err']:.3e}"
              + (f", RMS err / RMS {r['rms']:.3e}" if r["rms"] is not None else ""))
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:113",
                max_abs_err=max_err, ms=f32["ms"], plain_ms=f32["plain_ms"],
                bound_ms=f32["bound_ms"], bound_by=f32["bound_by"],
                library_ms=f32["library_ms"])


def ssd_flops_bytes(b, s, h, p, n, chunk, nbytes):
    """Operations of the chunked SSD form (C B^T once per chunk, shared by
    the heads; the intra product over the lower triangle; the inter term
    and the state update) and the bytes read and written once."""
    nc, tail = divmod(s, chunk)
    tri = nc * chunk * (chunk + 1) // 2 + tail * (tail + 1) // 2
    flops = 2.0 * b * (tri * n + h * tri * p + 2 * h * s * p * n)
    moved = nbytes * (2 * b * s * h * p + 2 * b * s * n) + 4 * b * s * h
    return flops, moved


def phase_ssd(torch) -> dict:
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
    max_err = 0.0
    grid = [(2, 128, 8, 16, 32, 32, 4), (1, 256, 16, 32, 64, 64, 8),
            (2, 256, 8, 64, 128, 128, 8), (1, 200, 4, 64, 128, 64, 4),
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
            if dt == torch.float32:
                max_err = max(max_err, (y - yr).abs().max().item())
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

    b, s, h, p, n, chunk = 1, 4096, 64, 64, 128, 64     # mamba2-1.3b, A/B chunk
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        x, dta, B, C = inputs(b, s, h, p, n, dt)
        ms = cuda_ms(lambda: ssd_scan(x, dta, B, C, chunk=chunk, head_group=8), 20)
        plain_ms = cuda_ms(lambda: ssd_chunked(x, dta, B, C, chunk), 5)
        flops, moved = ssd_flops_bytes(b, s, h, p, n, chunk, x.element_size())
        peak = FP32_FLOPS if dt == torch.float32 else BF16_FLOPS
        bound_ms, bound_by = bound(flops, peak, moved)
        rows[dt] = dict(ms=ms, plain_ms=plain_ms, flops=flops, moved=moved,
                        bound_ms=bound_ms, bound_by=bound_by)
    f32 = rows[torch.float32]
    print(f"# [8 ssd] == plain on {n_calls - 3} cases (max err / max|y| f32 "
          f"{worst[torch.float32]:.3e} < 1e-5, bf16 {worst[torch.bfloat16]:.3e} < 3e-2), "
          f"max |err| f32 {max_err:.3e}; == sequential recurrence (2e-4); "
          "head_group invariant")
    for name, r in (("f32", f32), ("bf16", rows[torch.bfloat16])):
        print(f"# [8 ssd] mamba2-1.3b b=1 s=4096 h=64 p=64 n=128 chunk 64 {name}: "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['flops'] / 1e9:.2f} GFLOP, "
              f"{r['moved'] / 1e6:.1f} MB); kernel {r['flops'] / r['ms'] / 1e9:.2f} TFLOP/s")
    return dict(name="ssd_scan", route="cuda",
                source="src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan/kernel.py:88",
                max_abs_err=max_err, ms=f32["ms"], plain_ms=f32["plain_ms"],
                bound_ms=f32["bound_ms"], bound_by=f32["bound_by"], library_ms=None)


def phase_ab(torch) -> dict:
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
            fn = {impl: make_benchmark_op(op, impl, seq=seq, batch=1, seed=0, **widths)
                  for impl in ("cuda", "ref")}
            require(all(torch.equal(a, b) for a, b in
                        zip(fn["cuda"].inputs, fn["ref"].inputs)),
                    f"A/B {op}@{seq}: both sides draw the same inputs")
            out, ref = fn["cuda"](), fn["ref"]()
            require(out.shape == ref.shape and torch.isfinite(out).all(),
                    f"A/B {op}@{seq}: finite, shape")
            if op == "flash_attention":
                err = (out - ref).abs().max().item()
                require(torch.allclose(out, ref, rtol=2e-5, atol=2e-5),
                        f"A/B {op}@{seq}: #cuda == #ref, max |err| {err:.3e} within 2e-5")
            else:
                err = rel_err(out, ref)
                require(err < 1e-5, f"A/B {op}@{seq}: #cuda == #ref, max err / "
                        f"max|y| {err:.3e} < 1e-5")
            agree.append(f"{op}@{seq} {err:.3e}")
            del fn, out, ref
            torch.cuda.empty_cache()
    print("# [9 A/B] the timed #cuda and #ref callables agree on the A/B's inputs "
          "(flash max |err|, ssd max err / max|y|): " + ", ".join(agree))

    reports, walls = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "ab.jsonl"
        torch.cuda.synchronize()
        flash_attention.launches = ssd_scan.launches = 0
        for op, kernel, widths in runs:
            backend = TorchKernelBackend(batch=1, seed0=0, **widths)
            t = time.perf_counter()
            report = verify_guidelines([family[op]], backend, design=design,
                                       store=ResultStore(path), name=f"ab-{op}")
            torch.cuda.synchronize()
            walls[op] = time.perf_counter() - t
            reports[op] = report
            require(report.n_measured == 2 * len(AB_SEQS) * design.n_launch_epochs,
                    f"A/B {op}: every cell measured ({report.n_measured})")
            require(all(v.n_epochs == design.n_launch_epochs for v in report.verdicts),
                    f"A/B {op}: every cell has one record per epoch")
            print(format_report(report, title=f"kernel A/B [{op}] {widths}"))
            if not report.ok:
                print(format_violations(report))
        launches = dict(flash_attention=flash_attention.launches,
                        ssd_scan=ssd_scan.launches)
        snap = ResultStore(path).snapshot()
    for op, n in launches.items():
        require(n > 0, f"A/B {op}: the kernel launched on the #cuda side")
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
        print(f"# [9 A/B] {op}: wall {walls[op]:.2f} s = building inputs "
              f"{build:.2f} s ({len(recs)} builds) + timed kernel calls "
              f"{timed['#cuda']:.2f} s ({reps['#cuda']} calls) + timed plain calls "
              f"{timed['#ref']:.2f} s ({reps['#ref']} calls) + rest (warm-ups, "
              f"epoch isolation, store, statistics) "
              f"{walls[op] - build - timed['#cuda'] - timed['#ref']:.2f} s; "
              f"kernel launches {launches[op]}")
    print(f"# [9 A/B] store reloaded with {n_records} records; verdicts: " + ", ".join(
        f"{v.guideline.name}@{v.msize} {v.verdict} ratio {v.ratio:.3f}"
        for r in reports.values() for v in r.verdicts))
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
    flash = phase_flash(torch)
    ssd = phase_ssd(torch)
    launches = phase_ab(torch)
    flash["launches"] = launches["flash_attention"]
    ssd["launches"] = launches["ssd_scan"]
    print(json.dumps({"kernels": [kernel, flash, ssd]}))
    print(f"# total {time.perf_counter() - t0:.1f} s")
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

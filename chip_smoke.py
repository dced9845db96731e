#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build the kernels from
this checkout, hold each against its plain PyTorch version on the card,
drive the paths (the simulated measurement campaign, the kernel A/B
campaign, on random-walk clocks campaigns and the barrier scheme, the
factor sweeps, drift audit and calibration over the campaign, the
performance-guideline family, the fault-tolerant sweep fleet, the model
zoo's serving path, its training path, real collectives on
``torch.distributed``, the sharded model with its dry run, the five
reference walkthroughs of ``examples/``, and the reference's numpy
engines, the barrier scheme's included, and real collectives inside
fleet attempts) at sizes users run, and check what comes out.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases, each of which raises (exit code 1) on failure:

  1. device: the card's name and power limit, torch / CUDA / nvcc versions;
  2. build: the ``sim_scan``, ``flash_attention`` (CUDA cores, bf16 at
     head dims 16 and 32), ``flash_attention_sm90`` (tensor cores, bf16),
     ``flash_attention_tf32`` (tensor cores, f32 in 3xTF32), ``ssd_scan``
     and ``hca_timeline`` CUDA sources, from ``src/repro_torch/kernels`` into
     ``build/kernels/``,
     one ``nvcc`` each, all started together; each build's time and its
     ptxas lines (registers, spills, shared memory, performance warnings);
  3. ``sim_scan`` against its plain version on the card over a grid of
     AR(1) coefficients and shapes (R in {1, 30, 200}, lengths around one
     tile and 1e5), each case launched twice and held bit-identical, then
     its times at the main path's two shapes (the fused R = 30 call and an
     R = 1 top-up, n = 1e5) beside its memory bound;
 3b. ``hca_timeline`` at the shapes of phase 6's sync (HCA's tree at p
     512, 200 x 40: rounds of 256, 128, ..., 1 pairs, 16221 latencies a
     pair) against its plain version on the same inputs on the CPU, to
     the bit, then its time per round beside its memory bound and the
     plain version's on the card, and a sync's 9 rounds summed;
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
     shapes ``sim_scan`` was launched at; each sync's tree on the card (9
     ``hca_timeline`` launches and 511 pairs a sync); one epoch of the same shape
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
     plain version and ``scaled_dot_product_attention``; then the head
     dims the kernels run zero-padded, zamba2-7b's attention (32/32
     heads, D 112) and deepseek-v2's MLA (128 heads, D 192) at S = T =
     4096, each held against the plain version in f32 (f32 within 1e-5
     of max, bf16 at phase 7's bf16 check) and timed the same way;
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
     window scheme's global mean) with both barriers' skew profiles; then
     ``engine="batch"`` (the reference's draws in its order, scanned by
     ``sim_scan`` on the card) on ``"cuda"`` against ``"cpu"`` from one
     state, as phase 24 holds the numpy engines: noise-free and live at
     p = 16 on affine clocks, then Figs. 11-12's barrier at p = 512, nrep
     10 000 (Fig. 11's inequality again); walking clocks under
     ``"batch"`` on the card raise ``ValueError``;
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
 18. the model zoo on the card: every ``SMOKE`` architecture in f32,
     weights drawn on the CPU and moved, through ``forward``, ``prefill``
     of 8 tokens and 4 ``decode_step`` calls, card (the ``tf32x3`` flash
     kernel) == CPU (``attention_reference``) within 1e-4 of max |logit|,
     prefill == repeated decode within 2e-4, flash launches per
     architecture;
 19. gemma2-2b at full width (weights from a seeded generator on the
     card): (a) f32 ``make_prefill_step`` at B 1, S 8192, kernel ==
     ``impl="ref"`` within 1e-4 of max |logit|, each layer's attention
     output against the plain path on the same input within 1e-5 of its
     max; (b) bf16, the serving run of ``examples/serve_lm_torch.py``
     (batch 4, prompt 128, 32 greedy steps: prefill tokens/s, the
     Tukey-filtered step latency with its 95% CI, peak memory,
     ``wgmma_bf16`` launches); (c) bf16 decode at depth 8192 (batch 8, a
     seeded cache with keys at std ``CACHE_KEY_STD``, pos 8190, 8 steps):
     every attention call held against the plain version in f32 on its
     own inputs at phase 7's bf16 check, the logits against
     ``impl="ref"`` and against the model with f32 attention within
     ``BF16_DECODE_BOUND``, with the top-1 agreement, and two wrong
     attentions (zero, no window) that must fail both checks; (d)
     ``torch.profiler`` over 5 decode steps at (b)'s and (c)'s shapes
     (device time in flash, matmuls and the rest, the idle share, the
     host ops), and one local and one global layer's flash call on (c)'s
     cache, each held at phase 7's bf16 check, the global one timed alone
     beside its bound and SDPA on the same tensors;
 20. the training path: (a) every ``SMOKE`` architecture's train step
     (``impl="ref"``, remat) on the card and the CPU from the same
     weights, two steps, TF32 off: loss, gradient norm and every updated
     weight within 1e-4; (b) ``examples/train_lm_torch.py``'s ``small``
     preset, clean and with a failure at step 45 (async checkpoints, one
     restart, final losses within 1e-4), then
     ``examples/compressed_dp_torch.py``; (d) gemma2-2b at full width in
     f32, B 1, S 1024: the gradient with remat equal to the one without
     within 1e-5 of each weight's max; (c) gemma2-2b in bf16, B 1, S 8192,
     remat, ``ce_chunk`` 8, 2 warm-up and 8 timed steps on one batch: the
     loss down by 10%, the gradient guard's refusal, the step's time with
     its CI, tokens/s, bound, peak memory and a profile (idle share,
     device time by class), then a prefill step on the trained weights;
 21. real collectives through ``TorchCollectiveBackend`` (no kernel of
     the port: NCCL's and gloo's own collectives are what is measured):
     (a) NCCL at world size 1, ``psum``, ``all_gather`` and ``all_to_all``
     at 1 KiB, 64 KiB and 16 MiB in f32 and bf16, each output equal to
     ``expected_collective`` exactly, the median of 100 timed repetitions
     (a barrier, then the maximum of the ranks' local times) with the
     card's bound beside each 16 MiB time, then a 3-epoch campaign at nrep
     100 over ``default_cases()`` stored and reloaded; (b) gloo with CUDA
     tensors, four ranks sharing the card: the same ops at 1 KiB, 64 KiB
     and 1 MiB plus ``psum+all_gather`` and ``psum@half``, held exactly,
     with each group's start-up and the rank skew, the same four ranks on
     CPU tensors (the host's ring alone), and a 3-epoch campaign on a
     fresh group each epoch; (c) NCCL across ranks where there are
     two GPUs, else one line saying why not and a check that the refusal
     raises before any process starts; (d) the sim <-> real fit of
     ``examples/calibrate_sim_torch.py --target collective`` against (b)'s
     backend (the reference CLI's knobs, epochs and nrep, 4 rounds): the
     fitted values, objective, verdict (a finding, not a gate) and wall,
     its store reloaded; (e) a rank SIGKILLed between two ``measure``
     calls: the next raises within the timeout and no rank is left; (f)
     a fleet of two workers over two gloo ranks sharing the card, on the
     ``dtype`` grid (float32, bfloat16) of (b)'s ops and sizes, 3 epochs,
     one attempt crashed mid-epoch: each attempt starts its own groups,
     the cells, fingerprints and case sets equal the serial run's, with
     the attempts, retries, quarantines, each group's start-up and both
     walls, and no rank process alive afterwards;
 22. sharding and launch analysis, in a process of its own (so that no
     process group outlives it): (a) the dry run of gemma2-2b's
     train_4k, prefill_32k and decode_32k cells on the 16x16 mesh (and
     decode_32k on 2x16x16) over a fake world of 256 (512) ranks, every
     tensor on ``meta``: each report's three roofline terms against the
     ``H100`` record, bottleneck, useful-FLOPs ratio, roofline fraction,
     argument bytes per device against 80 GB and the cell's wall; (b)
     gemma2-2b at full width in bf16 with its weights as DTensors placed
     by ``param_specs`` on a 1x1 NCCL mesh (world size 1): a prefill step
     at B 1, S 8192 and 4 decode steps at batch 4 after a 128-token
     prompt, bit-equal to the plain model on the same weights, each
     step's time both ways, the flash kernel launched once a layer on the
     local shards through ``local_map`` (``launches_sharded``, counted by
     the wrapper, each a ``wgmma_bf16`` launch); first the plain model's
     prefill at that shape, each of its flash calls held at phase 7's
     bf16 check and its logits within ``BF16_DECODE_BOUND`` of the plain
     path's (``impl="ref"``); (c) phase 20c's train step counted by
     ``lower_cell`` at world size 1 beside the same step run on the card:
     FLOPs, bytes, the roofline bound, the measured step, the predicted
     peak against ``max_memory_allocated`` (a finding, not a gate); (d)
     four gloo ranks sharing the card, a 2x2 ``"cuda"`` mesh, gemma2-2b
     in bf16 at full width: a prefill at batch 2, S 2048 and 2 decode
     steps, the flash kernel on each rank's batch and head shards in
     every layer (q and k that arrive as partial sums are reduce-scattered
     onto heads; the functional reduce-scatter is probed first on a small
     tensor), every local call held at phase 7's bf16 check, each rank's
     part of the logits within ``BF16_DECODE_BOUND`` of the unsharded
     model's and the plain path's;
 23. the five reference walkthroughs of ``examples/`` on the card, each
     through its ``main`` with ``--device cuda`` at the reference's sizes,
     in the order of ``examples/``: ``compare_impls_torch`` (the f32 flash
     kernel against its plain version at S 128 and 256, B 2, 4/2 heads,
     D 64; two rows, the verdicts printed, not gated),
     ``factor_impact_torch`` (16 cells; tuning first and Holm-significant,
     dtype null; the resume measures nothing; the store round trip names
     tuning), ``quickstart_torch`` (the reference's two HCA lines to the
     printed digit; both Wilcoxon rows A<B), ``repro_audit_torch`` (6/6
     EQUIVALENT; exactly the two bcast cells DRIFTED; the resume loads 2
     and recomputes 4) and ``verify_guidelines_torch`` (the honest 10 cells
     hold; the resume measures nothing; exactly ``alltoall_mock_bound``'s
     2 cells VIOLATED); each walkthrough's wall and launches, the phase's
     wall;
 24. the reference's numpy engines (``engine="batch" | "batch_rw" |
     "auto"``), their durations drawn on the host in the reference's
     order and scanned by ``sim_scan`` on the card: (a) the archived
     reference run through ``TorchSimBackend(engine="batch")``, then
     ``"auto"``: on ``"cpu"`` all 72 records bit-equal to
     ``run-000.jsonl``, on ``"cuda"`` the same record lengths, every
     ``execute_batch`` call's durations within 1e-12 relative of the
     CPU's and the records within 1e-12 of the campaign's timeline; (b)
     phase 6's shape (p = 512, nrep 1e5, hca 200 x 40, allreduce at 4096
     B, one epoch) through ``run_windowed(engine="batch")`` on ``"cpu"``
     and ``"cuda"`` from one state: equal flags, durations within 1e-12
     relative, times and stamps within 1e-12 of the timeline, both walls
     beside phase 6's per-epoch wall; (c) ``batch_rw`` on phase 10's
     walking clocks at p = 64, nrep 1e4 then 3333 on the grown paths, the
     same checks; (d) ``engine="scalar"`` on the card and ``"jax"`` raise
     ``ValueError``;
 25. a ``kernels`` JSON line for every kernel of the paths, flash and SSD
     once per type; ``sim_scan``'s entry counts its launches on the main
     path, on the two paths of phases 11 and 12, on the three of phases
     13-15, on phases 16 and 17 (this process only) and in phase 21d's
     fit (``launches_collective_calibrate``); the two flash
     entries add ``launches_serve``, their launches on the serving path
     (phases 18 and 19a for ``tf32x3``, 19b for ``wgmma_bf16``), and the
     bf16 entry its time at 19d's depth-8192 decode call; both add
     ``launches_train``, their launches in phase 20's train steps (0: the
     train step runs the plain attention, held so), and ``padded``, phase
     7's padded calls; the bf16 entry adds ``launches_sharded``, its
     launches on DTensors' local shards in phase 22b, and
     ``launches_sharded_ranks``, those of 22d's four ranks; ``sim_scan``'s
     and the f32 flash entry add ``launches_examples``, their launches in
     phase 23's walkthroughs; ``sim_scan``'s adds ``launches_batch``, its
     launches under the numpy engines in phase 24, and
     ``launches_barrier_batch``, those of phase 12's card calls under
     ``engine="batch"``; ``hca_timeline``'s entry holds phase 3b's times
     at the first round (256 pairs) and, as ``*_sync``, a sync's 9
     rounds summed, and counts its launches on the main path.

Every timed kernel in phases 3, 3b, 7 and 8 has ``nvidia-smi``'s SM clock
(now and max), power draw and temperature, sampled right before and after
it, printed beside its time.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
``nvidia-smi``'s name and power limit. Without a GPU, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
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


def cuda_ms(fn, reps: int, queued: bool = False, spin: float = 2e5,
            host: list | None = None) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, after a warm-up.

    ``queued``: the stream is held by a spin kernel (``spin`` cycles, ~100
    us at the default, per call) while the host queues the calls, so the
    events time the device's work back to back, not the host's enqueue
    rate, for calls shorter than their host overhead. A list passed as
    ``host`` receives the host's us per call of that loop (with
    ``queued``, the device never stalls it)."""
    import torch

    fn()
    if queued:
        torch.cuda.synchronize()
        torch.cuda._sleep(int(spin * reps))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if host is not None:
        host.append((time.perf_counter() - t) / reps * 1e6)
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def trace(torch, fn, reps=5, host=None) -> tuple[dict, float]:
    """``torch.profiler`` over ``reps`` calls of ``fn`` after a warm-up:
    device time per call of each kernel (by name, cut to 60 characters)
    and the share of the calls' CUDA-event span the kernels fill. A dict
    passed as ``host`` receives each host op's self CPU ms and count per
    call (the profiler's own cost included)."""
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
            if host is not None:
                host[e.key[:40]] = (e.self_cpu_time_total / 1e3 / reps, e.count // reps)
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
    included. Only this script wraps; the library's own spans
    (``repro_torch.core.telemetry``) are on the host's clock."""

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
    from repro_torch.kernels.hca_timeline.kernel import load_kernel as load_hca
    from repro_torch.kernels.sim_scan.kernel import load_kernel as load_sim
    from repro_torch.kernels.ssd_scan.kernel import load_kernel as load_ssd

    def timed(load):
        t = time.perf_counter()
        _, log = load()
        return time.perf_counter() - t, log

    t0 = time.perf_counter()
    loads = dict(sim_scan=load_sim, flash_attention=load_flash,
                 flash_attention_sm90=load_flash90, flash_attention_tf32=load_flash32,
                 ssd_scan=load_ssd, hca_timeline=load_hca)
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


def phase_hca_timeline(torch) -> dict:
    from repro_torch.core import SimNet
    from repro_torch.core.sync.base import RTT_PINGPONGS, RTT_WARMUP
    from repro_torch.kernels.hca_timeline import hca_timeline, hca_timeline_ref, row_length

    # phase 6's sync: HCA at p 512, 200 fitpoints x 40 exchanges, whose
    # tree runs 9 rounds of 256, 128, ..., 1 pairs on the card
    p, nseg, nx = 512, 200, 40
    net = SimNet(p, seed=0).net
    L = row_length(RTT_WARMUP, RTT_PINGPONGS, nseg, nx)
    kw = dict(warmup=RTT_WARMUP, counted=RTT_PINGPONGS, nseg=nseg, nx=nx,
              oh=net.proc_overhead)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2015)
    f64 = dict(dtype=torch.float64, device="cuda")
    launches0 = hca_timeline.launches
    rows = {}
    for K in (256, 128, 64, 32, 16, 8, 4, 2, 1):
        # the latencies as the tree forms them from the host's draws
        lat = net.one_way * torch.exp(net.jitter_sigma * torch.randn(K, L, generator=gen, **f64))
        lat = torch.where(torch.rand(K, L, generator=gen, **f64) < net.spike_prob,
                          lat * net.spike_scale, lat)
        t_ref, t_cli = (torch.rand(K, generator=gen, **f64) for _ in range(2))
        got = hca_timeline(lat, t_ref, t_cli, **kw)
        # the plain version on the CPU adds in numpy's order, as the kernel does
        want = hca_timeline_ref(lat.cpu(), t_ref.cpu(), t_cli.cpu(), **kw)
        require(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
                f"hca_timeline K={K}: equal to its plain version to the bit")
        ms, clk = clocked(lambda: cuda_ms(lambda: hca_timeline(lat, t_ref, t_cli, **kw),
                                          20, queued=True, spin=4e5))
        plain_ms = cuda_ms(lambda: hca_timeline_ref(lat, t_ref, t_cli, **kw), 3)
        # reads each latency and both true times; writes the counted
        # ping-pongs' two times, the sweep's two, three per segment and two
        nbytes = 8 * K * (L + 2 + 2 * RTT_PINGPONGS + 2 * nseg * nx + 3 * nseg + 2)
        rows[K] = dict(ms=ms, plain_ms=plain_ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        print(f"# [3b hca_timeline] K={K} pairs x {L} latencies: == plain to the bit; "
              f"kernel {ms:.4f} ms {clk}, plain {plain_ms:.4f} ms, bound "
              f"{rows[K]['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s), "
              f"{rows[K]['bound_ms'] / ms:.3f} of the bound")
        del lat, got
    require(hca_timeline.launches - launches0 == 9 + 9 * 21,
            "hca_timeline launch counter rose once per call")
    sync = {k: sum(r[k] for r in rows.values()) for k in ("ms", "plain_ms", "bound_ms")}
    print(f"# [3b hca_timeline] a sync's 9 rounds: kernel {sync['ms']:.4f} ms, plain "
          f"{sync['plain_ms']:.4f} ms, bound {sync['bound_ms']:.4f} ms; each pair's "
          f"{2 * (RTT_WARMUP + RTT_PINGPONGS) + nseg} steps in order on one thread")
    first = rows[256]
    return dict(name="hca_timeline", route="cuda",
                source="src/repro_torch/kernels/hca_timeline/csrc/hca_timeline.cu",
                replaces=None, max_abs_err=0.0, ms=first["ms"], plain_ms=first["plain_ms"],
                bound_ms=first["bound_ms"], bound_by="bytes", library_ms=None,
                ms_sync=sync["ms"], plain_ms_sync=sync["plain_ms"],
                bound_ms_sync=sync["bound_ms"])


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


def phase_main_path(torch) -> tuple[int, int, float]:
    import numpy as np

    from repro_torch import simengine
    from repro_torch.campaign import Campaign, CampaignSpec, TorchSimBackend
    from repro_torch.core import ExperimentDesign, TestCase, telemetry
    from repro_torch.kernels.hca_timeline import hca_timeline
    from repro_torch.kernels.sim_scan import sim_durations_scan

    p, epochs, nrep = 512, 30, 100_000
    cases = [TestCase(op, 4096) for op in ("allreduce", "bcast", "alltoall")]
    spans = Spans()

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

    # (module, attribute, wrapper): device spans inside the engine; the host
    # time of each step comes from the program's own spans
    patches = [(simengine, name, spans.wrap(name, getattr(simengine, name)))
               for name in ("_sample", "_window")]
    patches.append((simengine, "sim_durations_scan", kernel_by_shape))
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        spec = CampaignSpec(cases, ExperimentDesign(n_launch_epochs=epochs, nrep=nrep,
                                                    seed=0), name="main-path")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sim_durations_scan.launches = hca_timeline.launches = 0
        t = time.perf_counter()
        with telemetry.recording():
            res = Campaign(spec, TorchSimBackend(p=p, seed0=0)).run()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches, hca_launches = sim_durations_scan.launches, hca_timeline.launches
        peak = torch.cuda.max_memory_allocated()
    finally:
        for obj, name, fn in originals:
            setattr(obj, name, fn)
    sample_ms = spans.ms("_sample")
    rows_ms = {R: spans.ms(f"sim_scan R={R}") for R in sorted(by_rows)}
    kernel_ms = sum(rows_ms.values())
    window_ms = spans.ms("_window")
    snap = telemetry.snapshot()
    host = snap["totals"]
    none = dict(count=0, total_s=0.0)
    # every per-epoch window of this fused campaign is a top-up
    sync, fused, topup = (host.get(k, none) for k in ("sync", "engine.fused", "engine.window"))

    require(launches > 0, "main path launched sim_scan")
    # each epoch's sync runs HCA's tree on the card: 9 rounds, 511 pairs
    require(hca_launches == 9 * sync["count"] and sync["count"] == epochs
            and snap["counters"].get("sync.hca.pairs_on_device") == 511 * epochs,
            f"main path: {hca_launches} hca_timeline launches and "
            f"{snap['counters'].get('sync.hca.pairs_on_device')} pairs on the card for "
            f"{sync['count']} syncs (9 and 511 each)")
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
          f"{sync['total_s']:.2f} s ({sync['count']} epochs) + fused engine calls "
          f"{fused['total_s']:.2f} s ({fused['count']} calls) + per-epoch top-up calls "
          f"{topup['total_s']:.2f} s ({topup['count']} calls) + rest "
          f"{wall - sync['total_s'] - fused['total_s'] - topup['total_s']:.2f} s; "
          f"read-back copies of all windows {host['engine.copy_out']['self_s']:.2f} s; "
          "device spans: sampling "
          f"{sample_ms / 1e3:.3f} s (sim_scan kernel {kernel_ms / 1e3:.4f} s), "
          f"window {window_ms / 1e3:.3f} s; kernel share of device spans "
          f"{kernel_ms / (sample_ms + window_ms):.4f}, of wall "
          f"{kernel_ms / 1e3 / wall:.5f}; sim_scan launches {launches}, hca_timeline "
          f"{hca_launches} (HCA's tree on the card, 511 pairs a sync); peak "
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
    return launches, hca_launches, wall / epochs


def rel_err(a, b) -> float:
    """max |a - b| / max |b|, in float32."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def attn_bound_ms(b, s, t, h, hkv, d, nbytes, flops_peak, causal=True,
                  q_offset=0, window=None):
    """Least time for attention: the two products over the (q, k) pairs the
    mask leaves, or q, k, v read and o written once, whichever is longer."""
    if causal:
        pairs = sum(min(t, q_offset + i + 1, window or t) for i in range(s))
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


#: Head dims the flash kernels run zero-padded to the next built one, at
#: full width: zamba2-7b's attention (src/repro/configs/zamba2_7b.py: 32
#: query and 32 KV heads of 112) and deepseek-v2's MLA
#: (src/repro/configs/deepseek_v2_236b.py: 128 heads of 128 + 64 = 192,
#: keys decompressed per head). B 1, S = T = 4096, causal.
PADDED_ATTN = {"zamba2-7b d112": dict(h=32, hkv=32, d=112),
               "deepseek-v2 MLA d192": dict(h=128, hkv=128, d=192)}


def plain_by_heads(torch, q, k, v, heads=16):
    """The plain version in f32 on q, k, v's values, 16 heads at a time
    (one head per KV head here), so that its logits take ~1 GB, not 8.6."""
    from repro_torch.kernels.flash_attention import flash_attention_ref

    return torch.cat([flash_attention_ref(q[:, :, i:i + heads].float(),
                                          k[:, :, i:i + heads].float(),
                                          v[:, :, i:i + heads].float())
                      for i in range(0, q.shape[2], heads)], dim=2)


def flash_padded(torch, rnd) -> dict:
    """Phase 7's padded calls: each :data:`PADDED_ATTN` width in f32 (held
    within ``F32_LAYER_BOUND`` of its max, 19a's bound) and bf16 (phase
    7's bf16 check, :func:`bf16_held`) against the plain version in f32,
    each one padded launch, timed beside its bound (the unpadded work),
    the plain version and SDPA on the same tensors."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.flash_attention.kernel import padded_head_dim

    b, s = 1, 4096
    rows = {}
    for name, w in PADDED_ATTN.items():
        h, hkv, d = w["h"], w["hkv"], w["d"]
        for dt, peak in ((torch.float32, TF32_FLOPS / 3), (torch.bfloat16, BF16_FLOPS)):
            q, k, v = (rnd(b, s, n, d, dtype=dt) for n in (h, hkv, hkv))
            padded = flash_attention.launches_padded
            out = flash_attention(q, k, v)
            torch.cuda.synchronize()
            require(flash_attention.launches_padded == padded + 1 and out.shape == q.shape,
                    f"[7 padded] {name} {dt}: one padded launch, output (B, S, H, {d})")
            ref32 = plain_by_heads(torch, q, k, v)
            if dt == torch.float32:
                err, rms = rel_err(out, ref32), None
                require(err <= F32_LAYER_BOUND, f"[7 padded] {name} f32: kernel == plain at "
                        f"{err:.3e} <= {F32_LAYER_BOUND} of max |out|")
            else:
                err, rms, held = bf16_held(out, ref32)
                require(held, f"[7 padded] {name} bf16: phase 7's bf16 check (max |err| "
                        f"{err:.3e}, RMS err / RMS {rms:.3e})")
            del out, ref32
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            ms, clk = clocked(lambda: cuda_ms(lambda: flash_attention(q, k, v), 10))
            plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v), 2)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), 10)
            bound_ms, bound_by, flops, moved = attn_bound_ms(b, s, s, h, hkv, d,
                                                             q.element_size(), peak)
            rows.setdefault(dt, {})[name] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_err=err, launches=1)
            print(f"# [7 padded] {name} -> {padded_head_dim(d)}, B 1, H {h}/{hkv}, "
                  f"S = T = 4096 causal, {str(dt)[6:]}: kernel == plain in f32 at "
                  + (f"{err:.3e} of max |out|" if rms is None else
                     f"max |err| {err:.3e}, RMS err / RMS {rms:.3e}")
                  + f"; kernel {ms:.4f} ms {clk}, bound {bound_ms:.4f} ms by {bound_by} "
                  f"({flops / 1e9:.2f} GFLOP, {moved / 1e6:.1f} MB), plain {plain_ms:.4f} ms, "
                  f"sdpa {lib_ms:.4f} ms")
            del q, k, v, qt, kt, vt
            torch.cuda.empty_cache()
    return rows


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
    padded = flash_padded(torch, rnd)
    common = dict(route="cuda", replaces="src/repro/kernels/flash_attention/kernel.py:113")
    tf32 = dict(name="flash_attention", dtype="float32",
                source="src/repro_torch/kernels/flash_attention/csrc/flash_attention_tf32.cu",
                max_abs_err=max_err, **common,
                **{k: f32[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    wgmma = dict(name="flash_attention_bf16", dtype="bfloat16",
                 source="src/repro_torch/kernels/flash_attention/csrc/flash_attention_sm90.cu",
                 max_abs_err=bf16_err, **common,
                 **{k: bf[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    tf32["padded"], wgmma["padded"] = padded[torch.float32], padded[torch.bfloat16]
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


def barrier_pair(torch, net, sync, op, msize, nrep, what, **kw) -> dict:
    """One ``run_barrier_timed(engine="batch")`` on ``"cpu"`` and on
    ``"cuda"`` from one state (the net, sync and op copied first), held
    as phase 24 holds the numpy engines: ``sim_scan`` launched once on the
    card and never on the CPU, the durations within 1e-12 relative, every
    time, stamp and barrier exit within 1e-12 of the run's timeline (its
    largest stamp), ``net.t``, the AR(1) state and the generator's state
    the same. Returns the two runs, walls and differences."""
    import numpy as np

    from repro_torch.core import run_barrier_timed
    from repro_torch.kernels.sim_scan import sim_durations_scan

    card = copied_state(net, sync, op)
    out, runs, durs = {}, {}, {}
    for device, state in (("cpu", (net, sync, op)), ("cuda", card)):
        with captured_durations([], "sample_durations") as durs[device]:
            launches = sim_durations_scan.launches
            t = time.perf_counter()
            runs[device] = run_barrier_timed(state[0], state[2], msize, nrep, sync=state[1],
                                             device=device, engine="batch", **kw)
            torch.cuda.synchronize()
            out[f"{device}_s"] = time.perf_counter() - t
            out[f"{device}_launches"] = sim_durations_scan.launches - launches
    a, b = runs["cpu"], runs["cuda"]
    require(out["cpu_launches"] == 0 and out["cuda_launches"] == 1,
            f"{what}: sim_scan launched once on cuda, never on cpu "
            f"({out['cuda_launches']}, {out['cpu_launches']})")
    out["dur_rel"] = durations_err(durs["cpu"], durs["cuda"], what)
    scale = float(np.abs(a.end_true).max())
    out["scale_s"], out["max_abs"] = scale, 0.0
    for k in ("times_local", "times_global", "barrier_exit_true", "start_true", "end_true"):
        x, y = getattr(a, k), getattr(b, k)
        require(np.array_equal(np.isnan(x), np.isnan(y)), f"{what} {k}: the same NaNs")
        err = float(np.nan_to_num(np.abs(x - y)).max())
        require(err <= 1e-12 * scale, f"{what} {k}: |err| {err:.3e} <= 1e-12 x {scale:.3f} s")
        out["max_abs"] = max(out["max_abs"], err)
    require(float(np.abs(net.t - card[0].t).max()) <= 1e-12 * scale, f"{what}: net.t")
    require(abs(op._ar_state - card[2]._ar_state) <= 1e-12, f"{what}: AR(1) carry")
    require(net.rng.bit_generator.state == card[0].rng.bit_generator.state,
            f"{what}: the generator in the same state")
    out["cpu"], out["cuda"] = a, b
    return out


def phase_barrier(torch, device="cuda", p=512, nrep=10_000, probes=1000) -> tuple[int, int]:
    """The barrier scheme: noise-free card == CPU on affine and walking
    clocks, then Figs. 11-12's settings at full width; then the same under
    ``engine="batch"`` (the reference's draws in its order, scanned by
    ``sim_scan`` on the card), card against CPU. Returns the device
    engine's Figs. 11-12 barrier run's sim_scan launches and those of every
    card call under ``"batch"``."""
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

    # engine="batch": p 16, noise-free then live, affine clocks, synced
    batch_launches = 0
    t = time.perf_counter()
    for label, op_kw16 in (("noise-free", NOISE_FREE), ("live", {})):
        net16 = SimNet(16, seed=5)
        sync16 = make_sync("hca", n_fitpts=100, n_exchanges=20).synchronize(net16)
        what = f"[12 batch] p=16 {label}"
        pair = barrier_pair(torch, net16, sync16, make_op("allreduce", **op_kw16), 4096, 2000,
                            what, barrier_exit_skew=40e-6)
        batch_launches += pair["cuda_launches"]
        print(f"# {what}, nrep 2000, hca 100x20, library barrier at 40 us exit skew: cuda == "
              f"cpu, durations within {pair['dur_rel']:.3e} relative, times and stamps within "
              f"{pair['max_abs']:.3e} s on a {pair['scale_s']:.6f} s timeline; sim_scan "
              f"launches {pair['cuda_launches']}; cpu {pair['cpu_s']:.2f} s, cuda "
              f"{pair['cuda_s']:.2f} s")
    # walking clocks draw between two barriers: the card refuses, before any draw
    walking = SimNet(16, seed=5, clocks=ClockParams(rw_sigma=RW_SIGMA))
    state = walking.rng.bit_generator.state
    try:
        run_barrier_timed(walking, make_op("allreduce"), 4096, 10, device=device,
                          engine="batch")
    except ValueError as e:
        refused = str(e)
    else:
        refused = None
    require(refused is not None and "engine='torch'" in refused and "device='cpu'" in refused
            and walking.rng.bit_generator.state == state,
            "[12 batch] walking clocks on cuda raise ValueError naming engine='torch' and "
            "device='cpu', before any draw")
    print(f"# [12 batch] walking clocks on {device}: ValueError ({refused})")
    # Figs. 11-12's barrier at full width, from the bench's seed
    net_b = SimNet(p, seed=11)
    pair = barrier_pair(torch, net_b, None, make_op("allreduce", **op_kw), 32768, nrep,
                        f"[12 batch] p={p}", barrier_exit_skew=40e-6)
    batch_launches += pair["cuda_launches"]
    batch_mean = float(pair["cuda"].times_local.mean())
    require(np.isfinite(pair["cuda"].times_local).all() and batch_mean > window_mean,
            f"Fig. 11 under engine='batch': barrier local-max mean {batch_mean * 1e6:.3f} us "
            f"> window global mean {window_mean * 1e6:.3f} us")
    print(f"# [12 batch] p={p} nrep {nrep} allreduce@32768 {op_kw}, library barrier at 40 us "
          f"exit skew: cuda == cpu, durations within {pair['dur_rel']:.3e} relative, times and "
          f"stamps within {pair['max_abs']:.3e} s on a {pair['scale_s']:.6f} s timeline; "
          f"local-max mean {batch_mean * 1e6:.3f} us (cpu "
          f"{float(pair['cpu'].times_local.mean()) * 1e6:.3f} us; the device engine's "
          f"{barrier_mean * 1e6:.3f} us) > window global mean {window_mean * 1e6:.3f} us; "
          f"sim_scan launches {pair['cuda_launches']}; cpu {pair['cpu_s']:.2f} s, cuda "
          f"{pair['cuda_s']:.2f} s")
    print(f"# [12 batch] sim_scan launches under engine='batch' {batch_launches}; "
          f"{time.perf_counter() - t:.2f} s")
    return launches, batch_launches

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


# ---------------------------------------------------------------------------
# Phases 18-19: the model zoo's serving path
# ---------------------------------------------------------------------------

GEMMA2 = "gemma2-2b"
#: The std of 19c's cached keys. At std 1 a decode query's softmax spreads
#: over thousands of random rows, attention's output is ~0.1 at most, and
#: the bf16 residual (RMS ~48: unit embeddings times sqrt(2304)) cannot
#: hold a change that small, so a model with no attention at all lands as
#: close to the plain model as the kernel does (19c prints it). At std 4
#: the softmax is peaked, a few keys carry the weight, as in a trained
#: model, and attention moves the residual.
CACHE_KEY_STD = 4.0
#: The bound a bf16 decode step of the kernel model at depth 8192 is held
#: to (max |err| over max |logit|, per step) against the same model with
#: ``impl="ref"`` and with its attention run in f32 on the same bf16
#: values. It is not phase 7's 2e-2, which bounds one attention output:
#: 26 bf16 layers carry each rounding difference to the logits, so the
#: plain path itself lands ~3e-2 from the model with f32 attention. A
#: zero and an unwindowed attention, which 19c runs as controls, must
#: land past it. Every attention call is also held alone at phase 7's
#: check (:func:`bf16_held`).
BF16_DECODE_BOUND = 5e-2
#: 19a's bound on each layer's f32 attention output (max |err| over its
#: max |value|), the per-layer bound of the CPU tests.
F32_LAYER_BOUND = 1e-5
MATMUL = re.compile(r"gemm|gemv|nvjet|cutlass|xmma|s16816|wmma|cublas|splitK", re.I)


def reset_flash_counts():
    from repro_torch.kernels.flash_attention import flash_attention

    flash_attention.launches = 0
    flash_attention.launches_sharded = 0
    for name in flash_attention.launches_by_instance:
        flash_attention.launches_by_instance[name] = 0


def flash_counts() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention

    return dict(flash_attention.launches_by_instance)


def phase_model_smoke(torch) -> dict:
    """Every smoke architecture on the card in f32, weights drawn on the CPU
    and moved: ``forward``, ``prefill`` of 8 tokens and 4 ``decode_step``\\ s,
    card (the ``tf32x3`` flash kernel) against CPU (``attention_reference``)
    at 1e-4 of max |logit|, and prefill against repeated decode at the
    reference's 2e-4. Returns the flash launches of the card runs."""
    import numpy as np

    from repro_torch.configs import ARCHS, get_smoke
    from repro_torch.models import decode_step, forward, init_cache, init_params, prefill
    from repro_torch.models.lm import encode

    def run(cfg, model, toks, front):
        kw = {}
        if cfg.frontend == "vision":
            kw["embeds"] = front
        if cfg.frontend == "audio":
            kw["memory"] = encode(cfg, model, front)
        mem = kw.get("memory")
        with torch.no_grad():
            logits, aux = forward(cfg, model, toks, **kw)
        pre, cache = prefill(cfg, model, toks[:, :8], memory=mem, max_len=16)
        dec = [decode_step(cfg, model, cache, toks[:, 8 + i:9 + i], memory=mem)[0][:, 0]
               for i in range(4)]
        fresh = init_cache(cfg, toks.shape[0], 16, device=toks.device)
        rep = [decode_step(cfg, model, fresh, toks[:, i:i + 1], memory=mem)[0][:, 0]
               for i in range(8)]
        return dict(forward=logits, prefill=pre, decode=torch.stack(dec, 1),
                    repeated=torch.stack(rep, 1))

    t0 = time.perf_counter()
    totals = dict.fromkeys(flash_counts(), 0)
    worst = 0.0
    for i, arch in enumerate(ARCHS):
        t = time.perf_counter()
        cfg = get_smoke(arch)
        cpu = init_params(cfg, device="cpu", seed=18 + i)
        card = copy.deepcopy(cpu).to("cuda")
        rng = np.random.default_rng(18 + i)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
        front = (torch.from_numpy(rng.normal(0, 1, (2, cfg.frontend_tokens, cfg.d_model))
                                  .astype(np.float32)) if cfg.frontend else None)
        before = flash_counts()
        got = run(cfg, card, toks.cuda(), None if front is None else front.cuda())
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in flash_counts().items()}
        want = run(cfg, cpu, toks, front)
        errs = {k: rel_err(got[k].cpu(), want[k]) for k in want}
        for k, e in errs.items():
            require(torch.isfinite(got[k]).all() and e <= 1e-4,
                    f"[18] {arch} {k}: card == CPU, {e:.3e} <= 1e-4 of max |logit|")
        require(torch.allclose(got["prefill"], got["repeated"], rtol=2e-4, atol=2e-4),
                f"[18] {arch}: prefill == repeated decode at 2e-4")
        if cfg.family != "ssm":
            require(launched["tf32x3"] > 0, f"[18] {arch}: attention ran the tf32x3 kernel")
        require(launched["wgmma_bf16"] == launched["simt"] == 0, f"[18] {arch}: f32 only")
        for k in totals:
            totals[k] += launched[k]
        worst = max(worst, *errs.values())
        print(f"# [18 models] {arch}: card == CPU (forward {errs['forward']:.2e}, prefill "
              f"{errs['prefill']:.2e}, decode {errs['decode']:.2e}, repeated "
              f"{errs['repeated']:.2e} of max |logit|); flash launches "
              f"{launched}; {time.perf_counter() - t:.2f} s")
    print(f"# [18 models] all {len(ARCHS)} smoke architectures card == CPU within 1e-4 "
          f"(worst {worst:.2e}), prefill == repeated decode within 2e-4; flash launches "
          f"{totals}; {time.perf_counter() - t0:.2f} s")
    return totals


def visible(cfg, pos) -> list[int]:
    """Keys each layer's decode query at ``pos`` sees (window on local
    layers)."""
    return [pos + 1 if cfg.is_global_layer(i) else min(pos + 1, cfg.window)
            for i in range(cfg.n_layers)]


def random_cache(torch, cfg, batch, max_len, pos, seed, key_std=1.0):
    """A decode cache at ``pos`` whose K/V rows below ``pos`` are seeded
    normals: values at std 1, keys at ``key_std``."""
    from repro_torch.models import init_cache

    cache = init_cache(cfg, batch, max_len)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    seg = cache["segments"][0]
    seg["k"][:, :, :pos].normal_(std=key_std, generator=gen)
    seg["v"][:, :, :pos].normal_(generator=gen)
    cache["pos"] = pos
    return cache


def bf16_held(out, ref32) -> tuple[float, float, bool]:
    """Phase 7's bf16 check of an attention output against the plain
    version run in f32 on the same bf16 values: every element within 2e-2
    (absolute and relative) and the RMS error within 1e-2 of the RMS of
    the plain output. Returns (max |err|, RMS err / RMS, held)."""
    import torch

    out = out.float()
    rms = (out - ref32).pow(2).mean().sqrt().item()
    scale = ref32.pow(2).mean().sqrt().item()
    held = bool(torch.allclose(out, ref32, rtol=2e-2, atol=2e-2)) and rms <= 1e-2 * scale
    return (out - ref32).abs().max().item(), rms / max(scale, 1e-30), held


@contextlib.contextmanager
def attention_as(variant, records=None):
    """Runs the model's attention calls (``repro_torch.models.attention.
    attention_op``) as ``variant`` inside the block: ``"f32"`` the plain
    version in f32 on the same values; ``"kernel"`` the flash kernel,
    ``"zero"`` zeros, ``"no window"`` the kernel without the layer's
    window, each of these three held at :func:`bf16_held` against the
    plain version in f32, ``(window, max |err|, RMS ratio, held)``
    appended to ``records``."""
    from repro_torch.models import attention

    kernel_op = attention.attention_op

    def op(q, k, v, *, impl="auto", **kw):
        ref32 = attention.attention_reference(q.float(), k.float(), v.float(), **kw)
        if variant == "f32":
            return ref32.to(q.dtype)
        if variant == "zero":
            out = ref32.new_zeros(q.shape, dtype=q.dtype)
        else:
            window = None if variant == "no window" else kw["window"]
            out = kernel_op(q, k, v, impl="cuda", **{**kw, "window": window})
        records.append((kw["window"], *bf16_held(out, ref32)))
        return out

    attention.attention_op = op
    try:
        yield
    finally:
        attention.attention_op = kernel_op


def profile_decode(torch, cfg, model, cache, toks, reps=5) -> dict:
    """:func:`trace` over ``reps`` decode steps (after one warm-up): device
    ms per step in flash, matmuls and the rest, the idle share of the
    steps' span, flash ms per call, and the host ops with the most self
    CPU time per step."""
    from repro_torch.models import decode_step

    columns, host = iter(range(reps + 1)), {}

    def step():
        i = next(columns)
        decode_step(cfg, model, cache, toks[:, i:i + 1])

    per_kernel, busy = trace(torch, step, reps=reps, host=host)
    split = dict(flash=0.0, matmul=0.0, rest=0.0)
    for name, ms in per_kernel.items():
        key = "flash" if "flash" in name else "matmul" if MATMUL.search(name) else "rest"
        split[key] += ms
    top = sorted(host.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(split=split, idle=1.0 - busy, flash_call=split["flash"] / cfg.n_layers,
                per_kernel=per_kernel, span=sum(split.values()) / busy if busy else 0.0,
                host=top)


def time_prefill_calls(torch, cfg, seed) -> dict:
    """One f32 flash call of 19a's prefill (B 1, S = T = 8192, gemma2-2b's
    heads, soft-cap 50) timed alone, on a local (window 4096) and a global
    layer, beside its bound, the plain version and, on the global layer,
    SDPA on the same tensors (causal, no soft-cap: SDPA has none; timed
    only). Inputs are seeded normals: the time does not depend on them."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    s, h, hkv, d = 8192, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    q, k, v = (torch.randn(1, s, n, d, generator=gen, device="cuda") for n in (h, hkv, hkv))
    rows = {}
    for name, window in (("local", cfg.window), ("global", None)):
        kw = dict(window=window, logit_cap=cfg.attn_softcap)
        ms = cuda_ms(lambda: flash_attention(q, k, v, **kw), 10)
        plain = cuda_ms(lambda: flash_attention_ref(q, k, v, **kw), 2)
        b_ms, by, _, _ = attn_bound_ms(1, s, s, h, hkv, d, 4, TF32_FLOPS / 3, window=window)
        rows[name] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=by)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    rows["global"]["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 10)
    print("# [19a f32 flash call, B 1, S = T = 8192] " + "; ".join(
        f"{name}: kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
        f"plain {r['plain_ms']:.4f} ms" for name, r in rows.items())
        + f"; sdpa f32 on the global layer's tensors {rows['global']['library_ms']:.4f} ms")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


def phase_gemma2_full(torch) -> dict:
    """gemma2-2b at full width (26 layers, d 2304, 8/4 heads, D 256, d_ff
    9216, vocab 256000, window 4096 on alternating layers, soft-caps
    50/30), weights from a seeded generator on the card. Returns the flash
    launches of (a) and (b)."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.launch import make_decode_step, make_prefill_step
    from repro_torch.models import init_params, num_params
    from repro_torch.models.attention import attn_block

    out = {}
    cfg = get_config(GEMMA2)
    rng = np.random.default_rng(19)

    # (a) f32 prefill step, B 1, S 8192: the local layers mask past 4096
    t0 = time.perf_counter()
    cfg32 = cfg.scaled(dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg32, seed=19)
    n = num_params(model)
    require(n == cfg.param_count() + (2 * cfg.n_layers + 1) * cfg.d_model,
            f"[19a] {n} parameters: the analytic count plus the norm gains")
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 8192))).cuda()}
    layer_errs = []

    def check_layer(module, args, kwargs, output):
        ref = attn_block(cfg32, module, args[0], is_global=kwargs["is_global"], impl="ref")
        layer_errs.append(rel_err(output, ref))

    hooks = [blk.attn.register_forward_hook(check_layer, with_kwargs=True)
             for blk in model.segments[0]]
    make_prefill_step(cfg32)(model, batch)
    for h in hooks:
        h.remove()
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = make_prefill_step(cfg32, impl="ref")(model, batch)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t
    reset_flash_counts()
    t = time.perf_counter()
    got = make_prefill_step(cfg32)(model, batch)
    torch.cuda.synchronize()
    kern_s = time.perf_counter() - t
    out["a"] = flash_counts()
    err = rel_err(got, want)
    print(f"# [19a gemma2-2b f32] {n / 1e9:.3f} B parameters ({n * 4 / 1e9:.1f} GB); prefill "
          f"step B 1 S 8192: kernel == plain at {err:.3e} of max |logit| "
          f"{want.abs().max().item():.3f} (bound 1e-4); worst layer's attention output "
          f"{max(layer_errs):.3e} of its max (bound {F32_LAYER_BOUND}; layer {int(np.argmax(layer_errs))}; global "
          f"{max(layer_errs[1::2]):.3e}, local {max(layer_errs[0::2]):.3e}); wall kernel "
          f"{kern_s:.3f} s, plain {ref_s:.3f} s; flash launches {out['a']}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"{time.perf_counter() - t0:.2f} s")
    require(got.shape == (1, 8192, cfg.vocab_size) and bool(torch.isfinite(got).all()),
            "[19a] logits finite, (1, 8192, 256000)")
    require(err <= 1e-4, f"[19a] kernel == plain on the logits, {err:.3e} <= 1e-4 of max |logit|")
    require(out["a"]["tf32x3"] == cfg.n_layers, "[19a] one tf32x3 launch per layer")
    require(len(layer_errs) == cfg.n_layers and max(layer_errs) <= F32_LAYER_BOUND,
            f"[19a] every layer's attention output == plain, worst {max(layer_errs):.3e} "
            f"<= {F32_LAYER_BOUND} of its max")
    del model, got, want, batch
    torch.cuda.empty_cache()
    out["f32_calls"] = time_prefill_calls(torch, cfg, seed=23)

    # (b) bf16: the serving run of examples/serve_lm_torch.py
    t0 = time.perf_counter()
    model = init_params(cfg, seed=20)
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    example = load_example("serve_lm_torch")
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()
    r = example.serve(cfg, model, batch=4, prompt_len=128, tokens=32, seed=20)
    out["b"] = flash_counts()
    require(r["out"].shape == (4, 33) and bool(torch.isfinite(r["logits"].float()).all()),
            "[19b] 33 ids per request, finite logits")
    require(out["b"]["wgmma_bf16"] == cfg.n_layers * (128 + 32) and out["b"]["tf32x3"] == 0,
            "[19b] every attention call through wgmma_bf16")
    step_bound = (wbytes + 4 * sum(visible(cfg, 160)) * 4 * 256 * 2 * 2) / HBM_BYTES_PER_S * 1e3
    print(f"# [19b gemma2-2b bf16 serve] batch 4, prompt 128 (prefill = 128 decode steps), "
          f"32 greedy steps: prefill {r['prefill_s']:.3f} s, {r['prefill_tok_s']:.1f} tok/s; "
          f"decode step (Tukey-filtered, {len(r['kept'])} of {len(r['latencies'])}) "
          f"{r['mean'] * 1e3:.3f} ms [{r['lo'] * 1e3:.3f}, {r['hi'] * 1e3:.3f}] 95% CI, "
          f"{r['decode_tok_s']:.1f} tok/s; bound {step_bound:.3f} ms a step "
          f"(weights {wbytes / 1e9:.2f} GB + cache at 3.35 TB/s); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; flash launches {out['b']}; "
          f"sample ids {r['out'][0, :8].tolist()}; {time.perf_counter() - t0:.2f} s")
    del r

    # (c) bf16 decode at depth 8192: batch 8, a seeded cache, pos 8190
    t0 = time.perf_counter()
    b, pos, steps = 8, 8190, 8
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, steps + 6))).cuda()

    def decode_logits(cache, variant, records=None):
        """``steps`` decode steps on a copy of ``cache``: the stacked
        logits and the copy. ``"plain"`` is ``impl="ref"``; any other
        variant runs through :func:`attention_as`."""
        c = copy.deepcopy(cache)
        fn = make_decode_step(cfg, impl="ref" if variant == "plain" else "auto")
        with contextlib.nullcontext() if variant == "plain" else attention_as(variant, records):
            logits = [fn(model, c, {"tokens": toks[:, i:i + 1]})[0].float()
                      for i in range(steps)]
        return torch.stack(logits), c

    def step_errs(got, want):
        return [rel_err(g, w) if bool(torch.isfinite(g).all()) else float("inf")
                for g, w in zip(got, want)]

    # at key std 1 attention cannot move the residual: printed, not held
    cache = random_cache(torch, cfg, b, pos + steps + 6, pos, seed=21)
    blind = max(step_errs(decode_logits(cache, "zero", [])[0], decode_logits(cache, "f32")[0]))
    base = random_cache(torch, cfg, b, pos + steps + 6, pos, seed=21, key_std=CACHE_KEY_STD)
    f32, _ = decode_logits(base, "f32")
    plain, _ = decode_logits(base, "plain")
    records = {v: [] for v in ("kernel", "zero", "no window")}
    got, cache = decode_logits(base, "kernel", records["kernel"])
    errs, errs32 = step_errs(got, plain), step_errs(got, f32)
    agree = (got.argmax(-1) == plain.argmax(-1)).float().mean().item()
    controls = {v: max(step_errs(decode_logits(base, v, records[v])[0], f32))
                for v in ("zero", "no window")}
    local = [r for r in records["kernel"] if r[0] == cfg.window]
    glob = [r for r in records["kernel"] if r[0] != cfg.window]
    keys = visible(cfg, pos)
    moved = wbytes + b * sum(keys) * 4 * 256 * 2 * 2
    full = cfg.n_layers * 2 * b * 8192 * 4 * 256 * 2
    print(f"# [19c gemma2-2b bf16 decode at depth 8192] batch 8, pos 8190-8197, {steps} "
          f"steps, cached keys at std {CACHE_KEY_STD}: every attention call "
          f"({len(records['kernel'])}) == plain in f32 at phase 7's bf16 check (worst max "
          f"|err| local {max(r[1] for r in local):.3e}, global {max(r[1] for r in glob):.3e}; "
          f"RMS err / RMS local {max(r[2] for r in local):.3e}, global "
          f"{max(r[2] for r in glob):.3e}, bound 1e-2); logits: kernel == plain within "
          f"{max(errs):.3e}, == f32 attention within {max(errs32):.3e}, plain == f32 "
          f"attention within {max(step_errs(plain, f32)):.3e} of max |logit| (bound "
          f"{BF16_DECODE_BOUND}; kernel == plain per step "
          f"{', '.join(f'{e:.2e}' for e in errs)}); top-1 agreement {agree:.4f}; controls "
          f"against f32 attention: zero {controls['zero']:.3e}, no window "
          f"{controls['no window']:.3e} (at key std 1 zero attention lands within "
          f"{blind:.3e}); step bound {moved / HBM_BYTES_PER_S * 1e3:.3f} ms "
          f"({moved / 1e9:.2f} GB: weights {wbytes / 1e9:.2f} + visible cache "
          f"{(moved - wbytes) / 1e9:.2f}; the whole 8192-deep cache would be "
          f"{full / 1e9:.2f} GB); {time.perf_counter() - t0:.2f} s")
    require(all(r[3] for r in records["kernel"]),
            "[19c] every attention call == plain in f32 at phase 7's bf16 check")
    require(not any(r[3] for r in records["zero"]),
            "[19c] control: zero attention fails the per-call check on every layer")
    require(not any(r[3] for r in records["no window"] if r[0] == cfg.window),
            "[19c] control: attention without the window fails the per-call check on "
            "every local layer")
    require(max(errs) <= BF16_DECODE_BOUND and max(errs32) <= BF16_DECODE_BOUND,
            f"[19c] kernel == plain ({max(errs):.3e}) and == f32 attention "
            f"({max(errs32):.3e}) within {BF16_DECODE_BOUND} of max |logit|")
    require(min(controls.values()) > BF16_DECODE_BOUND,
            f"[19c] controls: zero and unwindowed attention land past {BF16_DECODE_BOUND}")
    require(agree >= 0.9, f"[19c] greedy tokens agree on >= 90% ({agree:.4f})")
    del f32, plain, got, base

    # (d) the profiler over 5 decode steps of (b)'s shape and 5 of (c)'s
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    shapes = (("b: batch 4, depth 160", 4, 160), ("c: batch 8, depth 8196", 8, pos + steps - 2))
    for label, bb, depth in shapes:
        c = cache if bb == b else random_cache(torch, cfg, bb, depth + 8, depth, seed=22)
        c["pos"] = depth
        prof = profile_decode(torch, cfg, model, c, toks[:bb])
        keys = visible(cfg, depth + 1)
        bounds = [attn_bound_ms(bb, 1, kk, 8, 4, 256, 2, BF16_FLOPS, causal=False)[0]
                  for kk in keys]
        # one local and one global layer's decode call on the cache, held at
        # phase 7's bf16 check at (c)'s depth; the global one timed alone:
        # the kernel, and SDPA on the same tensors (a boolean mask for
        # kv_len, no soft-cap: SDPA has none; timed only, never used)
        q = torch.randn(bb, 1, 8, 256, generator=gen, device="cuda").to(torch.bfloat16)

        def layer_call(layer):
            kw = dict(causal=False, logit_cap=cfg.attn_softcap, q_offset=depth,
                      kv_len=depth + 1,
                      window=2**30 if cfg.is_global_layer(layer) else cfg.window)
            return c["segments"][0]["k"][layer], c["segments"][0]["v"][layer], kw

        held = {}
        for layer in (0, 1):
            k_layer, v_layer, kw = layer_call(layer)
            ref32 = flash_attention_ref(q.float(), k_layer.float(), v_layer.float(), **kw)
            held[layer] = bf16_held(flash_attention(q, k_layer, v_layer, **kw), ref32)
            del ref32
        require(held[0][2] and held[1][2], f"[19d] flash == plain in f32 at depth {depth}, "
                "local and global layer, at phase 7's bf16 check")
        k_layer, v_layer, kw = layer_call(1)
        # the calls are queued behind ~0.5 ms of spin each: a call this
        # short takes less device than host time (up to ~0.12 ms a flash
        # call), and unqueued events would time the host
        host = []
        flash_ms = cuda_ms(lambda: flash_attention(q, k_layer, v_layer, **kw), 50,
                           queued=True, spin=1e6, host=host)
        mask = (torch.arange(k_layer.shape[1], device="cuda") <= depth)[None, None, None, :]
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k_layer.transpose(1, 2), v_layer.transpose(1, 2),
            attn_mask=mask, enable_gqa=True), 20, queued=True, spin=1e6)
        plain_ms = cuda_ms(lambda: flash_attention_ref(q, k_layer, v_layer, **kw), 20,
                           queued=True, spin=1e6)
        one_bound = attn_bound_ms(bb, 1, depth + 1, 8, 4, 256, 2, BF16_FLOPS, causal=False)[0]
        s = prof["split"]
        total = sum(s.values())
        print(f"# [19d profile {label}] device ms per step: flash {s['flash']:.4f}, matmuls "
              f"{s['matmul']:.4f}, rest {s['rest']:.4f} (total {total:.4f}) in a "
              f"{prof['span']:.4f} ms span under the profiler; idle share {prof['idle']:.3f}; "
              f"flash {prof['flash_call']:.4f} ms a call against a mean bound of "
              f"{np.mean(bounds):.4f} ms (bytes, {min(keys)}-{max(keys)} visible keys)")
        print(f"# [19d layers {label}] flash == plain in f32: local max |err| "
              f"{held[0][0]:.3e}, RMS err / RMS {held[0][1]:.3e}; global {held[1][0]:.3e}, "
              f"{held[1][1]:.3e} (phase 7's bf16 check, held)")
        print(f"# [19d global layer {label}] ms per call, queued: flash {flash_ms:.4f} (bound "
              f"{one_bound:.4f} ms, "
              f"bytes, {depth + 1} keys; host {host[0]:.1f} us a call), plain {plain_ms:.4f} "
              f"ms, sdpa on the same tensors {sdpa_ms:.4f} ms")
        print(f"# [19d host {label}] self CPU ms per step (calls): " + "; ".join(
            f"{k} {ms:.3f} ({n})" for k, (ms, n) in prof["host"]))
        print(f"# [19d trace {label}] " + trace_line(prof["per_kernel"], 1.0 - prof["idle"]))
        out[f"profile_{label[0]}"] = dict(flash_call=prof["flash_call"], flash=flash_ms,
                                          bound=one_bound, sdpa=sdpa_ms, plain=plain_ms,
                                          host_us=host[0])
    print(f"# [19d] {time.perf_counter() - t0:.2f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 20: the training path
# ---------------------------------------------------------------------------

#: The train step's optimizer in 20(a), as in ``tests/test_torch_train.py``:
#: a learning rate that moves every weight visibly, and ``eps`` well above
#: the gradients' rounding noise, so the first steps' ``g / (|g| + eps)``
#: is no sign test where a gradient is ~0 (there card and CPU may round a
#: near-zero gradient to opposite signs).
SMOKE_TRAIN_OPT = dict(lr=1e-2, warmup_steps=1, weight_decay=0.1, eps=1e-2)
#: 20(c)'s learning rate, with one warmup step. At the 3e-3 of the
#: reference's loss-decrease test (tests/test_models.py::
#: test_train_step_reduces_loss, a smoke model) gemma2-2b's loss on one
#: batch of 8192 tokens fell 3.4% over the 8 timed steps, short of that
#: test's 10%: past the first two steps it must memorise the batch.
GEMMA2_TRAIN_LR = 1e-2


@contextlib.contextmanager
def no_tf32(torch):
    """TF32 off for matmuls and convolutions, f32 matmuls at "highest"."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def leaf_errs(got: dict, want: dict) -> dict:
    """:func:`rel_err` per tensor, ``got``'s moved to ``want``'s device."""
    return {name: rel_err(got[name].detach().to(w.device), w.detach())
            for name, w in want.items()}


def phase_train_smoke(torch) -> dict:
    """20(a): every smoke architecture's train step (``impl="ref"``, remat
    on) on the card and the CPU from the same weights, two steps on the
    same batches, TF32 off: the loss and the gradient norm of each step,
    and every updated weight, within 1e-4 of max |CPU| (phase 18's bound).
    Returns the flash launches of the card's steps."""
    import numpy as np

    from repro_torch.configs import ARCHS, get_smoke
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import init_train_state, make_train_step
    from repro_torch.models import init_params
    from repro_torch.models.lm import encode
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime.trainer import to_device

    t0 = time.perf_counter()
    worst_all, launched = 0.0, 0
    with no_tf32(torch):
        for i, arch in enumerate(ARCHS):
            t = time.perf_counter()
            cfg = get_smoke(arch)
            cpu = init_train_state(init_params(cfg, device="cpu", seed=30 + i))
            card = init_train_state(copy.deepcopy(cpu["params"]).to("cuda"))
            step = make_train_step(cfg, OptimizerConfig(**SMOKE_TRAIN_OPT))
            data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                          global_batch=2, seed=30 + i))
            front = None
            if cfg.frontend:
                rng = np.random.default_rng(30 + i)
                front = torch.from_numpy(rng.normal(0, 1, (2, cfg.frontend_tokens, cfg.d_model))
                                         .astype(np.float32))
            metrics = {}
            for k in range(2):
                for name, state in (("cpu", cpu), ("card", card)):
                    dev = state["params"].embed.device
                    batch = to_device(data.batch_at(k), dev)
                    if cfg.frontend == "vision":
                        batch["embeds"] = front.to(dev)
                    if cfg.frontend == "audio":     # an input, as in the reference
                        with torch.no_grad():
                            batch["memory"] = encode(cfg, state["params"], front.to(dev))
                    before = sum(flash_counts().values())
                    _, m = step(state, batch)
                    launched += sum(flash_counts().values()) - before
                    metrics[name, k] = {key: m[key].item() for key in ("loss", "grad_norm")}
            scalar = max(abs(metrics["card", k][key] - metrics["cpu", k][key])
                         / abs(metrics["cpu", k][key]) for k in range(2)
                         for key in ("loss", "grad_norm"))
            errs = leaf_errs(dict(card["params"].named_parameters()),
                             dict(cpu["params"].named_parameters()))
            name, worst = max(errs.items(), key=lambda kv: kv[1])
            require(all(np.isfinite(v) for m in metrics.values() for v in m.values()),
                    f"[20a] {arch}: finite loss and gradient norm")
            require(scalar <= 1e-4, f"[20a] {arch}: loss and grad norm card == CPU, "
                    f"{scalar:.3e} <= 1e-4")
            require(worst <= 1e-4, f"[20a] {arch}: every updated weight card == CPU, worst "
                    f"{name} {worst:.3e} <= 1e-4 of its max")
            worst_all = max(worst_all, worst, scalar)
            print(f"# [20a train smoke] {arch}: 2 steps card == CPU, loss "
                  f"{metrics['cpu', 0]['loss']:.4f} -> {metrics['cpu', 1]['loss']:.4f}, loss and "
                  f"grad norm within {scalar:.2e}, worst weight {name} {worst:.2e} of its max "
                  f"({len(errs)} tensors); {time.perf_counter() - t:.2f} s")
    require(launched == 0, "[20a] the train steps launched no flash kernel (impl='ref')")
    print(f"# [20a] all {len(ARCHS)} smoke train steps card == CPU within 1e-4 (worst "
          f"{worst_all:.2e}); flash launches {launched}; {time.perf_counter() - t0:.2f} s")
    return dict(worst=worst_all, launches=launched)


def load_example(name):
    """``examples/<name>.py`` as a module, its ``__main__`` block not run."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_trainer(torch) -> dict:
    """20(b): ``examples/train_lm_torch.py``'s ``small`` preset on the card
    (~5 M parameters, batch 8, 128 tokens), a clean run and one with a
    failure injected at step 45 (restart from the step-40 checkpoint),
    each with async checkpoints in a temporary directory: one restart and
    final losses within 1e-4 (the bound of tests/test_runtime.py); then
    ``examples/compressed_dp_torch.py`` (a wire reduction above 3x and a
    falling loss, which it checks itself)."""
    import tempfile

    import numpy as np

    t0 = time.perf_counter()
    train = load_example("train_lm_torch")
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--preset", "small", "--steps", "60", "--device", "cuda"]
        clean = train.main(common + ["--ckpt-dir", f"{tmp}/clean"])
        faulty = train.main(common + ["--ckpt-dir", f"{tmp}/faulty", "--fail-at", "45"])
    diff = abs(clean["losses"][-1] - faulty["losses"][-1])
    require(clean["restarts"] == 0 and faulty["restarts"] == 1,
            f"[20b] restarts {clean['restarts']}, {faulty['restarts']}: want 0, 1")
    require(diff <= 1e-4, f"[20b] final loss after the restart == clean run's, |diff| "
            f"{diff:.3e} <= 1e-4")
    times = np.array(clean["step_times"][5:])
    print(f"# [20b trainer] small preset, 60 steps: loss {clean['losses'][0]:.4f} -> "
          f"{clean['losses'][-1]:.4f}; failure at 45: restarts {faulty['restarts']}, final loss "
          f"{faulty['losses'][-1]:.6f} vs clean {clean['losses'][-1]:.6f} (|diff| {diff:.3e}); "
          f"step {np.median(times) * 1e3:.2f} ms median (host clock, fenced); stragglers "
          f"{clean['stragglers']}; {time.perf_counter() - t0:.2f} s")
    t = time.perf_counter()
    dp = load_example("compressed_dp_torch").main(["--device", "cuda"])
    print(f"# [20b compressed dp] two pods in one process: {dp['reduction']:.2f}x wire "
          f"reduction, loss {dp['comp_losses'][0]:.4f} -> {dp['comp_losses'][-1]:.4f} "
          f"(fp32 {dp['base_losses'][-1]:.4f}), Wilcoxon p {dp['p_value']:.3f}; "
          f"{time.perf_counter() - t:.2f} s")
    return dict(diff=diff, reduction=dp["reduction"])


def train_bound(cfg, b, s, n_params) -> tuple[float, str, float, float]:
    """The least time for one remat train step (``ce_chunk`` checkpointed
    too) of ``cfg`` at batch ``b``, length ``s``: ``(bound_ms, bound_by,
    flops, bytes)``. Operations: the matmuls of the weights, 2 per weight
    and token forward, 4 backward, 2 more for the recompute (blocks and
    head), and attention's two products over the (q, k) pairs the causal
    mask and each layer's window leave, times 4 the same way; bytes: the
    optimizer's read of weights, gradients and both f32 moments and its
    write of weights and moments."""
    matmul = 8.0 * b * s * n_params     # the tied embedding counted as the unembedding
    attn = 0.0
    for i in range(cfg.n_layers):
        window = None if cfg.is_global_layer(i) else cfg.window
        pairs = sum(min(q + 1, window or s) for q in range(s))
        attn += 4.0 * b * cfg.n_heads * cfg.hd * pairs * 4.0
    flops = matmul + attn
    nbytes = n_params * (2 + 2 + 4 + 4 + 2 + 4 + 4)
    return (*bound(flops, BF16_FLOPS, nbytes), flops, nbytes)


def profile_train(torch, step, state, batch, reps=2) -> dict:
    """``torch.profiler`` over ``reps`` train steps (after the caller's
    warm-up): device busy and idle share of the steps' CUDA-event span,
    and device ms per step by class: matmuls (by kernel name), the plain
    attention's other operations (the ops on its 5-d (B, Hkv, G, S, T)
    logits, forward, recompute and backward, by input shape), the
    optimizer (the kernels under ``adamw_update``) and the rest."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.launch import steps as steps_module

    adamw = steps_module.adamw_update

    def traced_adamw(*args, **kw):
        with record_function("adamw_update"):
            return adamw(*args, **kw)

    s = batch["tokens"].shape[1]
    steps_module.adamw_update = traced_adamw
    try:
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            start.record()
            for _ in range(reps):
                step(state, batch)
            end.record()
            torch.cuda.synchronize()
    finally:
        steps_module.adamw_update = adamw
    span = start.elapsed_time(end)

    def dev(e, attr):
        return getattr(e, attr.replace("cuda", "device"), None) or getattr(e, attr, 0.0)

    total = matmul = 0.0
    for e in prof.key_averages():
        # the range's own span on the device timeline is not a kernel
        if e.device_type == torch.autograd.DeviceType.CUDA and e.key != "adamw_update":
            us = dev(e, "self_cuda_time_total")
            total += us
            if MATMUL.search(e.key):
                matmul += us
    attn = opt = 0.0
    for e in prof.key_averages(group_by_input_shape=True):
        if e.device_type == torch.autograd.DeviceType.CUDA:
            continue
        if e.key == "adamw_update":
            opt += dev(e, "cuda_time_total")
        elif not MATMUL.search(e.key) and e.key not in ("aten::bmm", "aten::mm", "aten::einsum") \
                and any(len(sh) == 5 and sh[-1] == s for sh in (e.input_shapes or [])):
            attn += dev(e, "self_cuda_time_total")
    per = 1e-3 / reps
    split = dict(matmul=matmul * per, attention_other=attn * per, optimizer=opt * per)
    split["rest"] = total * per - sum(split.values())
    busy = total * 1e-3 / span if span else 0.0
    return dict(split=split, busy=busy, idle=1.0 - busy, span_ms=span / reps,
                device_ms=total * per)


def phase_gemma2_train(torch) -> dict:
    """20(c)-(d): gemma2-2b at full width (weights from a seeded generator
    on the card). (d) f32, B 1, S 1024: the gradient with ``remat=True``
    and ``remat=False`` on the same weights, every weight's within 1e-5 of
    its max. (c) bf16, B 1, S 8192 (past the 4096 window), remat on,
    ``ce_chunk`` 8, one fixed ``SyntheticLM`` batch, AdamW at
    ``GEMMA2_TRAIN_LR`` with one warmup step and weight decay 0.1: 2
    warm-up and 8 timed steps, loss and gradient norm finite at every step
    and the loss down by at least 10% over the timed steps (the
    reference's criterion), the gradient guard raising for ``impl="auto"``,
    the Tukey-filtered step time with its CI, tokens/s, peak memory, the
    step's bound, a profile of 2 steps; then serving on the trained,
    trainable weights (``make_prefill_step`` through the flash kernel)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.stats import mean_confidence_interval, tukey_filter
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import init_train_state, make_prefill_step, make_train_step
    from repro_torch.models import init_params, loss_fn, num_params
    from repro_torch.models import tuning
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime.trainer import to_device

    cfg = get_config(GEMMA2)
    out = {}

    # (d) remat == no remat, f32, B 1, S 1024
    t0 = time.perf_counter()
    cfg32 = cfg.scaled(dtype="float32")
    model = init_params(cfg32, device="cuda", seed=24).requires_grad_(True)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=1024, global_batch=1,
                                  seed=24))
    batch = to_device(data.batch_at(0), "cuda")
    grads, losses = {}, {}
    with no_tf32(torch):
        for remat in (True, False):
            loss, _ = loss_fn(cfg32, model, batch, remat=remat, impl="ref")
            loss.backward()
            losses[remat] = loss.item()
            del loss, _     # the graph's leaf nodes hold the weights
            grads[remat] = {n: p.grad for n, p in model.named_parameters()}
            model.zero_grad(set_to_none=True)     # the dict keeps the tensors
    errs = leaf_errs(grads[True], grads[False])
    name, worst = max(errs.items(), key=lambda kv: kv[1])
    require(all(torch.isfinite(g).all() for g in grads[True].values()),
            "[20d] finite gradients")
    require(worst <= 1e-5 and abs(losses[True] - losses[False]) <= 1e-5 * abs(losses[False]),
            f"[20d] remat == no remat: worst weight {name} {worst:.3e} <= 1e-5 of its max, "
            f"loss {losses[True]:.6f} vs {losses[False]:.6f}")
    print(f"# [20d gemma2-2b f32 remat] B 1 S 1024: loss {losses[True]:.6f} (no remat "
          f"{losses[False]:.6f}); gradient with remat == without within {worst:.3e} of each "
          f"weight's max (worst {name}, {len(errs)} tensors, bound 1e-5); "
          f"{time.perf_counter() - t0:.2f} s")
    out["d"] = dict(worst=worst)
    del model, grads, batch
    torch.cuda.empty_cache()

    # (c) bf16, B 1, S 8192
    t0 = time.perf_counter()
    s = 8192
    model = init_params(cfg, device="cuda", seed=25)
    n = num_params(model)
    state = init_train_state(model)
    batch = to_device(SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                             global_batch=1, seed=25)).batch_at(0), "cuda")
    tuning.set_tuning(ce_chunk=8)
    try:
        try:
            loss_fn(cfg, model, batch, impl="auto")
        except RuntimeError as e:
            refused = "no backward pass" in str(e)
        else:
            refused = False
        require(refused, "[20c] the flash kernel refuses a gradient (impl='auto', trainable "
                "weights)")
        step = make_train_step(cfg, OptimizerConfig(lr=GEMMA2_TRAIN_LR, warmup_steps=1,
                                                    weight_decay=0.1))
        reset_flash_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, norms, times = [], [], []
        for i in range(10):
            t = time.perf_counter()
            state, m = step(state, batch)
            losses.append(m["loss"].item())            # fences the step
            times.append(time.perf_counter() - t)
            norms.append(m["grad_norm"].item())
        peak = torch.cuda.max_memory_allocated()
        launched = sum(flash_counts().values())
        prof = profile_train(torch, step, state, batch)
    finally:
        tuning.reset_tuning()
    timed = np.array(times[2:])
    kept = tukey_filter(timed)
    mean, lo, hi = mean_confidence_interval(kept)
    bound_ms, bound_by, flops, nbytes = train_bound(cfg, 1, s, n)
    sp = prof["split"]
    print(f"# [20c gemma2-2b bf16 train] {n / 1e9:.3f} B parameters, B 1 S {s}, remat, "
          f"ce_chunk 8, lr {GEMMA2_TRAIN_LR}: losses " + ", ".join(f"{x:.4f}" for x in losses)
          + "; grad norms " + ", ".join(f"{x:.3g}" for x in norms))
    print(f"# [20c step] 8 timed steps (host clock, fenced by the loss): "
          + ", ".join(f"{x:.4f}" for x in timed) + f" s; Tukey-filtered ({len(kept)} of 8) "
          f"{mean:.4f} s [{lo:.4f}, {hi:.4f}] 95% CI, {s / mean:.1f} tokens/s; bound "
          f"{bound_ms / 1e3:.4f} s by {bound_by} ({flops / 1e12:.1f} TFLOP at 989 TFLOP/s, "
          f"{nbytes / 1e9:.1f} GB of optimizer traffic); peak "
          f"{peak / 2**30:.2f} GiB; {time.perf_counter() - t0:.2f} s")
    # the profiler records every op's shapes, which slows the host: the
    # device time against the unprofiled step's wall is the step's own idle
    # share
    idle = 1.0 - prof["device_ms"] / (mean * 1e3)
    print(f"# [20c profile, 2 steps] device {prof['device_ms']:.1f} ms a step in a "
          f"{prof['span_ms']:.1f} ms span under the profiler: busy {prof['busy']:.3f}, idle "
          f"{prof['idle']:.3f}; against the unprofiled step's {mean * 1e3:.1f} ms, idle "
          f"{idle:.3f}; matmuls {sp['matmul']:.1f} ms, attention's other ops "
          f"{sp['attention_other']:.1f} ms, optimizer {sp['optimizer']:.1f} ms, rest "
          f"{sp['rest']:.1f} ms")
    require(all(np.isfinite(losses + norms)), f"[20c] finite losses {losses} and norms {norms}")
    require(losses[-1] <= 0.9 * losses[2], f"[20c] loss down >= 10% over the 8 timed steps: "
            f"{losses[2]:.4f} -> {losses[-1]:.4f}")
    require(launched == 0, "[20c] the train steps launched no flash kernel (impl='ref')")
    out["c"] = dict(mean=mean, lo=lo, hi=hi, peak=peak, bound_ms=bound_ms, idle=idle,
                    launches=launched)

    # serving on the trained weights, which now require grad
    reset_flash_counts()
    logits = make_prefill_step(cfg)(model, {"tokens": batch["tokens"][:, :512]})
    torch.cuda.synchronize()
    require(bool(torch.isfinite(logits.float()).all())
            and flash_counts()["wgmma_bf16"] == cfg.n_layers,
            "[20c] a prefill step on the trainable weights runs the flash kernel under no_grad")
    print(f"# [20c serve] prefill step of 512 tokens on the trained weights (requires_grad): "
          f"finite logits, wgmma_bf16 launches {flash_counts()['wgmma_bf16']}")
    del model, state, batch, logits
    torch.cuda.empty_cache()
    return out


def phase_training(torch) -> dict:
    """Phase 20, the training path: (a) the smoke train steps card == CPU,
    (b) the trainer and the compressed-DP example, (c)-(d) gemma2-2b at
    full width. Returns the flash launches of the train steps (none: the
    train step runs the plain attention)."""
    t = time.perf_counter()
    smoke = phase_train_smoke(torch)
    phase_trainer(torch)
    full = phase_gemma2_train(torch)
    print(f"# [20] {time.perf_counter() - t:.2f} s")
    return smoke["launches"] + full["c"]["launches"]


COLL_OPS = ("psum", "all_gather", "all_to_all")
#: Coordinate-descent rounds of 21d's fit, cut from the reference CLI's 8
#: to keep phase 21 near 150 s on the card.
COLLECTIVE_FIT_ROUNDS = 4


def coll_bytes(op, n, count, itemsize) -> int:
    """Bytes one rank's collective reads and writes in device memory: its
    input once and its output once (``all_gather`` writes ``n`` inputs)."""
    return itemsize * count * (1 + (n if op == "all_gather" else 1))


def coll_held(torch, backend, ctx, case, tag) -> None:
    """Every rank's output of ``case`` equals ``expected_collective``
    exactly (the ranks held it once already, when the case was built)."""
    import numpy as np

    from repro_torch.campaign.ranks import expected_collective

    outs = backend.outputs(ctx, case)
    terms = backend._build_case(case.op, case.msize)
    dt = getattr(torch, backend.dtype)
    for rank, got in enumerate(outs):
        for (op, count, tn), out in zip(terms, got):
            if rank >= tn:
                require(out is None, f"{tag} {case.op}@{case.msize}: rank {rank} idle")
                continue
            want = expected_collective(op, rank, tn, count, dt).float().numpy()
            require(out is not None and np.array_equal(out, want),
                    f"{tag} {case.op}@{case.msize} {backend.dtype}: rank {rank}'s {op} "
                    f"== expected_collective exactly")


def coll_table(torch, backend, msizes, nrep, tag, bound_at=None) -> dict:
    """Each op at each size on one group: held exactly, then ``nrep``
    timed repetitions (barrier + max over ranks); the median in us, with
    the card's bound beside the size ``bound_at``."""
    import numpy as np

    from repro_torch.core import TestCase

    out = {}
    ctx = backend.make_epoch(0)
    n, itemsize = backend._n(), getattr(torch, backend.dtype).itemsize
    print(f"# {tag} {n} {ctx.group.dist_backend} rank(s), {backend.dtype}, group start-up "
          f"{ctx.group.startup_s:.3f} s (spawn to first barrier) | {smi()}")
    for op in COLL_OPS:
        cells = []
        for msize in msizes:
            case = TestCase(op, msize)
            coll_held(torch, backend, ctx, case, tag)
            times = backend.measure(ctx, case, nrep)
            skew = backend.record_meta(ctx, case)["rank_skew_s"]
            med = float(np.median(times)) * 1e6
            [(_, count, _)] = backend._build_case(op, msize)
            cell = f"{msize} B {med:.1f} us"
            if n > 1:
                cell += f" (skew {skew * 1e6:.1f} us)"
            if bound_at is not None and msize == bound_at:
                moved = coll_bytes(op, n, count, itemsize)
                cell += (f", bound {moved / HBM_BYTES_PER_S * 1e6:.1f} us "
                         f"({moved / 2**20:.0f} MiB at 3.35 TB/s)")
            cells.append(cell)
            out[(op, msize)] = med
        print(f"# {tag} {op}: " + "; ".join(cells) + f" (median of {nrep}, held exactly)")
    return out


def coll_campaign(torch, backend, nrep, tag, tmp) -> dict:
    """A 3-epoch campaign over ``default_cases()``, a fresh rank group each
    epoch, stored and reloaded: each group's start-up, each case's
    per-epoch medians and rank skew."""
    import numpy as np

    from repro_torch.campaign import Campaign, CampaignSpec, ResultStore
    from repro_torch.core import ExperimentDesign

    store = ResultStore(tmp / f"{tag.strip('[]').replace(' ', '-')}.jsonl")
    spec = CampaignSpec(backend.default_cases(),
                        ExperimentDesign(n_launch_epochs=3, nrep=nrep, seed=0), name=tag)
    t = time.perf_counter()
    with backend:
        res = Campaign(spec, backend, store).run()
    wall = time.perf_counter() - t
    table = ResultStore(store.path).to_table(res.fingerprint)
    starts = {r.epoch: r.meta["group_start_s"] for r in res.records}
    pids = {r.epoch: tuple(r.meta["rank_pids"]) for r in res.records}
    require(len(set(pids.values())) == 3, f"{tag} campaign: a fresh rank group each epoch")
    print(f"# {tag} campaign: 3 epochs x {len(spec.cases)} cases at nrep {nrep}, wall "
          f"{wall:.2f} s; group start-up by epoch "
          + ", ".join(f"{starts[e]:.3f}" for e in sorted(starts)) + " s")
    meds = {}
    for case in spec.cases:
        med = table.medians(case)
        require(med.size == 3 and bool(np.all(med > 0)),
                f"{tag} campaign {case.op}@{case.msize}: 3 positive per-epoch medians "
                "reloaded from the store")
        skew = [r.meta["rank_skew_s"] for r in res.records if r.case == case]
        meds[(case.op, case.msize)] = med
        print(f"# {tag} campaign {case.op}@{case.msize}: per-epoch medians "
              + ", ".join(f"{m * 1e6:.1f}" for m in med) + " us; rank skew "
              + ", ".join(f"{s * 1e6:.1f}" for s in skew) + " us")
    return dict(wall=wall, starts=starts, medians=meds)


def phase_collectives(torch, device="cuda") -> int:
    """Phase 21, real collectives: (a) NCCL at world size 1 on the card,
    (b) gloo with CUDA tensors, four ranks on one card, (c) NCCL across
    ranks where there are two GPUs, else its refusal, (d) the sim <-> real
    calibration fit against (b)'s backend, (e) a rank killed between two
    measure calls. Returns sim_scan's launches in (d)'s fit."""
    from repro_torch.fleet.scheduler import stop_worker_server

    t = time.perf_counter()
    try:
        launches = _collective_runs(torch, device)
    finally:
        stop_worker_server()        # the fork server the ranks forked from
    print(f"# [21] {time.perf_counter() - t:.2f} s")
    return launches


def _collective_runs(torch, device) -> int:
    import multiprocessing as mp
    import os
    import signal
    import tempfile

    import numpy as np

    from repro_torch.campaign import ResultStore, TorchCollectiveBackend
    from repro_torch.core import TestCase
    from repro_torch.core.runtime_meter import MeterConfig
    from repro_torch.kernels.sim_scan import sim_durations_scan

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_collectives_"))
    on_card = device == "cuda"
    before = set(mp.active_children())
    shared = MeterConfig(epoch_isolation="none")
    # (a) one NCCL rank: real NCCL collectives on the card's memory (gloo
    # on a CPU rehearsal)
    one = "nccl" if on_card else "gloo"
    for dtype in ("float32", "bfloat16"):
        with TorchCollectiveBackend(n_ranks=1, device=device, dist_backend=one,
                                    meter=shared, dtype=dtype) as b:
            coll_table(torch, b, (1 << 10, 1 << 16, 1 << 24), 100, "[21a]", bound_at=1 << 24)
    coll_campaign(torch, TorchCollectiveBackend(n_ranks=1, device=device, dist_backend=one),
                  100, "[21a]", tmp)

    # (b) four gloo ranks sharing the card, CUDA tensors staged through the host
    with TorchCollectiveBackend(n_ranks=4, device=device, dist_backend="gloo",
                                meter=shared) as b:
        coll_table(torch, b, (1 << 10, 1 << 16, 1 << 20), 100, "[21b]")
        ctx = b.make_epoch(0)
        for expr in ("psum+all_gather", "psum@half"):
            case = TestCase(expr, 1 << 16)
            coll_held(torch, b, ctx, case, "[21b]")
            times = b.measure(ctx, case, 100)
            skew = b.record_meta(ctx, case)["rank_skew_s"]
            print(f"# [21b] {expr}@{1 << 16}: held exactly; median "
                  f"{float(np.median(times)) * 1e6:.1f} us, skew {skew * 1e6:.1f} us")
    if on_card:
        # the same four ranks on CPU tensors: the host's ring alone, without
        # the staging through the card and four CUDA contexts sharing it
        with TorchCollectiveBackend(n_ranks=4, device="cpu", dist_backend="gloo",
                                    meter=shared) as b:
            coll_table(torch, b, (1 << 10, 1 << 16, 1 << 20), 100, "[21b cpu tensors]")
    coll_campaign(torch, TorchCollectiveBackend(n_ranks=4, device=device, dist_backend="gloo"),
                  100, "[21b]", tmp)

    # (c) NCCL across ranks needs one GPU per rank
    gpus = torch.cuda.device_count() if on_card else 0
    if gpus >= 2:
        with TorchCollectiveBackend(n_ranks=gpus, device=device, dist_backend="nccl",
                                    meter=shared) as b:
            coll_table(torch, b, (1 << 10, 1 << 16, 1 << 24), 100, "[21c]", bound_at=1 << 24)
    else:
        try:
            TorchCollectiveBackend(n_ranks=2, device=device, dist_backend="nccl")
        except ValueError as e:
            refused = str(e)
        else:
            refused = None
        require(refused is not None and set(mp.active_children()) <= before,
                "[21c] NCCL over 2 ranks refused with ValueError, no process started")
        print(f"# [21c] NCCL across ranks skipped: {gpus} GPU(s) here, and {refused}")

    # (d) the sim <-> real fit against (b)'s backend (examples/calibrate_sim_torch.py)
    sim_durations_scan.launches = 0
    fit = load_example("calibrate_sim_torch").fit_collective(
        device, tmp / "calib", ranks=4, dist_backend="gloo", rounds=COLLECTIVE_FIT_ROUNDS)
    launches = sim_durations_scan.launches
    result = fit["result"]
    reloaded = ResultStore(fit["store"]).records(result.target_fingerprint)
    require(len(reloaded) == 12 * 4 and np.isfinite(result.objective) and result.rounds,
            "[21d] the fit completed and its target's 48 records reload from the store")
    if on_card:
        require(launches > 0, "[21d] the fit's candidates launched sim_scan")
    print(f"# [21d calibrate] TorchSimBackend(p=4) fitted to 4 gloo ranks on {device}: "
          + ", ".join(f"{k} {v:.6g}" for k, v in result.params.items())
          + f"; objective {result.objective:.6f}, {len(result.rounds)} rounds (max "
          f"{COLLECTIVE_FIT_ROUNDS}), verdict {result.verdict}, sim_scan launches "
          f"{launches}, wall {fit['wall']:.2f} s | {smi()}")

    # (e) a rank killed between two measure calls
    timeout = 20.0
    with TorchCollectiveBackend(n_ranks=4, device=device, dist_backend="gloo",
                                timeout_s=timeout) as b:
        ctx = b.make_epoch(0)
        b.measure(ctx, TestCase("psum", 1 << 10), 5)
        os.kill(ctx.group.pids[2], signal.SIGKILL)
        t = time.perf_counter()
        try:
            b.measure(ctx, TestCase("psum", 1 << 10), 5)
        except RuntimeError as e:
            err = str(e).splitlines()[0]
        else:
            err = None
        took = time.perf_counter() - t
    deadline = time.monotonic() + 5.0
    while set(mp.active_children()) - before and time.monotonic() < deadline:
        time.sleep(0.05)
    require(err is not None and took <= timeout + 5.0 and not set(mp.active_children()) - before,
            f"[21e] the next call raised RuntimeError within {timeout + 5:.0f} s ({took:.3f} s) "
            "and no rank is left")
    print(f"# [21e] rank 2 of 4 SIGKILLed between two measure calls: RuntimeError after "
          f"{took:.3f} s ({err}); no rank left")
    return launches


#: 21f's grid and cases: the dtype axis over 21b's ops and sizes
FLEET_DTYPES = ("float32", "bfloat16")
FLEET_SIZES = (1 << 10, 1 << 16, 1 << 20)
FLEET_EPOCHS, FLEET_NREP = 3, 10
#: seed 1 crashes cell 1's first attempt at its first measure call, and no
#: other attempt (FaultPlan.decide depends on the seed, cell and attempt only)
FLEET_CRASH = dict(seed=1, p_crash=0.5, within_calls=2)


def phase_collective_fleet(torch, device="cuda") -> dict:
    """21f: real collectives inside fleet attempts. The ``dtype`` grid over
    two gloo ranks sharing the card, serial, then on a fleet of two
    workers with one attempt crashed; returns the fleet's stats."""
    from repro_torch.fleet.scheduler import stop_worker_server

    t = time.perf_counter()
    try:
        out = _collective_fleet(torch, device)
    finally:
        stop_worker_server()        # the fork server the attempts forked from
    print(f"# [21f] {time.perf_counter() - t:.2f} s")
    return out


def _collective_fleet(torch, device) -> dict:
    import multiprocessing as mp
    import tempfile

    from repro_torch.campaign import (ResultStore, SweepScheduler, SweepSpec,
                                      TorchCollectiveBackend)
    from repro_torch.campaign.ranks import rank_alive
    from repro_torch.core import ExperimentDesign, FactorAxis, FactorGrid, TestCase
    from repro_torch.fleet import FaultPlan, FleetConfig, FleetScheduler

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_collective_fleet_"))
    grid = FactorGrid((FactorAxis("dtype", FLEET_DTYPES),), design_seed=0)
    spec = SweepSpec(grid=grid, cases=[TestCase(op, m) for op in ("psum", "all_gather",
                                                                  "all_to_all")
                                       for m in FLEET_SIZES],
                     design=ExperimentDesign(n_launch_epochs=FLEET_EPOCHS, nrep=FLEET_NREP,
                                             seed=0),
                     name="collective-fleet")
    backend = TorchCollectiveBackend(n_ranks=2, device=device, dist_backend="gloo")
    before = set(mp.active_children())

    def cells(store, sweep_id):
        return {idx: (fp, sorted((r.case.op, r.case.msize, r.epoch, len(r.times))
                                 for r in store.records(fp)))
                for idx, fp in store.sweep_cells(sweep_id).items()}

    t = time.perf_counter()
    serial_store = ResultStore(tmp / "serial.jsonl")
    serial_res = SweepScheduler(spec, backend, serial_store, n_workers=1).run()
    serial_wall = time.perf_counter() - t
    serial = cells(serial_store, serial_res.sweep_id)
    want = sorted((c.op, c.msize, e, FLEET_NREP) for c in spec.cases
                  for e in range(FLEET_EPOCHS))
    require(len(serial) == len(FLEET_DTYPES) and all(r == want for _, r in serial.values()),
            "[21f] serial: every cell's cases x epochs at nrep")
    serial_starts = sorted({(r.epoch, r.meta["group_start_s"]) for fp, _ in serial.values()
                            for r in serial_store.records(fp)})
    serial_pids = {pid for fp, _ in serial.values() for r in serial_store.records(fp)
                   for pid in r.meta["rank_pids"]}
    print(f"# [21f] serial: {len(serial)} cells ({', '.join(FLEET_DTYPES)}) x "
          f"{len(spec.cases)} cases (psum, all_gather, all_to_all at "
          f"{', '.join(map(str, FLEET_SIZES))} B) x {FLEET_EPOCHS} epochs at nrep "
          f"{FLEET_NREP}, 2 gloo ranks on {device}, a fresh group each epoch: wall "
          f"{serial_wall:.2f} s; group start-ups "
          + ", ".join(f"{s:.3f}" for _, s in serial_starts) + " s")

    plan = FaultPlan(**FLEET_CRASH)
    store = ResultStore(tmp / "fleet.jsonl")
    cfg = FleetConfig(n_workers=2, lease_ttl=120.0, poll_s=0.05, faults=plan)
    t = time.perf_counter()
    res = FleetScheduler(spec, backend, store, cfg).run()
    fleet_wall = time.perf_counter() - t
    f = res.fleet
    attempts = f["n_done"] + f["n_failed_attempts"]
    got = cells(store, res.sweep_id)
    require(not res.quarantined and res.n_cells_measured == len(FLEET_DTYPES)
            and f["start_method"] == "forkserver" and f["n_failed_attempts"] == 1,
            f"[21f] fleet: {len(FLEET_DTYPES)} cells measured on forked workers, the one "
            f"crashed attempt retried, none quarantined ({f['n_failed_attempts']} failed, "
            f"{f['n_quarantined']} quarantined)")
    require(got == serial, "[21f] fleet: the serial run's cells, fingerprints and case sets")
    groups = FLEET_EPOCHS * len(FLEET_DTYPES) + 1
    pids = f["rank_pids"]
    require(len(pids) == len(set(pids)) == 2 * groups and len(f["group_start_s"]) == groups,
            f"[21f] fleet: a fresh group of 2 ranks for each of {groups} epochs begun "
            f"({len(pids)} rank pids, {len(f['group_start_s'])} groups)")
    left = [pid for pid in list(pids) + sorted(serial_pids) if rank_alive(pid)]
    deadline = time.monotonic() + 5.0
    while (left or set(mp.active_children()) - before) and time.monotonic() < deadline:
        time.sleep(0.05)
        left = [pid for pid in left if rank_alive(pid)]
    require(not left and not set(mp.active_children()) - before,
            f"[21f] no rank process alive after the fleet ({left})")
    print(f"# [21f] fleet of 2 workers, crash {FLEET_CRASH}: wall {fleet_wall:.2f} s against "
          f"the serial {serial_wall:.2f} s ({fleet_wall / serial_wall:.2f}x); {attempts} "
          f"attempts, {f['n_failed_attempts']} failed and retried, {f['n_quarantined']} "
          f"quarantined; fork server ready in {f['server_start_s']:.2f} s, longest start to "
          f"first heartbeat {f['first_heartbeat_s']:.3f} s; group start-ups "
          + ", ".join(f"{s:.3f}" for s in f["group_start_s"])
          + f" s; outputs held exactly against expected_collective on every rank at each "
          f"build (a case that differs fails its attempt); fingerprints and case sets == "
          f"serial; {len(pids)} rank pids logged, {f['n_rank_pids_killed']} killed after "
          f"their attempt ended, none alive (nor the serial run's {len(serial_pids)})")
    return dict(f, fleet_wall=fleet_wall, serial_wall=serial_wall)


#: 22b's prefill and decode shapes: phase 19a's sequence, 19b's serving batch
SHARDED_PREFILL = 8192
SHARDED_BATCH, SHARDED_PROMPT, SHARDED_STEPS = 4, 128, 4
#: 22a's cells: gemma2-2b's three shapes on 16x16; on 2x16x16 only decode
#: (the 3-d mesh's train and prefill cells spend minutes in DTensor's
#: sharding propagation on the host)
DRYRUN_CELLS = (("train_4k", False), ("prefill_32k", False), ("decode_32k", False),
                ("decode_32k", True))


def phase_dryrun_fake() -> list:
    """22a: gemma2-2b's dry-run cells on a fake world (nothing allocated:
    meta tensors, a process group that communicates nothing), each
    report's three terms against the ``H100`` record."""
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import H100, fake_world, mesh_device_type

    out = []
    for shape, multi_pod in DRYRUN_CELLS:
        t = time.perf_counter()
        with fake_world(512 if multi_pod else 256):
            report, _ = lower_cell(GEMMA2, shape, multi_pod=multi_pod)
        wall = time.perf_counter() - t
        d = report.to_dict()
        mem = d["memory_per_device"]
        print(f"# [22a dry run] {GEMMA2} x {shape} on {d['mesh']} ({mesh_device_type()} mesh, "
              f"a fake world of {d['chips']}): compute {d['t_compute']:.4f} s, memory "
              f"{d['t_memory']:.4f} s, collective {d['t_collective']:.4f} s -> "
              f"{d['bottleneck']}; useful FLOPs ratio {d['useful_flops_ratio']:.3f}, roofline "
              f"fraction {d['roofline_fraction']:.4f}; arguments "
              f"{mem['argument_bytes'] / 2**30:.2f} GiB per device of "
              f"{H100.HBM_BYTES / 1e9:.0f} GB (peak predicted {mem['peak_bytes'] / 2**30:.2f} "
              f"GiB); collectives {d['collective_ops']}; wall {wall:.2f} s")
        require(d["flops_per_device"] > 0 and d["collective_bytes_per_device"] > 0
                and 0 < mem["argument_bytes"] < H100.HBM_BYTES,
                f"[22a] {shape} on {d['mesh']}: FLOPs, collectives and arguments that fit")
        out.append(dict(shape=shape, mesh=d["mesh"], wall=wall,
                        **{k: d[k] for k in ("t_compute", "t_memory", "t_collective",
                                             "bottleneck", "useful_flops_ratio",
                                             "roofline_fraction")},
                        argument_bytes=mem["argument_bytes"], peak_bytes=mem["peak_bytes"]))
    return out


def synced(torch, fn) -> tuple[object, float]:
    """``fn()`` and its wall on the host clock, fenced by a synchronize."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def sharded_launches(flash, fn):
    """``fn()``, and the flash launches it made on DTensors' local shards;
    holds that each was a ``wgmma_bf16`` launch, counted by the wrapper."""
    sharded, wgmma = flash.launches_sharded, flash.launches_by_instance["wgmma_bf16"]
    out = fn()
    n = flash.launches_sharded - sharded
    require(flash.launches_by_instance["wgmma_bf16"] - wgmma == n,
            f"[22] the {n} launches on local shards were the bf16 tensor-core kernel's")
    return out, n


def phase_sharded_step(torch, mesh) -> dict:
    """22b: gemma2-2b at full width in bf16 with its weights as DTensors on
    the 1x1 NCCL mesh (placed by ``param_specs``), prefill at B 1, S 8192
    and decode at batch 4 after a 128-token prompt, against the plain
    model on the same weights: bit-equal (one rank: the same kernels on
    the same bytes), the flash kernel launched on the local shards
    (``local_map``). The plain model's prefill first: each of its flash
    calls held at phase 7's bf16 check against the plain version in f32
    on the same values, its logits within phase 19's bf16 bound of the
    plain path's (``impl="ref"``)."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import make_decode_step, make_prefill_step
    from repro_torch.models import init_params, prefill
    from repro_torch.parallel import batch_specs, cache_specs, distribute, param_specs

    cfg = get_config(GEMMA2)
    t0 = time.perf_counter()
    plain = init_params(cfg, seed=22)
    sharded = distribute(copy.deepcopy(plain), param_specs(plain, cfg, mesh), mesh)
    gen = torch.Generator(device="cuda").manual_seed(22)
    toks = torch.randint(0, cfg.vocab_size, (1, SHARDED_PREFILL), device="cuda", generator=gen)
    batch = {"tokens": toks}
    dbatch = distribute(batch, batch_specs(mesh, batch), mesh)

    def held(got, want):
        got = got.to_local() if hasattr(got, "to_local") else got
        want32 = want.float()
        err = float((got.float() - want32).abs().max() / want32.abs().max())
        return err, bool(torch.equal(got, want)), bool(torch.isfinite(got.float()).all())

    step = make_prefill_step(cfg)
    step(plain, batch)                                     # warm: build and first calls
    want, t_plain = synced(torch, lambda: step(plain, batch))
    # the kernel at this shape: every call of the plain model's prefill
    # held alone, then the logits against the plain path's
    records = []
    with attention_as("kernel", records):
        again = step(plain, batch)
    require(len(records) == cfg.n_layers and all(r[3] for r in records),
            f"[22b] each of the prefill's {len(records)} flash calls == plain in f32 at "
            "phase 7's bf16 check")
    require(bool(torch.equal(again, want)), "[22b] the held calls gave the prefill's logits")
    del again
    ref, t_ref = synced(torch, lambda: make_prefill_step(cfg, impl="ref")(plain, batch))
    err_ref, _, finite_ref = held(want, ref)
    del ref
    local = [r for r in records if r[0] == cfg.window]
    glob = [r for r in records if r[0] != cfg.window]
    print(f"# [22b gemma2-2b bf16 prefill, plain model] B 1, S {SHARDED_PREFILL}: every flash "
          f"call ({len(records)}) == plain in f32 at phase 7's bf16 check (worst max |err| "
          f"local {max(r[1] for r in local):.3e}, global {max(r[1] for r in glob):.3e}; RMS "
          f"err / RMS local {max(r[2] for r in local):.3e}, global "
          f"{max(r[2] for r in glob):.3e}, bound 1e-2); logits == the plain path's "
          f"(impl=\"ref\", {t_ref * 1e3:.1f} ms) within {err_ref:.3e} of max |logit| (bound "
          f"{BF16_DECODE_BOUND})")
    require(finite_ref and err_ref <= BF16_DECODE_BOUND, f"[22b] the plain model's prefill "
            f"within {BF16_DECODE_BOUND} of the plain path's logits ({err_ref:.3e})")
    reset_flash_counts()
    (got, t_sharded), launched = sharded_launches(
        flash_attention, lambda: synced(torch, lambda: step(sharded, dbatch)))
    err, equal, finite = held(got, want)
    print(f"# [22b gemma2-2b bf16 prefill, 1x1 NCCL mesh] B 1, S {SHARDED_PREFILL}: DTensor "
          f"logits {'bit-equal to' if equal else 'differ from'} the plain model's, max |d| / "
          f"max |logit| {err:.3e}; step {t_plain * 1e3:.1f} ms plain, {t_sharded * 1e3:.1f} "
          f"ms as DTensors; flash launches through local_map {launched} (placements "
          f"{[str(p) for p in got.placements]})")
    require(finite and equal, f"[22b] sharded prefill bit-equal to the plain model's logits "
            f"({err:.3e})")
    require(launched == cfg.n_layers, f"[22b] the prefill launched the flash kernel once a "
            f"layer through local_map ({launched})")
    out = dict(prefill=dict(err=err, equal=equal, plain_s=t_plain, sharded_s=t_sharded,
                            err_ref=err_ref, calls_held=len(records)))
    del want, got

    # decode: the plain model's 128-token prompt, its cache copied onto the mesh
    prompt = torch.randint(0, cfg.vocab_size, (SHARDED_BATCH, SHARDED_PROMPT), device="cuda",
                           generator=gen)
    _, cache = prefill(cfg, plain, prompt, max_len=SHARDED_PROMPT + SHARDED_STEPS)
    dcache = {"segments": [{k: v.clone() for k, v in seg.items()} for seg in cache["segments"]],
              "pos": cache["pos"]}
    dcache = distribute(dcache, cache_specs(cfg, mesh, dcache), mesh)
    decode = make_decode_step(cfg)
    errs, equal, times, launched_decode = [], True, [], 0
    for i in range(SHARDED_STEPS):
        tok = torch.randint(0, cfg.vocab_size, (SHARDED_BATCH, 1), device="cuda", generator=gen)
        (want, cache), tp = synced(torch, lambda: decode(plain, cache, {"tokens": tok}))
        dtok = distribute({"t": tok}, batch_specs(mesh, {"t": tok}), mesh)["t"]
        ((got, dcache), ts), n = sharded_launches(flash_attention, lambda: synced(
            torch, lambda: decode(sharded, dcache, {"tokens": dtok})))
        e, eq, fin = held(got, want)
        require(fin and eq, f"[22b] decode step {i} bit-equal to the plain model's ({e:.3e})")
        errs.append(e)
        equal &= eq
        times.append((tp, ts))
        launched_decode += n
    print(f"# [22b gemma2-2b bf16 decode, 1x1 NCCL mesh] batch {SHARDED_BATCH} after a "
          f"{SHARDED_PROMPT}-token prompt, {SHARDED_STEPS} steps: logits "
          f"{'bit-equal' if equal else 'not bit-equal'}, max |d| / max |logit| per step "
          + ", ".join(f"{e:.3e}" for e in errs) + "; step ms plain / DTensor "
          + ", ".join(f"{a * 1e3:.1f}/{b * 1e3:.1f}" for a, b in times)
          + f"; flash launches through local_map {launched_decode}; "
          f"{time.perf_counter() - t0:.2f} s")
    require(launched_decode == SHARDED_STEPS * cfg.n_layers,
            f"[22b] each decode step launched the flash kernel once a layer ({launched_decode})")
    out["decode"] = dict(errs=errs, equal=equal, times=times)
    out["launches_sharded"] = flash_attention.launches_sharded
    del plain, sharded, cache, dcache
    torch.cuda.empty_cache()
    return out


def phase_analysis_vs_card(torch, mesh) -> dict:
    """22c: phase 20c's train step (gemma2-2b bf16, B 1, S 8192, remat,
    ``ce_chunk`` 8) counted by ``lower_cell`` at world size 1 (meta
    DTensors on the 1x1 mesh), then run on the card: FLOPs, bytes and the
    ``H100`` roofline bound beside the measured step, the predicted peak
    beside ``max_memory_allocated``. The ratios are findings, not gates."""
    import numpy as np

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import init_train_state, make_train_step
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.models import init_params, tuning
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime.trainer import to_device

    cfg = get_config(GEMMA2)
    s = 8192
    tuning.set_tuning(ce_chunk=8)
    try:
        t = time.perf_counter()
        report, _ = lower_cell(GEMMA2, ShapeSpec("train_8k_b1", s, 1, "train"), mesh=mesh)
        t_analysis = time.perf_counter() - t
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(init_params(cfg, seed=25))
        batch = to_device(SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                                 global_batch=1, seed=25)).batch_at(0), "cuda")
        step = make_train_step(cfg, OptimizerConfig(lr=GEMMA2_TRAIN_LR, warmup_steps=1,
                                                    weight_decay=0.1))
        times = []
        for _ in range(4):
            (state, m), dt = synced(torch, lambda: step(state, batch))
            times.append(dt)
        peak = torch.cuda.max_memory_allocated()
        require(bool(torch.isfinite(m["loss"])), "[22c] a finite loss")
    finally:
        tuning.reset_tuning()
    wall = float(np.mean(times[1:]))
    d = report.to_dict()
    pred = d["memory_per_device"]["peak_bytes"]
    print(f"# [22c analysis vs card] {GEMMA2} bf16 train step, B 1, S {s}, remat, ce_chunk 8: "
          f"counted {d['flops_per_device']:.4e} FLOP, {d['bytes_per_device']:.4e} B accessed, "
          f"collectives {d['collective_ops']} (1x1 mesh); H100 bound "
          f"{report.step_time_bound:.4f} s by {d['bottleneck']} (compute {d['t_compute']:.4f} s, "
          f"memory {d['t_memory']:.4f} s); measured step " + ", ".join(f"{x:.4f}" for x in times)
          + f" s (mean of the last 3 {wall:.4f} s, {wall / report.step_time_bound:.2f}x the "
          f"bound); peak predicted {pred / 2**30:.2f} GiB, max_memory_allocated "
          f"{peak / 2**30:.2f} GiB (ratio {pred / peak:.3f}); analysis {t_analysis:.2f} s")
    del state, batch
    torch.cuda.empty_cache()
    return dict(flops=d["flops_per_device"], bytes=d["bytes_per_device"],
                bound_s=report.step_time_bound, bottleneck=d["bottleneck"], times=times,
                wall=wall, peak_pred=pred, peak=peak, analysis_s=t_analysis)


def sharding_child(torch, out_path: str) -> None:
    """Phase 22's body, in its own process: the fake world of 22a, then a
    one-rank NCCL group for 22b and 22c, each destroyed before the next;
    its results go to ``out_path`` as JSON."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    res = {"a": phase_dryrun_fake()}
    with tempfile.TemporaryDirectory() as rdv:
        dist.init_process_group("nccl", init_method=f"file://{rdv}/rdv", rank=0,
                                world_size=1)
        try:
            mesh = make_local_mesh()
            res["b"] = phase_sharded_step(torch, mesh)
            res["c"] = phase_analysis_vs_card(torch, mesh)
        finally:
            dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(res))


#: 22d: four gloo ranks sharing the card, mesh 2x2 (data x model), each
#: holding a quarter of gemma2-2b's attention: batch 2 over ``data``, the
#: 8/4 heads over ``model``
GLOO_RANKS, GLOO_MESH = 4, (2, 2)
GLOO_BATCH, GLOO_PREFILL, GLOO_PROMPT, GLOO_STEPS = 2, 2048, 32, 2


def local_part(full, dt):
    """The part of ``full`` (a plain tensor of ``dt``'s global shape) that
    this rank's shard of the DTensor ``dt`` holds: each sharded mesh dim,
    in mesh order, keeps its coordinate's chunk, as DTensor splits."""
    import torch

    mesh, coord = dt.device_mesh, dt.device_mesh.get_coordinate()
    for i, p in enumerate(dt.placements):
        if p.is_shard():
            full = torch.chunk(full, mesh.size(i), dim=p.dim)[coord[i]]
    return full


def blocking_gather_over_gloo(torch):
    """torch 2.11's functional all-gather, the one DTensor issues
    (``_c10d_functional.all_gather_into_tensor``), crashes in
    ``wait_tensor`` over gloo on CUDA tensors (a segfault on the card,
    f32 and bf16 alike), while c10d's own ``all_gather_into_tensor`` and
    the functional all-reduce and reduce-scatter run there. This replaces
    the op's CUDA kernel, in this process, by c10d's blocking all-gather
    over the same group: the same values, no work left for ``wait_tensor``
    to wait on. Returns the registration, which lasts as long as it is
    held."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    def gather(inp, group_size, group_name):
        out = inp.new_empty((inp.shape[0] * group_size, *inp.shape[1:]))
        dist.all_gather_into_tensor(out, inp.contiguous(),
                                    group=_resolve_process_group(group_name))
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", gather, "CUDA")
    return lib


def gloo_rank(torch, rank: int, rdv: str, out_path: str) -> None:
    """22d, one rank of four gloo ranks on the one card, mesh 2x2 of type
    ``"cuda"`` (NCCL takes one rank per device): gemma2-2b at full width
    in bf16, its weights as DTensors by ``param_specs``, a prefill at
    batch 2, S 2048 and decode steps on a cache placed by ``cache_specs``.
    The flash kernel runs on each rank's local shards: every local call's
    q and k shapes are recorded, and the call is held at phase 7's bf16
    check against the plain version in f32 on the same values; this
    rank's part of the logits against the unsharded model's (flash on
    whole tensors) and the plain path's (``impl="ref"``), at phase 19's
    bf16 bound."""
    import faulthandler

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import make_decode_step, make_prefill_step
    from repro_torch.models import attention, init_params, prefill
    from repro_torch.models.common import is_dtensor
    from repro_torch.parallel import batch_specs, cache_specs, distribute, param_specs

    faulthandler.enable()      # a crash in a rank prints its Python stack
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=GLOO_RANKS)
    gather = blocking_gather_over_gloo(torch)
    try:
        mesh = init_device_mesh("cuda", GLOO_MESH, mesh_dim_names=("data", "model"))
        # the functional reduce-scatter that attention's partial sums take
        # onto heads (Partial -> Shard), probed on a small tensor first
        from torch.distributed.tensor import DTensor, Partial, Shard

        x = torch.arange(2 * 3 * 4 * 2, dtype=torch.float32, device="cuda").reshape(2, 3, 4, 2)
        rs = DTensor.from_local(x, mesh, [Partial(), Partial()]).redistribute(
            mesh, [Shard(0), Shard(2)])
        reduce_scatter = bool(torch.equal(rs.to_local(), local_part(GLOO_RANKS * x, rs)))
        cfg = get_config(GEMMA2)
        plain = init_params(cfg, seed=26)
        sharded = distribute(copy.deepcopy(plain), param_specs(plain, cfg, mesh), mesh)
        gen = torch.Generator(device="cuda").manual_seed(26)
        toks = torch.randint(0, cfg.vocab_size, (GLOO_BATCH, GLOO_PREFILL), device="cuda",
                             generator=gen)
        kernel_op, calls = attention.attention_op, []

        def op(q, k, v, *, impl="auto", **kw):
            # the model's calls arrive as DTensors and go to local_map,
            # which calls back here with each rank's local shards
            out = kernel_op(q, k, v, impl=impl, **kw)
            if not is_dtensor(q):
                ref32 = attention.attention_reference(q.float(), k.float(), v.float(), **kw)
                calls.append((tuple(q.shape), tuple(k.shape), *bf16_held(out, ref32)))
            return out

        def rel(got, want):
            want = local_part(want, got).float()
            return float((got.to_local().float() - want).abs().max() / want.abs().max())

        res = {"rank": rank, "reduce_scatter": reduce_scatter}
        step = make_prefill_step(cfg)
        batch = {"tokens": toks}
        want = step(plain, batch)
        ref = make_prefill_step(cfg, impl="ref")(plain, batch)
        dbatch = distribute(batch, batch_specs(mesh, batch), mesh)
        attention.attention_op = op
        try:
            got, n = sharded_launches(flash_attention, lambda: step(sharded, dbatch))
        finally:
            attention.attention_op = kernel_op
        res["prefill"] = dict(err=rel(got, want), err_ref=rel(got, ref), launches=n,
                              calls=calls[:],
                              placements=[str(p) for p in got.placements],
                              finite=bool(torch.isfinite(got.to_local().float()).all()))
        del want, ref, got

        prompt = toks[:, :GLOO_PROMPT]
        _, cache = prefill(cfg, plain, prompt, max_len=GLOO_PROMPT + GLOO_STEPS)
        dcache = {"segments": [{k: v.clone() for k, v in seg.items()}
                               for seg in cache["segments"]], "pos": cache["pos"]}
        dcache = distribute(dcache, cache_specs(cfg, mesh, dcache), mesh)
        res["cache_local"] = list(dcache["segments"][0]["k"].to_local().shape)
        decode, res["decode"] = make_decode_step(cfg), []
        for i in range(GLOO_STEPS):
            tok = toks[:, GLOO_PROMPT + i:GLOO_PROMPT + i + 1]
            want, cache = decode(plain, cache, {"tokens": tok})
            dtok = distribute({"t": tok}, batch_specs(mesh, {"t": tok}), mesh)["t"]
            attention.attention_op, calls[:] = op, []
            try:
                (got, dcache), n = sharded_launches(
                    flash_attention, lambda: decode(sharded, dcache, {"tokens": dtok}))
            finally:
                attention.attention_op = kernel_op
            res["decode"].append(dict(
                err=rel(got, want), launches=n, calls=calls[:],
                finite=bool(torch.isfinite(got.to_local().float()).all())))
    finally:
        dist.destroy_process_group()
        del gather
    Path(out_path).write_text(json.dumps(res))


def phase_gloo_ranks() -> dict:
    """22d: :func:`gloo_rank` in four processes at once, each awaited at
    most 600 s and all killed if one is not done; their results, held."""
    import tempfile

    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [Path(tmp) / f"rank{r}.json" for r in range(GLOO_RANKS)]
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                   "--phase-22-rank", str(r), f"{tmp}/rdv", str(outs[r])])
                 for r in range(GLOO_RANKS)]
        deadline = time.monotonic() + 600
        try:
            rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        require(all(rc == 0 for rc in rcs) and all(o.exists() for o in outs),
                f"[22d] the gloo ranks exited {rcs}")
        ranks = [json.loads(o.read_text()) for o in outs]
    from repro_torch.configs import get_config

    cfg = get_config(GEMMA2)
    heads = (cfg.n_heads // GLOO_MESH[1], cfg.n_kv_heads // GLOO_MESH[1])

    def on_heads(c):
        return (c[0][2], c[1][2]) == heads

    require(all(r["reduce_scatter"] for r in ranks),
            "[22d] the functional reduce-scatter (Partial -> Shard over both mesh dims) "
            "gives each rank its part of the sum")
    print("# [22d] the functional reduce-scatter over gloo on CUDA tensors (Partial -> "
          "Shard(0), Shard(2) on the 2x2 mesh): each rank's part of the sum, exact")
    for r in ranks:
        pre = r["prefill"]
        calls = pre["calls"] + [c for d in r["decode"] for c in d["calls"]]
        print(f"# [22d gemma2-2b bf16, 4 gloo ranks on one card, 2x2 cuda mesh] rank "
              f"{r['rank']}: prefill B {GLOO_BATCH}, S {GLOO_PREFILL}: logits part "
              f"{pre['placements']} == unsharded within {pre['err']:.3e}, == plain path "
              f"within {pre['err_ref']:.3e} of max |logit|; decode steps after a "
              f"{GLOO_PROMPT}-token prompt (cache shard {r['cache_local']}) within "
              + ", ".join(f"{d['err']:.3e}" for d in r["decode"])
              + f" (bound {BF16_DECODE_BOUND}); flash launches on local shards "
              f"{pre['launches']} + {sum(d['launches'] for d in r['decode'])}, on head "
              f"shards {sum(map(on_heads, pre['calls']))} + "
              f"{sum(on_heads(c) for d in r['decode'] for c in d['calls'])}, local q/k "
              f"shapes {sorted({(tuple(c[0]), tuple(c[1])) for c in calls})}, worst max "
              f"|err| {max(c[2] for c in calls):.3e}, RMS err / RMS "
              f"{max(c[3] for c in calls):.3e} (phase 7's bf16 check)")
        errs = [pre["err"], pre["err_ref"]] + [d["err"] for d in r["decode"]]
        require(pre["finite"] and all(d["finite"] for d in r["decode"])
                and max(errs) <= BF16_DECODE_BOUND,
                f"[22d] rank {r['rank']}: sharded logits within {BF16_DECODE_BOUND} ({errs})")
        require(pre["launches"] == cfg.n_layers
                and all(d["launches"] == cfg.n_layers for d in r["decode"]),
                f"[22d] rank {r['rank']}: the flash kernel once a layer on local shards")
        require(len(calls) == cfg.n_layers * (1 + GLOO_STEPS) and all(c[4] for c in calls),
                f"[22d] rank {r['rank']}: every local flash call at phase 7's bf16 check")
        # a batch shard and this rank's heads in every call of every layer,
        # prefill and decode: where q and k arrive as partial sums over
        # ``model`` (torch 2.13 on the CPU, from the second layer on), they
        # are reduce-scattered onto heads, not reduced whole
        require(all(c[0][0] == c[1][0] == GLOO_BATCH // GLOO_MESH[0] for c in calls)
                and all(on_heads(c) for c in calls),
                f"[22d] rank {r['rank']}: the kernel ran on batch and head shards in every "
                f"layer ({sum(map(on_heads, calls))} of {len(calls)} calls on head shards)")
    print(f"# [22d] {time.perf_counter() - t:.2f} s")
    return dict(ranks=ranks, launches=sum(r["prefill"]["launches"] + sum(
        d["launches"] for d in r["decode"]) for r in ranks))


def phase_sharding(torch) -> dict:
    """Phase 22, sharding and launch analysis: 22a-c in a child process, so
    that no process group outlives it beside phase 21's rank groups, then
    22d's four gloo ranks."""
    import tempfile

    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "phase22.json"
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--phase-22",
                               str(out)], timeout=900)
        require(proc.returncode == 0 and out.exists(),
                f"[22] the phase's process exited {proc.returncode}")
        res = json.loads(out.read_text())
    require(res["b"]["launches_sharded"] > 0, "[22b] flash launches through local_map")
    res["d"] = phase_gloo_ranks()
    print(f"# [22] {time.perf_counter() - t:.2f} s")
    return res


#: quickstart's two HCA lines: host numpy (``SimNet(16, seed=0)``, hca at
#: 200 fit points x 40 exchanges), the same in both packages, as
#: ``examples/quickstart.py`` prints them
QUICKSTART_HCA = ["HCA sync: 0.621s, max offset 1.13us",
                  "  after 10s of drift: 9.55us (still synced)"]


def phase_walkthroughs(torch) -> dict:
    """23: the five reference walkthroughs on the card, in the order of
    ``examples/``, each through its ``main`` (``--device cuda``) in this
    process at the reference's sizes, each checked for what the reference
    asserts or prints; the compare_impls verdicts are printed, not gated.
    Returns ``sim_scan``'s and the f32 flash kernel's launches."""
    from repro_torch.kernels.sim_scan import sim_durations_scan

    t_phase = time.perf_counter()
    sim_durations_scan.launches = 0
    reset_flash_counts()
    walls, scans = {}, {}

    def run(name):
        before = sim_durations_scan.launches
        t = time.perf_counter()
        res = load_example(name).main(["--device", "cuda"])
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
        scans[name] = sim_durations_scan.launches - before
        print(f"# [23 {name}] wall {walls[name]:.2f} s, sim_scan launches {scans[name]}, "
              f"flash launches {flash_counts()}")
        return res

    # compare_impls: f32 flash (the tf32x3 instance) against its plain version
    res = run("compare_impls_torch")
    rows = res["rows"]
    require([r.case.msize for r in rows] == [128, 256]
            and all(0 < r.avg_a < float("inf") and 0 < r.avg_b < float("inf") for r in rows),
            "[23 compare_impls] two rows, S 128 and 256, finite times")
    require(len(res["verdicts"]) == 2, "[23 compare_impls] one verdict line per S")
    counts = flash_counts()
    require(counts["tf32x3"] > 0 and sum(counts.values()) == counts["tf32x3"],
            f"[23 compare_impls] the kernel arm launched the f32 flash instance only ({counts})")

    # factor_impact: tuning first and Holm-significant, dtype null (the
    # walkthrough raises otherwise), the resume, the store round trip
    res = run("factor_impact_torch")
    top = res["effects"][0]
    dtype = [e for e in res["effects"] if e.axis == "dtype"][0]
    require(top.axis == "tuning" and top.significant and not dtype.significant,
            "[23 factor_impact] tuning ranked first and Holm-significant, dtype null")
    require((res["n_cells"], res["n_resumed"], res["n_measured_again"]) == (16, 16, 0),
            f"[23 factor_impact] 16 cells measured, then 16 resumed and 0 measured "
            f"(got {res['n_cells']}, {res['n_resumed']}, {res['n_measured_again']})")
    require(res["store_top"] == "tuning", "[23 factor_impact] the store round trip names tuning")

    # quickstart: the reference's HCA lines, both Wilcoxon rows A<B
    res = run("quickstart_torch")
    require(res["hca"] == QUICKSTART_HCA,
            f"[23 quickstart] HCA lines {res['hca']}, the reference's {QUICKSTART_HCA}")
    require(0 < res["windowed_mean"] < res["barrier_mean"],
            "[23 quickstart] the windowed mean below the skewed barrier's")
    require([r.verdict for r in res["rows"]] == ["A<B", "A<B"],
            f"[23 quickstart] both rows A<B (got {[r.verdict for r in res['rows']]})")

    # repro_audit: 6/6 EQUIVALENT, exactly bcast DRIFTED, the resume
    res = run("repro_audit_torch")
    report, drifted, resumed = res["report"], res["drifted"], res["resumed"]
    require(report.all_equivalent and len(report.cells) == 6,
            "[23 repro_audit] the re-run 6/6 EQUIVALENT")
    require(sorted((c.op, c.msize) for c in drifted.drifted())
            == [("bcast", 512), ("bcast", 4096)],
            "[23 repro_audit] exactly the two bcast cells DRIFTED")
    require((resumed.n_resumed, resumed.n_computed) == (2, 4) and res["same"],
            "[23 repro_audit] the resume loads 2, recomputes 4, verdicts unchanged")

    # verify_guidelines: the honest library holds, the resume measures
    # nothing, the mis-tuned alltoall violates exactly the mock-up bound
    res = run("verify_guidelines_torch")
    honest, again, bad = res["report"], res["resumed"], res["bad"]
    require(len(honest.verdicts) == 10 and honest.ok,
            "[23 verify_guidelines] honest: all 10 cells hold")
    require(again.n_measured == 0, "[23 verify_guidelines] the resume measures nothing")
    violated = [v.guideline.name for v in bad.violations()]
    require(len(bad.verdicts) == 12 and violated == ["alltoall_mock_bound"] * 2,
            f"[23 verify_guidelines] mis-tuned alltoall: exactly alltoall_mock_bound's 2 "
            f"cells VIOLATED (got {violated})")

    launches = dict(sim_scan=sim_durations_scan.launches, tf32x3=flash_counts()["tf32x3"])
    require(launches["sim_scan"] > 0 and all(scans[n] > 0 for n in scans if n != "compare_impls_torch"),
            f"[23] each simulated walkthrough launched sim_scan ({scans})")
    require(launches["tf32x3"] > 0, "[23] the f32 flash kernel launched")
    print(f"# [23] walls {', '.join(f'{k} {v:.2f} s' for k, v in walls.items())}; "
          f"launches {launches}; phase {time.perf_counter() - t_phase:.2f} s")
    return launches


@contextlib.contextmanager
def captured_durations(store: list, method: str = "execute_batch"):
    """Append the durations of every ``SimCollective.<method>`` call
    (``execute_batch``: the numpy engines' draws; ``sample_durations``: the
    barrier scheme's under ``engine="batch"``) to ``store`` while the block
    runs."""
    from repro_torch.core.mpi_ops import SimCollective

    original = getattr(SimCollective, method)

    def capture(self, *args, **kw):
        out = original(self, *args, **kw)
        store.append(getattr(out, "durations", out))
        return out

    setattr(SimCollective, method, capture)
    try:
        yield store
    finally:
        setattr(SimCollective, method, original)


def durations_err(cpu: list, card: list, what: str) -> float:
    """The card's durations against numpy's, call by call: the same calls,
    each within 1e-12 of its largest duration; returns the largest
    relative difference."""
    import numpy as np

    require(len(cpu) == len(card) and all(a.shape == b.shape for a, b in zip(cpu, card)),
            f"{what}: the same execute_batch calls on cpu and cuda ({len(cpu)}, {len(card)})")
    worst = max((float(np.abs(a - b).max() / np.abs(a).max()) for a, b in zip(cpu, card)
                 if a.size), default=0.0)
    require(worst <= 1e-12, f"{what}: durations cuda vs cpu {worst:.3e} <= 1e-12 relative")
    return worst


def copied_state(net, sync, op):
    """A deep copy of ``(net, sync, op)`` that carries the ops' cached
    epoch biases over to the copied net (a ``WeakKeyDictionary`` keeps its
    keys when deep-copied, so the copy would draw its biases again)."""
    state = copy.deepcopy((net, sync, op))
    terms = [t for t, _, _ in op.terms] if getattr(op, "terms", None) else [op]
    twins = [t for t, _, _ in state[2].terms] if getattr(op, "terms", None) else [state[2]]
    for term, twin in zip(terms, twins):
        if net in term._epoch_bias:
            twin._epoch_bias[state[0]] = term._epoch_bias[net]
    return state


def window_pair(torch, net, sync, op, nrep, win, engine) -> dict:
    """One ``run_windowed`` call of ``engine`` on ``"cpu"`` and on
    ``"cuda"`` from one state (the net, sync and op copied first): equal
    flags, the durations within 1e-12 relative, the times and stamps
    within 1e-12 of the run's timeline (its largest stamp: a time is a
    difference of two stamps, and a duration that moved by an ulp can move
    a stamp by one of the stamp's ulps), ``net.t``, the AR(1) state and
    the generator's state the same. Returns the walls and differences."""
    import numpy as np

    from repro_torch.core import run_windowed
    from repro_torch.kernels.sim_scan import sim_durations_scan

    card = copied_state(net, sync, op)
    out, runs, durs = {}, {}, {}
    for device, state in (("cpu", (net, sync, op)), ("cuda", card)):
        with captured_durations([]) as durs[device]:
            launches = sim_durations_scan.launches
            t = time.perf_counter()
            runs[device] = run_windowed(*state, 4096, nrep, win, device=device, engine=engine)
            torch.cuda.synchronize()
            out[f"{device}_s"] = time.perf_counter() - t
            out[f"{device}_launches"] = sim_durations_scan.launches - launches
    a, b = runs["cpu"], runs["cuda"]
    what = f"[24 {engine}] p={net.p} nrep {nrep}"
    require(out["cpu_launches"] == 0 and out["cuda_launches"] == 1,
            f"{what}: sim_scan launched once on cuda, never on cpu "
            f"({out['cuda_launches']}, {out['cpu_launches']})")
    require(np.array_equal(a.errors, b.errors), f"{what}: error flags equal")
    out["dur_rel"] = durations_err(durs["cpu"], durs["cuda"], what)
    scale = max(float(np.abs(a.end_true).max()), float(np.abs(a.end_global_est).max()))
    out["scale_s"], out["max_abs"] = scale, 0.0
    for k in ("times", "start_true", "end_true", "start_global_est", "end_global_est"):
        err = float(np.abs(getattr(a, k) - getattr(b, k)).max())
        require(err <= 1e-12 * scale, f"{what} {k}: |err| {err:.3e} <= 1e-12 x {scale:.3f} s")
        out["max_abs"] = max(out["max_abs"], err)
    out["times_rel"] = float(np.abs(a.times - b.times).max() / np.abs(a.times).max())
    require(float(np.abs(net.t - card[0].t).max()) <= 1e-12 * scale, f"{what}: net.t")
    require(abs(op._ar_state - card[2]._ar_state) <= 1e-12, f"{what}: AR(1) carry")
    require(net.rng.bit_generator.state == card[0].rng.bit_generator.state,
            f"{what}: the generator in the same state")
    out["invalid"] = a.invalid_fraction
    return out


def phase_numpy_engines(torch, main_epoch_s=float("nan"), p=512, nrep=100_000, rw_p=64,
                        rw_nrep=10_000) -> int:
    """24: the reference's numpy engines, their durations scanned by
    ``sim_scan`` on the card. (a) the archived reference run regenerated
    through ``TorchSimBackend(engine=...)``, ``"batch"`` then ``"auto"``:
    on ``"cpu"`` every record bit-equal to the archive, on ``"cuda"`` the
    same record lengths, each execute_batch call's durations within 1e-12
    relative of the CPU's, the times within 1e-12 of the campaign's
    timeline; (b) phase 6's shape through ``run_windowed(engine="batch")``
    on both devices from one state; (c) ``batch_rw`` on phase 10's walking
    clocks; (d) the two refusals. Returns ``sim_scan``'s launches."""
    import numpy as np

    from repro_torch.campaign import Campaign, CampaignSpec, ResultStore, TorchSimBackend
    from repro_torch.core import ClockParams, ExperimentDesign, SimNet, TestCase, make_op, make_sync
    from repro_torch.core import run_windowed
    from repro_torch.kernels.sim_scan import sim_durations_scan

    t_phase = time.perf_counter()
    sim_durations_scan.launches = 0

    # (a) the archive, all 72 records
    archive = {(r.case.op, r.case.msize, r.epoch): r.times for r in ResultStore(
        ROOT / "benchmarks" / "reference_archive" / "run-000.jsonl").records()}
    cases = [TestCase(op, m) for op in ("allreduce", "bcast", "alltoall") for m in (512, 4096)]
    spec = CampaignSpec(cases, ExperimentDesign(n_launch_epochs=12, nrep=40, seed=0),
                        name="repro-audit")
    for engine in ("batch", "auto"):
        got, durs, scale = {}, {}, [0.0]
        for device in ("cpu", "cuda"):
            backend = TorchSimBackend(p=8, seed0=0, sync_kw=dict(n_fitpts=60, n_exchanges=20),
                                      engine=engine, device=device)
            measure = backend.measure

            def measured(ctx, case, nrep, measure=measure):
                out = measure(ctx, case, nrep)
                scale[0] = max(scale[0], float(np.abs(ctx.net.t).max()))
                return out

            backend.measure = measured
            launches = sim_durations_scan.launches
            t = time.perf_counter()
            with captured_durations([]) as durs[device]:
                res = Campaign(spec, backend).run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = sim_durations_scan.launches - launches
            got[device] = {(r.case.op, r.case.msize, r.epoch): r.times for r in res.records}
            require(set(got[device]) == set(archive) and len(archive) == 72,
                    f"[24a {engine} {device}] the archive's 72 records")
            require(all(r.meta["engine"] == "batch" and r.meta["device"].startswith(device)
                        and not r.meta["fused"] for r in res.records),
                    f"[24a {engine} {device}] records say engine=batch on {device}, per epoch")
            print(f"# [24a {engine} {device}] 72 records in {wall:.2f} s, "
                  f"sim_scan launches {launches}, execute_batch calls {len(durs[device])}")
            if device == "cpu":
                require(launches == 0, f"[24a {engine} cpu] no kernel launch")
                require(all(np.array_equal(got["cpu"][k], archive[k]) for k in archive),
                        f"[24a {engine} cpu] every record bit-equal to the archive")
        require(launches > 0, f"[24a {engine} cuda] sim_scan launched")
        card = got["cuda"]
        require(all(card[k].size == archive[k].size for k in archive),
                f"[24a {engine} cuda] every record the archive's length")
        dur_rel = durations_err(durs["cpu"], durs["cuda"], f"[24a {engine}]")
        err = max(float(np.abs(card[k] - archive[k]).max()) for k in archive)
        rel = max(float(np.abs(card[k] - archive[k]).max() / np.abs(archive[k]).max())
                  for k in archive)
        require(err <= 1e-12 * scale[0],
                f"[24a {engine} cuda] |err| {err:.3e} s <= 1e-12 x timeline {scale[0]:.4f} s")
        n_diff = sum(not np.array_equal(card[k], archive[k]) for k in archive)
        print(f"# [24a {engine}] cpu: 72/72 records bit-equal to the archive; cuda: lengths "
              f"equal, durations within {dur_rel:.3e} relative, records max |err| {err:.3e} s "
              f"(max relative to the record's largest time {rel:.3e}; timeline "
              f"{scale[0]:.4f} s), {72 - n_diff}/72 records bit-equal")

    # (b) phase 6's shape, one epoch: p 512, nrep 1e5, hca 200 x 40, allreduce 4096 B
    t = time.perf_counter()
    net = SimNet(p, seed=0)
    sync = make_sync("hca", n_fitpts=200, n_exchanges=40).synchronize(net)
    sync_s = time.perf_counter() - t
    b = window_pair(torch, net, sync, make_op("allreduce"), nrep, 400e-6, "batch")
    print(f"# [24b batch] p={p} nrep {nrep} hca 200x40 allreduce@4096 (sync {sync_s:.2f} s): "
          f"wall cpu {b['cpu_s']:.2f} s, cuda {b['cuda_s']:.2f} s (phase 6's device "
          f"engine: {main_epoch_s:.2f} s per epoch of three cases); flags equal, invalid "
          f"{b['invalid']:.4f}; durations within {b['dur_rel']:.3e} relative; times and "
          f"stamps max |err| {b['max_abs']:.3e} s (timeline {b['scale_s']:.3f} s; times "
          f"relative {b['times_rel']:.3e}); sim_scan launches {b['cuda_launches']}")

    # (c) batch_rw on phase 10's walking clocks
    t = time.perf_counter()
    net = SimNet(rw_p, seed=5, clocks=ClockParams(rw_sigma=RW_SIGMA))
    sync = make_sync("hca", n_fitpts=100, n_exchanges=20).synchronize(net)
    sync_s = time.perf_counter() - t
    op = make_op("allreduce")
    c = window_pair(torch, net, sync, op, rw_nrep, 300e-6, "batch_rw")
    c2 = window_pair(torch, net, sync, op, rw_nrep // 3, 300e-6, "batch_rw")
    print(f"# [24c batch_rw] rw_sigma {RW_SIGMA:g}, p={rw_p}, hca 100x20 (sync {sync_s:.2f} s), "
          f"nrep {rw_nrep} then {rw_nrep // 3} on the grown paths: wall cpu {c['cpu_s']:.2f}, "
          f"{c2['cpu_s']:.2f} s, cuda {c['cuda_s']:.2f}, {c2['cuda_s']:.2f} s; flags equal, "
          f"invalid {c['invalid']:.4f}; durations within "
          f"{max(c['dur_rel'], c2['dur_rel']):.3e} relative; max |err| "
          f"{max(c['max_abs'], c2['max_abs']):.3e} s (timeline {c2['scale_s']:.3f} s; times "
          f"relative {max(c['times_rel'], c2['times_rel']):.3e})")

    # (d) the refusals: the scalar engine on the card, the reference's jax engine
    net = SimNet(4, seed=2)
    sync = make_sync("hca", n_fitpts=20, n_exchanges=5).synchronize(net)
    for engine, device in (("scalar", "cuda"), ("jax", "cuda")):
        try:
            run_windowed(net, sync, make_op("bcast"), 256, 10, 300e-6, device=device,
                         engine=engine)
        except ValueError as exc:
            print(f"# [24d] engine={engine!r} device={device!r} raised ValueError: {exc}")
        else:
            require(False, f"[24d] engine={engine!r} on {device} raises ValueError")
    try:
        TorchSimBackend(engine="scalar")
    except ValueError:
        pass
    else:
        require(False, "[24d] TorchSimBackend(engine='scalar') on the card raises")

    launches = sim_durations_scan.launches
    require(launches > 0, "[24] the numpy engines launched sim_scan on the card")
    print(f"# [24] sim_scan launches {launches}; phase {time.perf_counter() - t_phase:.2f} s")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    if sys.argv[1:2] == ["--phase-22"]:          # phase 22's own process
        sharding_child(torch, sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--phase-22-rank"]:     # one of 22d's gloo ranks
        gloo_rank(torch, int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return 0
    t0 = time.perf_counter()
    phase_device(torch)
    phase_build()
    kernel = phase_kernel(torch)
    hca = phase_hca_timeline(torch)
    phase_engines(torch)
    phase_gate(torch)
    kernel["launches"], hca["launches"], main_epoch_s = phase_main_path(torch)
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
    kernel["launches_barrier"], kernel["launches_barrier_batch"] = phase_barrier(torch)
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
    # the model zoo's serving path: every smoke architecture, then
    # gemma2-2b at full width; counts reset before each run they read
    t = time.perf_counter()
    reset_flash_counts()
    smoke = phase_model_smoke(torch)
    full = phase_gemma2_full(torch)
    flash["launches_serve"] = smoke["tf32x3"] + full["a"]["tf32x3"]
    flash_bf16["launches_serve"] = full["b"]["wgmma_bf16"]
    # each instance at the serving path's own shapes: f32 at 19a's global
    # layer (S 8192), bf16 at 19d's depth-8192 decode call
    f32_call = full["f32_calls"]["global"]
    flash.update(serve_ms=f32_call["ms"], serve_bound_ms=f32_call["bound_ms"],
                 serve_plain_ms=f32_call["plain_ms"], serve_library_ms=f32_call["library_ms"])
    flash_bf16.update(serve_ms=full["profile_c"]["flash"],
                      serve_bound_ms=full["profile_c"]["bound"],
                      serve_plain_ms=full["profile_c"]["plain"],
                      serve_library_ms=full["profile_c"]["sdpa"])
    require(flash["launches_serve"] > 0 and flash_bf16["launches_serve"] > 0,
            "the serving path launched both flash instances")
    print(f"# [18-19] {time.perf_counter() - t:.2f} s")
    # the training path: the train step runs the plain attention under
    # autograd, so it launches no flash kernel (counted, and held at 0)
    reset_flash_counts()
    flash["launches_train"] = flash_bf16["launches_train"] = phase_training(torch)
    # real collectives on torch.distributed; the fit's candidates sample
    # through sim_scan
    kernel["launches_collective_calibrate"] = phase_collectives(torch)
    # the same collectives inside fleet attempts
    phase_collective_fleet(torch)
    # sharding and launch analysis: bf16 flash on DTensors' local shards
    sharding = phase_sharding(torch)
    flash_bf16["launches_sharded"] = sharding["b"]["launches_sharded"]
    flash_bf16["launches_sharded_ranks"] = sharding["d"]["launches"]
    # the five reference walkthroughs through the port's public imports
    walk = phase_walkthroughs(torch)
    kernel["launches_examples"], flash["launches_examples"] = walk["sim_scan"], walk["tf32x3"]
    # the reference's numpy engines, their durations scanned on the card
    kernel["launches_batch"] = phase_numpy_engines(torch, main_epoch_s)
    print(json.dumps({"kernels": [kernel, flash, flash_bf16, ssd, ssd_bf16, hca]}))
    print(f"# total {time.perf_counter() - t0:.1f} s")
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

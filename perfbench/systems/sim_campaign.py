"""Simulated measurement campaigns of ``repro_torch``, the program measured.

The window runs whole campaigns back to back through the program's entry,
``repro_torch.campaign.Campaign.run``, on a ``TorchSimBackend`` built from
the configuration. The harness's own wrappers around the calls into each
layer take host spans and counts, annotate the device trace, and keep what
the timed path produced in the epochs the check works out again; the
program is not changed.
"""

from __future__ import annotations

import copy
import gc
import time
from collections import defaultdict

import numpy as np

from .. import check as checking
from ..check import NUMBERS  # noqa: F401  (the names this module's check compares)
from ..reference.engine import sync_of
from ..traffic import campaign


class Probes:
    """Host spans and counters at each layer's boundary, and the capture of
    the checked epochs. Installed for the window only."""

    def __init__(self, tracer):
        self.tracer = tracer
        self.span_s: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.scan_shapes: list[tuple[int, int]] = []
        self.captures: dict = {}
        self.plan = None
        self.epoch_of: dict[int, int] = {}
        self.topping = False
        self.patches: list = []

    def begin(self, plan) -> None:
        self.plan = plan
        self.epoch_of.clear()

    def _cap(self, net):
        e = self.epoch_of.get(id(net))
        if e is None or e not in self.plan.check_epochs:
            return None
        return self.captures.setdefault((self.plan, e), {"calls": [], "records": {}})

    def _timed(self, name, fn):
        with self.tracer.annotate(name):
            t = time.perf_counter()
            try:
                return fn()
            finally:
                self.span_s[name] += time.perf_counter() - t

    def install(self) -> None:
        from repro_torch import simengine
        from repro_torch.campaign import backends

        make_epoch = backends.TorchSimBackend.make_epoch
        top_up = backends.TorchSimBackend._top_up
        rwt = backends.run_windowed_torch
        rwe = backends.run_windowed_epochs_torch
        scan = simengine.sim_durations_scan

        def make_epoch_w(backend, epoch):
            ctx = self._timed("sync", lambda: make_epoch(backend, epoch))
            self.epoch_of[id(ctx.net)] = epoch
            cap = self._cap(ctx.net)
            if cap is not None:
                s = ctx.sync
                cap["sync"] = (np.array([m.slope for m in s.models]),
                               np.array([m.intercept for m in s.models]),
                               np.array(s.initial_times, dtype=np.float64))
            return ctx

        def top_up_w(backend, ctx, op, msize, nrep, runs):
            self.topping = True
            try:
                out = self._timed("topup", lambda: top_up(backend, ctx, op, msize, nrep, runs))
            finally:
                self.topping = False
            valid = sum(int(np.count_nonzero(r.errors == 0)) for r in runs)
            self.counts["valid"] += valid
            self.counts["empty"] += valid == 0
            self.counts["rows"] += sum(int(r.times.size) for r in runs)
            return out

        def keep(net, op, msize, nrep, run):
            cap = self._cap(net)
            if cap is not None:
                cap["calls"].append((op.name, int(msize), int(nrep),
                                     np.array(run.times), np.array(run.errors)))

        def rwt_w(net, sync, op, msize, nrep, *args, **kw):
            if self.topping:
                self.counts["topup_calls"] += 1
                run = rwt(net, sync, op, msize, nrep, *args, **kw)
            else:
                run = self._timed("engine", lambda: rwt(net, sync, op, msize, nrep, *args, **kw))
            keep(net, op, msize, nrep, run)
            return run

        def rwe_w(nets, syncs, ops, msize, nrep, *args, **kw):
            runs = self._timed("engine", lambda: rwe(nets, syncs, ops, msize, nrep, *args, **kw))
            for net, op, run in zip(nets, ops, runs):
                keep(net, op, msize, nrep, run)
            return runs

        def scan_w(eps, *args, **kw):
            if eps.shape[0] and eps.shape[1]:
                self.scan_shapes.append((int(eps.shape[0]), int(eps.shape[1])))
            return scan(eps, *args, **kw)

        def drift(fn):
            def wrapped(*args, **kw):
                return self._timed("drift", lambda: fn(*args, **kw))
            return wrapped

        self.patches = [
            (backends.TorchSimBackend, "make_epoch", make_epoch_w),
            (backends.TorchSimBackend, "_top_up", top_up_w),
            (backends, "run_windowed_torch", rwt_w),
            (backends, "run_windowed_epochs_torch", rwe_w),
            (simengine, "sim_durations_scan", scan_w),
            (simengine, "grow_paths_for_deadlines", drift(simengine.grow_paths_for_deadlines)),
            (simengine, "grow_paths_for_reads", drift(simengine.grow_paths_for_reads)),
            (simengine._DevicePaths, "upload", drift(simengine._DevicePaths.upload)),
        ]
        self.patches = [(obj, name, getattr(obj, name), new) for obj, name, new in self.patches]
        for obj, name, _, new in self.patches:
            setattr(obj, name, new)

    def remove(self) -> None:
        for obj, name, old, _ in reversed(self.patches):
            setattr(obj, name, old)
        self.patches = []


class System:
    """One cell's configuration and traffic on ``device``; ``seed`` draws
    every campaign of the run (:func:`perfbench.traffic.campaign`)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str, tracer):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.tracer = tracer
        self.probes = Probes(tracer)
        sync_of(cfg["sync"])        # a sync the reference lacks fails before the window

    @staticmethod
    def tiny(cfg: dict, traffic: dict) -> tuple[dict, dict]:
        """The cell cut to the CPU: 8 hosts, HCA at 20 x 5, two epochs a
        campaign, every epoch checked, and nrep 300 (drawn in buckets) or
        1100 (drawn at its own length) for mixes below and above 1024."""
        cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
        cfg.update(p=8, n_fitpts=20, n_exchanges=5)
        traffic.update(nrep=1100 if traffic["nrep"] >= 1024 else 300,
                       epochs_per_campaign=2, check_epochs_per_campaign=2)
        return cfg, traffic

    def backend(self, seed0: int):
        from repro_torch.campaign import TorchSimBackend

        cfg = self.cfg
        return TorchSimBackend(
            p=cfg["p"], seed0=seed0, per_op_kw={k: dict(v) for k, v in cfg["ops"].items()},
            sync_name=cfg["sync"],
            sync_kw=dict(n_fitpts=cfg["n_fitpts"], n_exchanges=cfg["n_exchanges"]),
            win_size=cfg["win_size_us"] * 1e-6, engine=cfg["engine"],
            clock_kw=dict(cfg["clocks"]), buffer_policy=cfg["buffer_policy"],
            epoch_isolation=cfg["epoch_isolation"], device=self.device)

    def _campaign(self, plan):
        from repro_torch.campaign import Campaign, CampaignSpec
        from repro_torch.core import ExperimentDesign, TestCase

        spec = CampaignSpec([TestCase(op, m) for op, m in plan.cases],
                            ExperimentDesign(n_launch_epochs=plan.epochs, nrep=plan.nrep,
                                             seed=plan.design_seed),
                            name=f"{self.traffic['name']}-{plan.index}")
        return Campaign(spec, self.backend(plan.seed0)).run()

    def setup(self) -> dict:
        """Build or load the kernel, then one window of each of the cell's
        cases at its ``(nrep, p)`` on one epoch from a fixed seed: every
        shape the window takes, warmed the same way in every run. Returns
        the seconds of each step."""
        import torch

        t = {"start": time.perf_counter()}
        if self.device == "cuda":
            from repro_torch.kernels.sim_scan.kernel import load_kernel

            load_kernel()
            torch.cuda.synchronize()
        t["kernel"] = time.perf_counter()
        backend = self.backend(seed0=0)
        ctx = backend.make_epoch(0)
        t["sync"] = time.perf_counter()
        for op, msize in campaign(self.traffic, 0, 0).cases:
            backend._run(ctx, ctx.op(op), msize, int(self.traffic["nrep"]))
        if self.device == "cuda":
            torch.cuda.synchronize()
        t["windows"] = time.perf_counter()
        keys = list(t)
        return {b: t[b] - t[a] for a, b in zip(keys, keys[1:])}

    def run(self, seconds: float) -> dict:
        """Campaigns back to back until the one in flight at ``seconds``
        completes; returns what the metric readers read."""
        import torch

        probes = self.probes
        dispatches = records = due = 0
        probes.install()
        try:
            with self.tracer.annotate("window"):
                t0 = time.perf_counter()
                k = 0
                while True:
                    plan = campaign(self.traffic, self.seed, k)
                    probes.begin(plan)
                    with self.tracer.annotate("campaign"):
                        res = self._campaign(plan)
                    dispatches += res.meta.get("dispatch", {}).get("n_dispatches", 0)
                    records += len(res.records)
                    due += len(plan.cases) * plan.epochs
                    for r in res.records:
                        if r.epoch in plan.check_epochs:
                            cap = probes.captures.setdefault((plan, r.epoch),
                                                             {"calls": [], "records": {}})
                            cap["records"][(r.case.op, int(r.case.msize))] = np.array(r.times)
                    del res
                    k += 1
                    if time.perf_counter() - t0 >= seconds:
                        break
                if self.device == "cuda":
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            probes.remove()
        c = probes.counts
        return dict(wall_s=wall, campaigns=k, records=records, due=due, dispatches=dispatches,
                    valid=c["valid"], empty=c["empty"], rows=c["rows"],
                    topup_calls=c["topup_calls"], span_s=dict(probes.span_s),
                    scan_shapes=list(probes.scan_shapes))

    def check(self) -> dict:
        """The comparison of the checked epochs with the plain reference,
        once the program's state is freed."""
        import torch

        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()
        return checking.check(self.cfg, self.probes.captures, self.device)

    @staticmethod
    def summary(run: dict, numbers: dict) -> dict:
        """The result line's ``run``: the window's counts and spans, the
        set-up's and the check's seconds, and how much the check compared."""
        out = {k: run[k] for k in ("wall_s", "campaigns", "records", "valid", "empty", "rows",
                                   "topup_calls", "dispatches", "span_s")}
        out.update(sim_scan_launches=len(run["scan_shapes"]), check_s=run["check_s"],
                   setup_parts=run["setup_parts"],
                   **{k: numbers[k] for k in ("epochs_checked", "windows_checked",
                                              "calls_checked", "flag_rows", "unpaired")})
        return out

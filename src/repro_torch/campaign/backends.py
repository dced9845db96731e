"""Measurement backends for the paper's method, on PyTorch.

The experimental design (Alg. 5/6) needs a fresh context per *launch
epoch*, a way to *measure* one test case, and the
:class:`~repro_torch.core.factors.FactorSet` describing everything held
fixed: the :class:`MeasurementBackend` protocol. :class:`TorchSimBackend`
is the calibrated cluster simulator (SimNet + window-based sync, §3.3/§4)
with its measurements on the device through :mod:`repro_torch.simengine`:
the port of the JAX package's ``SimBackend``, with the same dataclass
fields and knobs, so a store it writes carries the same factors.
:class:`TorchKernelBackend` measures real work instead: the hand-written
Hopper kernels against their plain PyTorch versions, the port of
``KernelBackend``. :class:`FunctionBackend` lifts a bare ``(epoch_factory,
measure)`` pair into the protocol.
"""

from __future__ import annotations

import inspect
import time
from dataclasses import dataclass, field
from typing import Any, Protocol, runtime_checkable

import numpy as np
import torch

from ..core.design import ExperimentDesign, TestCase, measure_adaptive
from ..core.factors import FactorSet, capture_torch_factors
from ..core.mpi_ops import make_composite_op
from ..core.opexpr import parse_opexpr
from ..core.runtime_meter import MeterConfig, TorchEpochContext
from ..core.simnet import ClockParams, SimNet
from ..core.sync import SYNC_CLASSES, make_sync
from ..kernels.ops import IMPLS, make_benchmark_op
from ..simengine import (resolve_device, run_windowed_epochs_torch,
                         run_windowed_torch)

__all__ = ["MeasurementBackend", "TorchSimBackend", "TorchKernelBackend",
           "FunctionBackend"]

_SYNC_KW = dict(n_fitpts=200, n_exchanges=40)


@runtime_checkable
class MeasurementBackend(Protocol):
    """What a measurement engine must provide to run the paper's method."""

    name: str

    def make_epoch(self, epoch: int) -> Any:
        """Fresh launch-epoch context (the §5.2 blocking factor)."""
        ...

    def measure(self, ctx: Any, case: TestCase, nrep: int) -> np.ndarray:
        """``nrep`` run-times [s] of ``case`` inside an epoch context."""
        ...

    def factors(self, design: ExperimentDesign) -> FactorSet:
        """The Table-4 factor set a campaign on this backend must carry."""
        ...

    def default_cases(self) -> list[TestCase]:
        """Cases to run when the campaign spec does not name any."""
        ...


def _design_factor_kw(design: ExperimentDesign) -> dict:
    return dict(
        n_launch_epochs=design.n_launch_epochs,
        nrep=0 if design.adaptive else design.nrep,
        nrep_min=design.nrep_min if design.adaptive else 0,
        nrep_max=(design.nrep_max or 0) if design.adaptive else 0,
        rel_ci_target=design.rel_ci_target if design.adaptive else 0.0,
        design_seed=design.seed,
        shuffle=design.shuffle,
    )


def _filter_sync_kw(sync_name: str, kw: dict) -> dict:
    """``sync_kw`` restricted to what the chosen algorithm's constructor
    accepts (fitpoint knobs mean nothing to skampi/netgauge)."""
    cls = SYNC_CLASSES.get(sync_name)
    if cls is None:          # unknown name: let make_sync raise its error
        return dict(kw)
    params = inspect.signature(cls.__init__).parameters
    if any(p.kind == p.VAR_KEYWORD for p in params.values()):
        return dict(kw)
    return {k: v for k, v in kw.items() if k in params}


def _apply_cold_buffers(op) -> None:
    """§5.8's cache factor: cold buffers forfeit the cost model's
    ``warm_cache_discount``, scaling every affine cost term by
    ``1 + discount`` (composites per constituent)."""
    if hasattr(op, "terms"):                 # SimCompositeOp
        for sub, _, _ in op.terms:
            _apply_cold_buffers(sub)
        return
    f = 1.0 + op.warm_cache_discount
    op.alpha *= f
    op.beta *= f
    op.gamma *= f


class _TorchSimEpoch:
    """One simulated launch epoch: a fresh cluster, synchronized clocks,
    the device its measurements run on, and a lazily-built cost model per
    op name."""

    def __init__(self, backend: "TorchSimBackend", epoch: int):
        self.backend = backend
        self.device = resolve_device(backend.device)
        self.net = SimNet(
            backend.p,
            clocks=ClockParams(**backend.clock_kw) if backend.clock_kw
            else None,
            seed=backend.seed0 + 1000 * epoch)
        sync_kw = _filter_sync_kw(backend.sync_name, backend.sync_kw)
        self.sync = make_sync(backend.sync_name,
                              **sync_kw).synchronize(self.net)
        self._ops: dict[str, Any] = {}

    def op(self, name: str):
        if name not in self._ops:
            # `name` may be a composite op expression (a guideline mock-up)
            op = make_composite_op(
                name, per_op_kw=self.backend.per_op_kw, **self.backend.op_kw)
            if self.backend.buffer_policy == "cold":
                _apply_cold_buffers(op)
            self._ops[name] = op
        return self._ops[name]


@dataclass
class TorchSimBackend:
    """Simulated cluster measured through window-based synchronization,
    with the measurement on a PyTorch device.

    The fields are those of the JAX package's ``SimBackend``: ``case.op``
    selects the collective's cost-model preset or a composite op
    expression, ``op_kw`` overrides every case, ``per_op_kw`` one named
    collective (a seeded mis-tuning), ``buffer_policy``, ``epoch_isolation``
    and ``dtype`` are sweepable factors, and window discards (START_LATE /
    TOOK_TOO_LONG) are topped up so a sample has ~``nrep`` valid
    observations. ``engine`` is ``"torch"``, the only engine here.

    ``device`` is where the measurements run: ``"cuda"`` (the default, the
    CUDA kernel) or ``"cpu"`` (the kernel's plain version). Constructing a
    CUDA backend on a machine without a GPU raises. ``fuse_epochs`` lets
    :meth:`measure_epochs` batch epochs; it is an execution knob, not a
    factor.
    """

    p: int = 8
    seed0: int = 0
    op_kw: dict = field(default_factory=dict)
    per_op_kw: dict = field(default_factory=dict)
    sync_name: str = "hca"
    sync_kw: dict = field(default_factory=lambda: dict(_SYNC_KW))
    win_size: float = 400e-6
    engine: str = "torch"
    clock_kw: dict = field(default_factory=dict)
    buffer_policy: str = "warm"        # warm | cold
    epoch_isolation: str = "process"   # process | none
    dtype: str = "float32"             # label-only (null factor by design)
    fuse_epochs: bool = True           # execution knob, not a factor
    device: str = "cuda"               # cuda | cpu
    name: str = "sim"
    _shared_epoch: Any = field(default=None, init=False, repr=False,
                               compare=False)

    def __post_init__(self):
        if self.engine != "torch":
            raise ValueError(f"TorchSimBackend: engine must be 'torch', got "
                             f"{self.engine!r}")
        resolve_device(self.device)

    def make_epoch(self, epoch: int) -> _TorchSimEpoch:
        if self.buffer_policy not in ("warm", "cold"):
            raise ValueError(f"TorchSimBackend: buffer_policy must be 'warm' "
                             f"or 'cold', got {self.buffer_policy!r}")
        if self.epoch_isolation == "none":
            # the launch-epoch anti-pattern: every "epoch" shares one
            # cluster, so AR(1) state, epoch bias and clock drift carry over
            if self._shared_epoch is None:
                self._shared_epoch = _TorchSimEpoch(self, 0)
            return self._shared_epoch
        if self.epoch_isolation != "process":
            raise ValueError(f"TorchSimBackend: epoch_isolation must be "
                             f"'process' or 'none', got "
                             f"{self.epoch_isolation!r}")
        return _TorchSimEpoch(self, epoch)

    def _top_up(self, ctx: _TorchSimEpoch, op, msize: int, nrep: int,
                runs: list) -> np.ndarray:
        """Top up window discards (at most 2 extra chunks) through the
        per-epoch engine; the valid times, or at most ``nrep`` raw times
        when nothing was valid (a window far too small)."""
        for _ in range(2):
            missing = nrep - sum(r.valid_times.size for r in runs)
            if missing <= 0:
                break
            runs.append(run_windowed_torch(ctx.net, ctx.sync, op, msize,
                                           missing, self.win_size,
                                           device=ctx.device))
        valid = np.concatenate([r.valid_times for r in runs])
        return valid if valid.size else np.concatenate(
            [r.times for r in runs])[:nrep]

    def measure(self, ctx: _TorchSimEpoch, case: TestCase,
                nrep: int) -> np.ndarray:
        op = ctx.op(case.op)
        run = run_windowed_torch(ctx.net, ctx.sync, op, case.msize, nrep,
                                 self.win_size, device=ctx.device)
        return self._top_up(ctx, op, case.msize, nrep, [run])

    def record_meta(self, ctx: _TorchSimEpoch, case: TestCase) -> dict:
        """Per-record provenance: the engine, the device it ran on, and
        whether the record came from a fused multi-epoch measurement."""
        return {"engine": self.engine, "device": str(ctx.device),
                "fused": False}

    def measure_epochs(self, work: dict, design: ExperimentDesign):
        """Fused campaign execution (the optional capability
        :class:`~repro_torch.campaign.Campaign` probes for).

        ``work`` maps ``epoch -> [TestCase, ...]`` in that epoch's shuffled
        case order. Epochs whose next pending case coincides are measured
        together by :func:`~repro_torch.simengine.run_windowed_epochs_torch`;
        each epoch's case order, host RNG stream, AR(1) carries and
        ``net.t`` writebacks are preserved. Window discards are topped up
        per epoch and adaptive nrep continues through
        :func:`~repro_torch.core.design.measure_adaptive`.

        Returns ``{(op, msize, epoch): (times, meta)}`` covering every case
        in ``work``, or ``None`` when fusing is off, the epochs share one
        cluster (``epoch_isolation="none"``) or the clocks walk
        (``clock_kw["rw_sigma"] > 0``, which the fused window cannot
        convert): the caller then measures per epoch.
        """
        if not self.fuse_epochs or self.epoch_isolation != "process":
            return None
        if self.clock_kw.get("rw_sigma", 0.0) > 0.0:
            return None
        if not work or all(not cases for cases in work.values()):
            return None
        ctxs = {e: self.make_epoch(e) for e in sorted(work)}
        nrep0 = design.nrep_min if design.adaptive else design.nrep
        pos = {e: 0 for e in sorted(work)}
        out: dict = {}
        while True:
            by_case: dict = {}
            for e in sorted(work):
                if pos[e] < len(work[e]):
                    c = work[e][pos[e]]
                    by_case.setdefault((c.op, c.msize), []).append(e)
            if not by_case:
                return out
            # most common next case first: maximal epoch fan-in per
            # dispatch without ever reordering within an epoch
            (op_name, msize), epochs = max(
                by_case.items(), key=lambda kv: (len(kv[1]), kv[0]))
            ops = [ctxs[e].op(op_name) for e in epochs]
            runs = run_windowed_epochs_torch(
                [ctxs[e].net for e in epochs], [ctxs[e].sync for e in epochs],
                ops, msize, nrep0, self.win_size, device=ctxs[epochs[0]].device)
            for i, e in enumerate(epochs):
                ctx, case = ctxs[e], work[e][pos[e]]
                times = self._top_up(ctx, ops[i], msize, nrep0, [runs[i]])
                if design.adaptive:
                    times, meta = measure_adaptive(self.measure, ctx, case,
                                                   design, initial=times)
                else:
                    meta = dict(nrep_used=int(times.size), converged=True)
                meta.update(self.record_meta(ctx, case))
                meta["fused"] = True
                out[(op_name, msize, e)] = (np.asarray(times, np.float64),
                                            meta)
                pos[e] += 1

    def factors(self, design: ExperimentDesign) -> FactorSet:
        return capture_torch_factors(
            device=self.device,
            backend="sim",
            device_kind="simnet",
            measurement_backend=self.name,
            sync_method=self.sync_name,
            window_size_us=self.win_size * 1e6,
            epoch_isolation=self.epoch_isolation,
            buffer_policy=self.buffer_policy,
            dtype=self.dtype,
            extra=(("p", self.p), ("seed0", self.seed0),
                   ("op_kw", tuple(sorted(self.op_kw.items()))),
                   ("per_op_kw", tuple(sorted(
                       (op, tuple(sorted(kw.items())))
                       for op, kw in self.per_op_kw.items()))),
                   ("sync_kw", tuple(sorted(self.sync_kw.items()))),
                   ("clock_kw", tuple(sorted(self.clock_kw.items()))),
                   ("engine", self.engine)),
            **_design_factor_kw(design),
        )

    def default_cases(self) -> list[TestCase]:
        return [TestCase("allreduce", m) for m in (256, 4096)]


# ---------------------------------------------------------------------------
# Kernel backend
# ---------------------------------------------------------------------------

def _sequence_calls(fns):
    """One timed callable running ``fns`` back to back — the composite
    mock-up region. The meter fences on the *returned* value only, so
    return the last term's output (each earlier launch is enqueued before
    it on the same stream and completes first)."""
    if len(fns) == 1:
        return fns[0]

    def composite():
        out = None
        for f in fns:
            out = f()
        return out

    return composite


@dataclass
class TorchKernelBackend:
    """The hand-written kernels vs. their plain versions as operations
    under test.

    ``case.op`` names the kernel (``flash_attention`` / ``ssd_scan``),
    ``case.msize`` is the sequence length. ``impl`` selects which side of
    the A/B comparison this backend measures: ``"cuda"`` (the kernel) or
    ``"ref"`` (its plain PyTorch version).

    A case may also be an op *expression* (:mod:`repro_torch.core.opexpr`):
    a ``#impl`` tag overrides the backend-level ``impl`` for that term, so
    the guideline ``"flash_attention#cuda" <= "flash_attention#ref"`` (the
    kernel must not lose to its own plain version) runs both sides in the
    *same* campaign, and ``+`` sequences kernels inside one timed region.
    ``@half`` has no meaning for single-device kernels and is rejected.

    The fields are those of the JAX package's ``KernelBackend``, with
    ``device`` in place of ``interpret``: ``"cuda"`` (the default) or
    ``"cpu"``, where each kernel's wrapper runs its plain version.
    Constructing a CUDA backend on a machine without a GPU raises.
    ``dtype`` (``"float32"``, the reference's, or ``"bfloat16"``) is the
    type the inputs are cast to after the draw; it is the factor set's
    ``dtype``.
    """

    impl: str = "cuda"                # cuda | ref
    batch: int = 1
    heads: int = 4
    kv_heads: int | None = None
    head_dim: int = 32
    state_dim: int = 16
    device: str = "cuda"              # cuda | cpu
    seed0: int = 0
    meter: MeterConfig = field(
        default_factory=lambda: MeterConfig(epoch_isolation="clear_caches",
                                            warmup=1))
    name: str = "kernel"
    dtype: str = "float32"            # float32 | bfloat16
    _last_epoch: Any = field(default=None, init=False, repr=False,
                             compare=False)
    _build_s: dict = field(default_factory=dict, init=False, repr=False,
                           compare=False)

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"TorchKernelBackend: impl must be one of "
                             f"{IMPLS}, got {self.impl!r}")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"TorchKernelBackend: dtype must be float32 or "
                             f"bfloat16, got {self.dtype!r}")
        resolve_device(self.device)

    def make_epoch(self, epoch: int) -> TorchEpochContext:
        def build(_epoch: int) -> dict:
            return {}

        ctx = TorchEpochContext(build, epoch, self.meter,
                                previous=self._last_epoch)
        self._last_epoch = ctx
        return ctx

    def _build_case(self, opexpr: str, msize: int, epoch: int):
        fns = []
        for t in parse_opexpr(opexpr):
            if t.procs == "half":
                raise ValueError("TorchKernelBackend: '@half' has no meaning "
                                 f"for single-device kernels (case {opexpr!r})")
            fns.append(make_benchmark_op(
                t.op, t.impl or self.impl, seq=t.msize(msize),
                batch=self.batch, heads=self.heads, kv_heads=self.kv_heads,
                head_dim=self.head_dim, state_dim=self.state_dim,
                dtype=getattr(torch, self.dtype), seed=self.seed0 + epoch,
                device=resolve_device(self.device)))
        return _sequence_calls(fns)

    def measure(self, ctx: TorchEpochContext, case: TestCase,
                nrep: int) -> np.ndarray:
        key = f"{case.op}@{case.msize}"
        if key not in ctx.callables:
            t0 = time.perf_counter()
            ctx.callables[key] = self._build_case(case.op, case.msize,
                                                  ctx.epoch)
            if resolve_device(self.device).type == "cuda":
                torch.cuda.synchronize()
            self._build_s[(ctx.epoch, key)] = time.perf_counter() - t0
        return ctx.measure(key, nrep)

    def record_meta(self, ctx: TorchEpochContext, case: TestCase) -> dict:
        """Per-record provenance: the device the case ran on, and the host
        seconds spent building its inputs (numpy draws and the copy to the
        device), outside the timed calls."""
        key = f"{case.op}@{case.msize}"
        return {"device": str(resolve_device(self.device)),
                "build_s": self._build_s.pop((ctx.epoch, key), 0.0)}

    def factors(self, design: ExperimentDesign) -> FactorSet:
        dev = resolve_device(self.device)
        return capture_torch_factors(
            device=dev,
            backend=dev.type,
            device_kind=(torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
            measurement_backend=self.name,
            dtype=self.dtype,
            sync_method="cuda_synchronize",
            epoch_isolation=self.meter.epoch_isolation,
            buffer_policy="cold" if self.meter.cold_buffers else "warm",
            extra=(("impl", self.impl), ("batch", self.batch),
                   ("heads", self.heads), ("kv_heads", self.kv_heads),
                   ("head_dim", self.head_dim),
                   ("state_dim", self.state_dim), ("seed0", self.seed0),
                   ("device", self.device)),
            **_design_factor_kw(design),
        )

    def default_cases(self) -> list[TestCase]:
        return [TestCase("flash_attention", s) for s in (64, 128)]


# ---------------------------------------------------------------------------
# Legacy-pair adapter
# ---------------------------------------------------------------------------

@dataclass
class FunctionBackend:
    """Lift a bare ``(epoch_factory, measure)`` pair into the
    :class:`MeasurementBackend` protocol (the JAX package's
    ``FunctionBackend``).

    The migration path off the deprecated legacy form of
    :func:`~repro_torch.core.design.run_design`: anything that could be
    expressed as the pair is expressible as this backend, and gains what
    the pair never had — a :class:`~repro_torch.core.factors.FactorSet` (so
    results can live in stores, sweeps and audits) and a ``default_cases``
    hook. ``name`` lands in the factor set's ``measurement_backend``
    field: give two different measurement functions two different names,
    or their campaigns will collide on one fingerprint. ``device`` is the
    device the functions run on, recorded in the factors as
    :class:`TorchKernelBackend` records it: ``"cuda"`` (the default) or
    ``"cpu"``. Constructing a CUDA backend on a machine without a GPU
    raises.
    """

    epoch_factory: Any                 # Callable[[int], Any]
    measure_fn: Any                    # Callable[[Any, TestCase, int], array]
    name: str = "function"
    cases: tuple = ()
    device: str = "cuda"               # cuda | cpu

    def __post_init__(self):
        resolve_device(self.device)

    def make_epoch(self, epoch: int) -> Any:
        return self.epoch_factory(epoch)

    def measure(self, ctx: Any, case: TestCase, nrep: int) -> np.ndarray:
        return np.asarray(self.measure_fn(ctx, case, nrep), np.float64)

    def factors(self, design: ExperimentDesign) -> FactorSet:
        dev = resolve_device(self.device)
        return capture_torch_factors(
            device=dev,
            backend=dev.type,
            device_kind=(torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
            measurement_backend=self.name,
            **_design_factor_kw(design),
        )

    def default_cases(self) -> list[TestCase]:
        return [TestCase(op, int(m)) for op, m in self.cases]

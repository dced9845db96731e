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
``KernelBackend``. :class:`TorchCollectiveBackend` measures real
collectives on ``torch.distributed`` across a group of rank processes,
the port of ``JaxBackend``. :class:`FunctionBackend` lifts a bare
``(epoch_factory, measure)`` pair into the protocol.
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
from ..core.window import ENGINES, resolve_engine, run_windowed
from ..kernels.ops import IMPLS, make_benchmark_op
from ..simengine import (resolve_device, run_windowed_epochs_torch,
                         run_windowed_torch)
from .ranks import COLLECTIVES, RankGroup, ensure_ranks, resolve_dist_backend

__all__ = ["MeasurementBackend", "TorchSimBackend", "TorchKernelBackend",
           "TorchCollectiveBackend", "FunctionBackend"]

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
    the device its measurements run on, the engine that runs them
    (resolved once per epoch, as the reference's ``_SimEpoch`` does), and
    a lazily-built cost model per op name."""

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
        self.engine = resolve_engine(backend.engine, self.net)
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
    observations.

    ``engine`` is ``"torch"`` (the default: the device engine, its draws on
    the device) or one of the reference's numpy engines, ``"auto"``,
    ``"batch"``, ``"batch_rw"`` or ``"scalar"`` (see
    :func:`~repro_torch.core.window.run_windowed`), which draw from the
    host's generator in the reference's order: ``"batch"`` or ``"auto"``
    on ``"cpu"`` reproduces the reference ``SimBackend``'s records bit for
    bit, and on ``"cuda"`` to rounding, the durations scanned by the
    ``sim_scan`` kernel. ``"scalar"`` runs on the host and wants
    ``device="cpu"``.

    ``device`` is where the measurements run: ``"cuda"`` (the default, the
    CUDA kernel) or ``"cpu"`` (the kernel's plain version, or numpy for
    the numpy engines). Constructing a CUDA backend on a machine without a
    GPU raises. ``fuse_epochs`` lets :meth:`measure_epochs` batch epochs
    of the ``"torch"`` engine; it is an execution knob, not a factor.
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
        if self.engine not in ENGINES:
            raise ValueError(f"TorchSimBackend: engine must be one of "
                             f"{ENGINES}, got {self.engine!r}")
        if self.engine == "scalar" and str(self.device) != "cpu":
            raise ValueError("TorchSimBackend: engine='scalar' runs on the "
                             "host only; pass device='cpu'")
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

    def _run(self, ctx: _TorchSimEpoch, op, msize: int,
             nrep: int):
        """One window of ``nrep`` calls through the epoch's engine."""
        if ctx.engine == "torch":
            return run_windowed_torch(ctx.net, ctx.sync, op, msize, nrep,
                                      self.win_size, device=ctx.device)
        return run_windowed(ctx.net, ctx.sync, op, msize, nrep, self.win_size,
                            device=ctx.device, engine=ctx.engine)

    def _top_up(self, ctx: _TorchSimEpoch, op, msize: int, nrep: int,
                runs: list) -> np.ndarray:
        """Top up window discards (at most 2 extra chunks) through the
        epoch's engine, as the reference's ``SimBackend.measure`` does; the
        valid times, or at most ``nrep`` raw times when nothing was valid
        (a window far too small)."""
        for _ in range(2):
            missing = nrep - sum(r.valid_times.size for r in runs)
            if missing <= 0:
                break
            runs.append(self._run(ctx, op, msize, missing))
        valid = np.concatenate([r.valid_times for r in runs])
        return valid if valid.size else np.concatenate(
            [r.times for r in runs])[:nrep]

    def measure(self, ctx: _TorchSimEpoch, case: TestCase,
                nrep: int) -> np.ndarray:
        op = ctx.op(case.op)
        return self._top_up(ctx, op, case.msize, nrep,
                            [self._run(ctx, op, case.msize, nrep)])

    def record_meta(self, ctx: _TorchSimEpoch, case: TestCase) -> dict:
        """Per-record provenance: the engine that ran (``"auto"``
        resolved), the device it ran on, and whether the record came from a
        fused multi-epoch measurement."""
        return {"engine": ctx.engine, "device": str(ctx.device),
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
        in ``work``, or ``None`` when the engine is not ``"torch"`` (the
        numpy engines measure per epoch, as the reference's do), fusing is
        off, the epochs share one cluster (``epoch_isolation="none"``) or
        the clocks walk (``clock_kw["rw_sigma"] > 0``, which the fused
        window cannot convert): the caller then measures per epoch.
        """
        if self.engine != "torch":
            return None
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
# Real collectives across rank processes
# ---------------------------------------------------------------------------

def collective_count(msize: int, n: int, itemsize: int) -> int:
    """Elements of each rank's payload for ``msize`` bytes over ``n``
    ranks: the reference's rule, at least ``n`` and padded to a multiple
    of ``n`` so that ``all_to_all`` splits evenly."""
    count = max(n, -(-int(msize) // itemsize))
    return -(-count // n) * n


class _CollectiveEpoch:
    """One launch epoch: the rank group it runs on, the cases warmed in
    it, and each case's per-rank local times until its record is made."""

    def __init__(self, group: RankGroup):
        self.group = group
        self.warmed: set[str] = set()
        self.local: dict[str, list] = {}


@dataclass
class TorchCollectiveBackend:
    """Real collectives on ``torch.distributed`` across ``n_ranks`` rank
    processes: the port of the JAX package's ``JaxBackend``.

    ``case.op`` is one of ``psum`` (``all_reduce`` with SUM),
    ``all_gather`` or ``all_to_all``, the reference's names, so a campaign
    spec written for ``JaxBackend`` runs unchanged; or an op expression of
    them: ``+`` runs its terms in sequence inside one timed region, and
    ``@half`` runs a term over the first ``max(2, n // 2)`` ranks (a
    subgroup from ``dist.new_group``). ``case.msize`` is the bytes of each
    rank's payload (:func:`collective_count` elements of ``dtype``); rank
    ``r``'s input holds ``r``. Every newly built case runs once, untimed,
    on every rank and is held exactly against
    :func:`~repro_torch.campaign.ranks.expected_collective`.

    **Timing (``sync_method="barrier+max"``).** The reference times one
    host call around ``pmap`` with ``block_until_ready``: the wall from
    the launch until the slowest device is done. Across processes each
    repetition is: every rank of the group meets at ``dist.barrier()``;
    each rank reads ``perf_counter_ns()``, runs its terms, fences with
    ``torch.cuda.synchronize()`` on CUDA and reads its clock again (a rank
    outside every term records 0); the measurement is the maximum of the
    ranks' local times. This is the barrier scheme of the paper's §4.6,
    chosen because it is what the reference's timing amounts to, not
    because it is the paper's best scheme. ``meter.warmup`` untimed
    repetitions run once per case per epoch.

    **Launch epochs.** Under ``meter.epoch_isolation="clear_caches"``
    each launch epoch runs on a fresh :class:`RankGroup`, new processes
    and a new process group (the paper's fresh ``mpirun``), after the
    previous epoch's group is closed; under ``"none"`` one group serves
    every epoch. :meth:`close` (or ``with``) ends the last group.

    ``device`` is ``"cuda"`` (the default) or ``"cpu"``; ``dist_backend``
    ``None`` means NCCL on CUDA and gloo on the CPU, and gloo with CUDA
    tensors runs when asked for by name. ``n_ranks=None`` means one rank
    per CUDA device; on the CPU it must be given. What cannot run raises
    when the backend is made (:func:`~repro_torch.campaign.ranks.ensure_ranks`):
    NCCL with more ranks than devices, CUDA without a card.
    ``meter.cold_buffers`` raises: the reference records ``"cold"`` in
    its factors without applying it, and the port applies nothing it
    cannot. ``timeout_s`` bounds each wait for the ranks.
    """

    ops: tuple = COLLECTIVES
    n_ranks: int | None = None        # None = one rank per CUDA device
    device: str = "cuda"              # cuda | cpu
    dist_backend: str | None = None   # nccl | gloo | None (by device)
    meter: MeterConfig = field(
        default_factory=lambda: MeterConfig(epoch_isolation="clear_caches"))
    dtype: str = "float32"
    name: str = "torch-collective"
    timeout_s: float = 60.0
    _group: Any = field(default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        dev = resolve_device(self.device)
        if self.n_ranks is None and dev.type != "cuda":
            raise ValueError("TorchCollectiveBackend: n_ranks must be given "
                             "on the CPU")
        ensure_ranks(self._n(), self.device, self.dist_backend)
        if self.meter.cold_buffers:
            raise ValueError(
                "TorchCollectiveBackend: cold_buffers is not supported (the "
                "reference records it without applying it)")
        if self.meter.epoch_isolation not in ("clear_caches", "none"):
            raise ValueError(f"TorchCollectiveBackend: epoch_isolation must "
                             f"be 'clear_caches' or 'none', got "
                             f"{self.meter.epoch_isolation!r}")
        if not isinstance(getattr(torch, self.dtype, None), torch.dtype) \
                or not getattr(torch, self.dtype).is_floating_point:
            raise ValueError(f"TorchCollectiveBackend: dtype must name a "
                             f"floating torch dtype, got {self.dtype!r}")

    def _n(self) -> int:
        return self.n_ranks or torch.cuda.device_count()

    def _build_case(self, opexpr: str, msize: int) -> list:
        """The case's terms as ``(op, count, group_size)``, parsed here,
        before anything is sent to a rank, with the reference's errors."""
        n = self._n()
        itemsize = getattr(torch, self.dtype).itemsize
        terms = []
        for t in parse_opexpr(opexpr):
            if t.impl is not None:
                raise ValueError(f"TorchCollectiveBackend: '#{t.impl}' "
                                 f"implementation tags are not supported "
                                 f"(case {opexpr!r})")
            if t.op not in COLLECTIVES:
                raise ValueError(f"TorchCollectiveBackend: unknown collective "
                                 f"{t.op!r}; one of {self.ops}")
            tn = max(2, n // 2) if t.procs == "half" else n
            if tn > n:
                raise ValueError(f"TorchCollectiveBackend: '@half' needs at "
                                 f"least 2 ranks, have {n} (case {opexpr!r})")
            terms.append((t.op, collective_count(t.msize(msize), tn, itemsize),
                          tn))
        return terms

    def make_epoch(self, epoch: int) -> _CollectiveEpoch:
        if self.meter.epoch_isolation == "clear_caches":
            self.close()
        if self._group is None:
            self._group = RankGroup(self._n(), self.device, self.dist_backend,
                                    self.timeout_s)
        return _CollectiveEpoch(self._group)

    def _ensure_built(self, ctx: _CollectiveEpoch, case: TestCase) -> str:
        key = f"{case.op}@{case.msize}"
        if key not in ctx.group.built:
            ctx.group.build(key, self._build_case(case.op, case.msize),
                            self.dtype)
        return key

    def measure(self, ctx: _CollectiveEpoch, case: TestCase,
                nrep: int) -> np.ndarray:
        key = self._ensure_built(ctx, case)
        warmup = 0 if key in ctx.warmed else self.meter.warmup
        ctx.warmed.add(key)
        local = ctx.group.measure(key, nrep, warmup)
        ctx.local.setdefault(key, []).append(local)
        return local.max(axis=0)

    def outputs(self, ctx: _CollectiveEpoch, case: TestCase) -> list:
        """Run ``case`` once untimed: per rank, each term's output in the
        reference's per-device shape (``None`` where the rank is outside
        the term)."""
        return ctx.group.check(self._ensure_built(ctx, case))

    def record_meta(self, ctx: _CollectiveEpoch, case: TestCase) -> dict:
        """Per-record provenance: the device and process-group backend,
        the ranks' process ids, the group's start-up [s] (spawn to first
        barrier), and the rank skew [s], the median over repetitions of
        the spread of the local times over the ranks that ran."""
        local = np.concatenate(ctx.local.pop(f"{case.op}@{case.msize}"),
                               axis=1)
        ran = local[np.any(local > 0, axis=1)]
        return {"device": str(resolve_device(self.device)),
                "dist_backend": ctx.group.dist_backend,
                "rank_pids": list(ctx.group.pids),
                "group_start_s": ctx.group.startup_s,
                "rank_skew_s": float(np.median(ran.max(0) - ran.min(0)))}

    def close(self) -> None:
        """End the current rank group, if any."""
        if self._group is not None:
            self._group.close()
            self._group = None

    def __enter__(self) -> "TorchCollectiveBackend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def factors(self, design: ExperimentDesign) -> FactorSet:
        dev = resolve_device(self.device)
        return capture_torch_factors(
            device=dev,
            backend=dev.type,
            device_kind=(torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
            measurement_backend=self.name,
            sync_method="barrier+max",
            mesh_shape=(self._n(),),
            mesh_axes=("i",),
            epoch_isolation=self.meter.epoch_isolation,
            buffer_policy="warm",
            dtype=self.dtype,
            extra=(("ops", tuple(self.ops)), ("warmup", self.meter.warmup),
                   ("dist_backend",
                    resolve_dist_backend(dev, self.dist_backend))),
            **_design_factor_kw(design),
        )

    def default_cases(self) -> list[TestCase]:
        return [TestCase(op, m) for op in self.ops for m in (1 << 10, 1 << 16)]


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

"""Experimental-factor registry (§5.9, Table 4).

:class:`FactorSet` has the fields of the JAX package's
``repro.core.factors.FactorSet`` and the same fingerprint, so a store the
port writes is keyed, loaded and compared like one the reference writes.
:func:`capture_torch_factors` records the PyTorch environment: the JAX
fields stay empty, ``matmul_precision`` is torch's float32 matmul
precision, and the torch version, CUDA version, compute capability, device
name and both TF32 switches go in ``extra``.

:class:`FactorAxis`, :class:`GridCell` and :class:`FactorGrid` make the
factors enumerable (the reference's executable Table 4): a grid cell
materializes into a ``(backend, design)`` pair by dataclass replacement,
and its fingerprint comes from the backend's own ``factors()``.
:func:`assert_comparable` refuses to compare factor sets that differ
beyond the factor under test.
"""

from __future__ import annotations

import hashlib
import json
import platform
from dataclasses import asdict, dataclass, field, replace

import numpy as np

import torch

__all__ = [
    "FactorSet",
    "capture_torch_factors",
    "assert_comparable",
    "FactorAxis",
    "GridCell",
    "FactorGrid",
]


@dataclass(frozen=True)
class FactorSet:
    backend: str = "cpu"
    device_kind: str = "cpu"
    jax_version: str = ""
    mesh_shape: tuple = ()
    mesh_axes: tuple = ()
    sync_method: str = "barrier"
    window_size_us: float = 0.0
    n_launch_epochs: int = 1
    nrep: int = 0
    # adaptive-nrep stopping contract (0/0 = fixed nrep)
    nrep_min: int = 0
    nrep_max: int = 0
    rel_ci_target: float = 0.0
    # design identity
    design_seed: int = 0
    shuffle: bool = True
    measurement_backend: str = ""      # sim | "" (ad hoc)
    epoch_isolation: str = "process"   # process | none
    xla_flags: str = ""
    matmul_precision: str = "default"
    donate_buffers: bool = False
    remat_policy: str = "none"
    buffer_policy: str = "warm"        # warm | cold (cache factor, §5.8)
    dtype: str = "float32"
    host: str = field(default_factory=platform.node)
    extra: tuple = ()

    def to_dict(self) -> dict:
        return asdict(self)

    def fingerprint(self, exclude: tuple[str, ...] = ()) -> str:
        d = {k: v for k, v in self.to_dict().items() if k not in exclude and k != "host"}
        blob = json.dumps(d, sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


def capture_torch_factors(device="cuda", **overrides) -> FactorSet:
    """A :class:`FactorSet` for work run by PyTorch on ``device`` (the card
    unless the caller passes ``"cpu"``, as every entry point of the port).

    Touches no JAX: ``jax_version`` and ``xla_flags`` are empty.
    ``matmul_precision`` is ``torch.get_float32_matmul_precision()``
    unless the caller overrides it: under ``"high"`` or ``"medium"`` a
    float32 product (the ``#ref`` side of an f32 kernel A/B) may run in
    TF32, so the setting is a factor. ``extra`` is ``overrides["extra"]``
    followed by the torch version, the CUDA version torch was built with,
    the device's compute capability and name (empty capability and
    ``"cpu"`` for the CPU), and the TF32 switches of cuBLAS and cuDNN.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        major, minor = torch.cuda.get_device_capability(dev)
        capability = f"{major}.{minor}"
        name = torch.cuda.get_device_name(dev)
    else:
        capability, name = "", dev.type
    env = (("torch", torch.__version__), ("cuda", torch.version.cuda or ""),
           ("capability", capability), ("device_name", name),
           ("allow_tf32_matmul", torch.backends.cuda.matmul.allow_tf32),
           ("allow_tf32_cudnn", torch.backends.cudnn.allow_tf32))
    base = dict(jax_version="", xla_flags="",
                matmul_precision=torch.get_float32_matmul_precision())
    base.update(overrides)
    base["extra"] = tuple(base.get("extra", ())) + env
    return FactorSet(**base)


def assert_comparable(a: FactorSet, b: FactorSet, factor_under_test: tuple[str, ...]) -> None:
    """Refuse to statistically compare results whose factor sets differ in
    anything but the declared factor(s) under test (§5.9's conclusion)."""
    fa = a.fingerprint(exclude=factor_under_test)
    fb = b.fingerprint(exclude=factor_under_test)
    if fa != fb:
        da, db = a.to_dict(), b.to_dict()
        diffs = {
            k: (da[k], db[k])
            for k in da
            if k not in factor_under_test and k != "host" and da[k] != db[k]
        }
        raise ValueError(
            "factor sets differ beyond the factor under test "
            f"{factor_under_test}: {diffs} — results are not comparable"
        )


# ---------------------------------------------------------------------------
# Enumerable factor axes (the executable Table 4)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FactorAxis:
    """One experimental factor as an *enumerable axis*: a name and the
    levels it is swept over.

    Recording a factor (:class:`FactorSet`) says what was held fixed;
    an axis says how to *vary* it. Each level is a concrete value for one
    constructor field of the measurement backend (``target="backend"``) or
    of the :class:`~repro_torch.core.design.ExperimentDesign`
    (``target="design"``) — so a grid cell materializes into runnable
    objects by plain dataclass replacement, and the resulting
    :class:`FactorSet` carries the level through the backend's own
    ``factors()`` plumbing (nothing bypasses the fingerprint).

    ``key`` is the constructor field the levels are assigned to (default:
    the axis name). ``labels`` are the display names used in sweep
    manifests and factor-impact reports; they default to ``str(level)``,
    and must be given explicitly when levels are unwieldy values (a
    ``per_op_kw`` dict, a window size in seconds).
    """

    name: str
    levels: tuple
    target: str = "backend"          # backend | design
    key: str | None = None
    labels: tuple = ()

    def __post_init__(self):
        if self.target not in ("backend", "design"):
            raise ValueError(f"axis {self.name!r}: target must be 'backend' "
                             f"or 'design', got {self.target!r}")
        if len(self.levels) < 2:
            raise ValueError(f"axis {self.name!r}: a factor axis needs at "
                             f"least 2 levels, got {len(self.levels)}")
        if self.labels and len(self.labels) != len(self.levels):
            raise ValueError(f"axis {self.name!r}: {len(self.labels)} labels "
                             f"for {len(self.levels)} levels")
        labels = self.labels or tuple(str(v) for v in self.levels)
        if len(set(labels)) != len(labels):
            raise ValueError(f"axis {self.name!r}: level labels must be "
                             f"distinct, got {labels}")

    def label(self, i: int) -> str:
        return self.labels[i] if self.labels else str(self.levels[i])

    def kwarg(self) -> str:
        return self.key or self.name


@dataclass(frozen=True)
class GridCell:
    """One point of a factor grid: a concrete level choice per axis.

    ``index`` is the cell's position in the *full* cross-product (row-major
    over the axes), stable under fractional sampling — it is the resume key
    of a sharded sweep. ``materialize`` turns the cell into a runnable
    ``(backend, design)`` pair; the cell's :class:`FactorSet` then comes
    from ``backend.factors(design)``, never from the grid itself, so a
    level that the backend fails to surface in its factors is caught as a
    fingerprint collision rather than silently merged.
    """

    index: int
    axes: tuple[FactorAxis, ...]
    coords: tuple[int, ...]          # level index per axis

    def levels(self) -> dict[str, str]:
        """Axis name -> level *label* (the report/manifest view)."""
        return {ax.name: ax.label(i) for ax, i in zip(self.axes, self.coords)}

    def overrides(self, target: str) -> dict:
        return {ax.kwarg(): ax.levels[i]
                for ax, i in zip(self.axes, self.coords) if ax.target == target}

    def materialize(self, base_backend, base_design):
        """``(backend, design)`` with this cell's levels applied via
        dataclass replacement."""
        backend_kw = self.overrides("backend")
        design_kw = self.overrides("design")
        try:
            backend = replace(base_backend, **backend_kw) if backend_kw \
                else base_backend
        except TypeError as e:
            raise TypeError(
                f"grid cell {self.levels()}: backend "
                f"{type(base_backend).__name__} does not accept "
                f"{sorted(backend_kw)} — check the axis 'key' fields"
            ) from e
        try:
            design = replace(base_design, **design_kw) if design_kw \
                else base_design
        except TypeError as e:
            raise TypeError(
                f"grid cell {self.levels()}: ExperimentDesign does not "
                f"accept {sorted(design_kw)} — check the axis 'key' fields"
            ) from e
        return backend, design

    def factors(self, base_backend, base_design) -> FactorSet:
        backend, design = self.materialize(base_backend, base_design)
        return backend.factors(design)


@dataclass(frozen=True)
class FactorGrid:
    """An executable experiment space: the cross-product of factor axes.

    ``fraction < 1`` selects a deterministic random subset of the full
    cross-product (seeded by ``design_seed``) — the fractional-design
    escape hatch for factor spaces too large to run exhaustively. Cell
    indices always refer to the full product, so growing ``fraction``
    later only *adds* cells and a persisted sweep keeps resuming.
    """

    axes: tuple[FactorAxis, ...]
    design_seed: int = 0
    fraction: float = 1.0

    def __post_init__(self):
        if not self.axes:
            raise ValueError("FactorGrid needs at least one axis")
        names = [ax.name for ax in self.axes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate axis names: {names}")
        keys = [(ax.target, ax.kwarg()) for ax in self.axes]
        if len(set(keys)) != len(keys):
            raise ValueError(f"two axes drive the same constructor field: "
                             f"{keys}")
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got "
                             f"{self.fraction}")
        object.__setattr__(self, "axes", tuple(self.axes))

    def n_full(self) -> int:
        n = 1
        for ax in self.axes:
            n *= len(ax.levels)
        return n

    def __len__(self) -> int:
        return len(self.cell_indices())

    def cell_indices(self) -> list[int]:
        """Indices (into the full cross-product) of the cells this grid
        actually runs — all of them, or the seeded fractional sample.

        The sample is a prefix of one seed-keyed permutation, so samples
        *nest*: every cell of ``fraction=f1`` is also a cell of any
        ``fraction=f2 >= f1`` at the same ``design_seed`` — which is what
        lets a persisted fractional sweep keep resuming after the
        fraction is raised."""
        n = self.n_full()
        if self.fraction >= 1.0:
            return list(range(n))
        n_pick = max(1, int(round(self.fraction * n)))
        rng = np.random.default_rng(self.design_seed)
        return sorted(int(i) for i in rng.permutation(n)[:n_pick])

    def cell(self, index: int) -> GridCell:
        """The cell at a full-cross-product index (row-major over axes)."""
        sizes = [len(ax.levels) for ax in self.axes]
        if not 0 <= index < self.n_full():
            raise IndexError(f"cell index {index} out of range "
                             f"[0, {self.n_full()})")
        coords, rem = [], index
        for size in reversed(sizes):
            coords.append(rem % size)
            rem //= size
        return GridCell(index=index, axes=self.axes,
                        coords=tuple(reversed(coords)))

    def cells(self) -> list[GridCell]:
        return [self.cell(i) for i in self.cell_indices()]

    def manifest(self) -> dict:
        """The JSON-able identity of this grid (sweep-store manifests)."""
        return dict(
            axes=[dict(name=ax.name, target=ax.target, key=ax.kwarg(),
                       labels=[ax.label(i) for i in range(len(ax.levels))])
                  for ax in self.axes],
            design_seed=self.design_seed,
            fraction=self.fraction,
            n_full=self.n_full(),
        )

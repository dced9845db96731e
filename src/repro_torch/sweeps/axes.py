"""Stock factor axes for the simulated MPI library.

The executable version of the paper's Table 4: each axis names one
experimental factor and the levels a sweep varies it over, mapped onto a
:class:`~repro_torch.campaign.TorchSimBackend` /
:class:`~repro_torch.core.design.ExperimentDesign` constructor field. Five
of the stock axes genuinely change what is measured (synchronization
method, window size, buffer policy, epoch isolation, randomization);
``dtype`` (a pure label in the simulator) and ``engine`` are deliberate
*null factors*, so the factor-impact analysis always carries its own
negative controls. The ``tuning`` axis seeds the one defect the whole
pipeline exists to find: a single mis-tuned collective
(``TorchSimBackend.per_op_kw``), which must come out as the top-ranked
main effect of :func:`repro_torch.sweeps.effects.main_effects`.

**The engine axis.** The reference sweeps its window engines (numpy
against JAX) as a null factor. The port's numpy engines reproduce the
reference's draws, not a second draw of them, so the axis keeps its name
and its role and varies where the port's device engine (``"torch"``)
runs. Its levels are ``device="cuda"`` (label ``kernel``: the
hand-written ``sim_scan`` kernel on the card) and ``device="cpu"``
(label ``plain``: the kernel's plain PyTorch version). Their draws differ
(Philox on the card, Mersenne Twister on the CPU) but not their
distribution, so an ``engine`` main effect flags a kernel-port bug, as in
the reference. The two levels get distinct fingerprints because
:func:`~repro_torch.core.factors.capture_torch_factors` records the
device's name and capability. The axis is not in
:data:`DEFAULT_SWEEP_AXES`, and its ``kernel`` level needs a card.
"""

from __future__ import annotations

from ..campaign import SweepSpec, TorchSimBackend
from ..core.design import ExperimentDesign, TestCase
from ..core.factors import FactorAxis, FactorGrid

__all__ = [
    "MISTUNED_PER_OP_KW",
    "DEFAULT_SWEEP_AXES",
    "sim_axes",
    "default_sim_sweep",
]

#: The seeded defect: allreduce with a 4x latency term and a 3x fixed
#: overhead — the "one collective shipped with a bad algorithm switch"
#: scenario of the guideline papers, expressed as a sweepable level.
MISTUNED_PER_OP_KW: dict = {"allreduce": dict(alpha=12e-6, gamma=6e-6)}

#: Axes of the default sweep: the injected factor, one real factor of
#: each flavor (algorithmic, measurement-mechanical), and the null label.
DEFAULT_SWEEP_AXES: tuple[str, ...] = ("tuning", "sync_method", "window_us",
                                       "dtype")


def _stock_axes() -> tuple[FactorAxis, ...]:
    return (
        FactorAxis("tuning", ({}, MISTUNED_PER_OP_KW), key="per_op_kw",
                   labels=("stock", "mistuned")),
        FactorAxis("sync_method", ("hca", "skampi"), key="sync_name"),
        FactorAxis("window_us", (400e-6, 50e-6), key="win_size",
                   labels=("400", "50")),
        FactorAxis("buffer_policy", ("warm", "cold")),
        FactorAxis("epoch_isolation", ("process", "none")),
        FactorAxis("shuffle", (True, False), target="design"),
        FactorAxis("dtype", ("float32", "float64")),
        # Like dtype, a by-design null factor: the kernel on the card and
        # its plain version on the CPU are statistically equivalent, so an
        # "engine" main effect flags a kernel-port bug, not a real factor.
        FactorAxis("engine", ("cuda", "cpu"), key="device",
                   labels=("kernel", "plain")),
    )


def sim_axes(include=None) -> tuple[FactorAxis, ...]:
    """The stock simulator axes, optionally restricted (and ordered) by
    name. Unknown names raise with the available set — a sweep that
    silently dropped an axis would report on a different factor space than
    the one asked for."""
    axes = _stock_axes()
    if include is None:
        return axes
    by_name = {ax.name: ax for ax in axes}
    include = list(include)
    unknown = sorted(set(include) - set(by_name))
    if unknown:
        raise ValueError(f"unknown factor axes {unknown}; "
                         f"available: {sorted(by_name)}")
    return tuple(by_name[n] for n in include)


def default_sim_sweep(seed: int = 0, axes=None, msizes=(512, 4096),
                      n_launch_epochs: int = 6, nrep: int = 40,
                      p: int = 8, device: str = "cuda"
                      ) -> tuple[SweepSpec, TorchSimBackend]:
    """The stock sim factor sweep: a grid over ``axes`` (default
    :data:`DEFAULT_SWEEP_AXES`) measured on allreduce at ``msizes``, on
    ``device`` (the card unless the caller passes ``"cpu"``).

    The base backend uses a light fitpoint budget (a sweep pays the sync
    cost once per cell per epoch) and a nonzero launch-epoch bias so the
    ``epoch_isolation`` axis has something to bias.
    """
    grid = FactorGrid(sim_axes(axes or DEFAULT_SWEEP_AXES), design_seed=seed)
    backend = TorchSimBackend(p=p, seed0=seed,
                              sync_kw=dict(n_fitpts=60, n_exchanges=20),
                              op_kw=dict(epoch_bias_sigma=0.03),
                              device=device)
    spec = SweepSpec(
        grid=grid,
        cases=[TestCase("allreduce", m) for m in msizes],
        design=ExperimentDesign(n_launch_epochs=n_launch_epochs, nrep=nrep,
                                seed=seed),
        name="factor-sweep",
    )
    return spec, backend

"""repro_torch.core — the host side of the paper's method, in numpy.

The simulated cluster, clocks and sync algorithms, cost models, op
expressions, the experimental design, factor records, statistics and
comparisons, copied from the JAX package's ``repro.core`` so that a seed
draws the same host state in both packages. The device side is
:mod:`repro_torch.simengine`, and :mod:`.runtime_meter` times real work
on the device.
"""

from .clocks import LinearModel, SimClock, derive_stream, linear_fit
from .compare import (ComparisonRow, compare_cases, compare_tables,
                      format_comparison, naive_comparison)
from .design import (
    NREP_SPENT,
    EpochSummary,
    ExperimentDesign,
    MeasurementRecord,
    ResultTable,
    TestCase,
    analyze_records,
    case_orders,
    measure_adaptive,
    measure_case,
)
from .factors import FactorSet, capture_torch_factors
from .mpi_ops import SimCollective, SimCompositeOp, make_composite_op, make_op
from .opexpr import OpTerm, is_composite, parse_opexpr
from .simnet import ClockParams, NetParams, SimNet
from .runtime_meter import (MeterConfig, TorchEpochContext, make_torch_measure,
                            timed_calls)
from .stats import (holm_bonferroni, relative_ci_width, significance_stars,
                    tukey_filter, wilcoxon_rank_sum)
from .sync import ALGORITHMS, SYNC_CLASSES, SyncResult, make_sync
from .window import START_LATE, TOOK_TOO_LONG, WindowRun

__all__ = [
    "SimClock", "LinearModel", "derive_stream", "linear_fit",
    "SimNet", "NetParams", "ClockParams",
    "SimCollective", "SimCompositeOp", "make_op", "make_composite_op",
    "OpTerm", "parse_opexpr", "is_composite",
    "ALGORITHMS", "SYNC_CLASSES", "SyncResult", "make_sync",
    "WindowRun", "START_LATE", "TOOK_TOO_LONG",
    "tukey_filter", "relative_ci_width", "wilcoxon_rank_sum",
    "holm_bonferroni", "significance_stars",
    "ComparisonRow", "compare_tables", "compare_cases", "naive_comparison",
    "format_comparison",
    "MeterConfig", "TorchEpochContext", "timed_calls", "make_torch_measure",
    "ExperimentDesign", "TestCase", "MeasurementRecord", "EpochSummary",
    "ResultTable", "analyze_records", "case_orders", "measure_case",
    "measure_adaptive", "NREP_SPENT",
    "FactorSet", "capture_torch_factors",
]

"""repro_torch.core — the host side of the paper's method, in numpy.

The simulated cluster, clocks (random walks included) and sync
algorithms with their probes, cost models, op expressions, the
experimental design with its epoch fan-out, factor records, statistics
and comparisons, copied from the JAX package's ``repro.core`` so that a
seed draws the same host state in both packages. The device side is
:mod:`repro_torch.simengine` (the window scheme that :func:`run_windowed`
runs, and the durations the barrier scheme of :mod:`.timing` draws), and
:mod:`.runtime_meter` times real work on the device.
"""

from .clocks import (IDENTITY_MODEL, AdjustedClock, Clock, DriftPath,
                     LinearModel, PerfClock, SimClock, derive_stream,
                     linear_fit)
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
    map_parallel,
    measure_adaptive,
    measure_case,
    run_design,
)
from .factors import (FactorAxis, FactorGrid, FactorSet, GridCell,
                      assert_comparable, capture_torch_factors)
from .mpi_ops import (OP_LIBRARY, SimCollective, SimCompositeOp,
                      make_composite_op, make_op)
from .opexpr import OpTerm, format_opexpr, is_composite, parse_opexpr
from .retry import RetryBudgetExceeded, RetryPolicy, retry_call
from .simnet import ClockParams, NetParams, PingPongSample, SimNet
from .runtime_meter import (MeterConfig, TorchEpochContext, make_torch_measure,
                            timed_calls)
from .stats import (TostResult, autocorr_significant_lags, autocorrelation,
                    bootstrap_ci, chi2_sf, cliffs_delta,
                    coefficient_of_variation, holm_bonferroni, jarque_bera,
                    kruskal_wallis, mean_confidence_interval, normal_ppf,
                    relative_ci_width, significance_stars, t_ppf,
                    tost_wilcoxon, tukey_filter, wilcoxon_rank_sum)
from .sync import (ALGORITHMS, SYNC_CLASSES, HCASync, JKSync, NetgaugeSync,
                   SkampiSync, SyncResult, make_sync, probe_offsets,
                   true_offsets)
from .timing import BarrierRun, probe_barrier_skew, run_barrier_timed
from .window import START_LATE, TOOK_TOO_LONG, WindowRun, run_windowed

__all__ = [
    "Clock", "PerfClock", "SimClock", "AdjustedClock", "DriftPath",
    "LinearModel", "IDENTITY_MODEL", "derive_stream", "linear_fit",
    "SimNet", "NetParams", "ClockParams", "PingPongSample",
    "SimCollective", "SimCompositeOp", "make_op", "make_composite_op",
    "OP_LIBRARY",
    "OpTerm", "parse_opexpr", "is_composite", "format_opexpr",
    "ALGORITHMS", "SYNC_CLASSES", "SyncResult", "make_sync",
    "SkampiSync", "NetgaugeSync", "JKSync", "HCASync",
    "probe_offsets", "true_offsets",
    "WindowRun", "START_LATE", "TOOK_TOO_LONG", "run_windowed",
    "run_barrier_timed", "BarrierRun", "probe_barrier_skew",
    "tukey_filter", "relative_ci_width", "wilcoxon_rank_sum",
    "holm_bonferroni", "significance_stars", "chi2_sf", "kruskal_wallis",
    "cliffs_delta", "mean_confidence_interval", "jarque_bera",
    "autocorrelation", "autocorr_significant_lags",
    "coefficient_of_variation", "normal_ppf", "t_ppf", "TostResult",
    "tost_wilcoxon", "bootstrap_ci",
    "ComparisonRow", "compare_tables", "compare_cases", "naive_comparison",
    "format_comparison",
    "MeterConfig", "TorchEpochContext", "timed_calls", "make_torch_measure",
    "ExperimentDesign", "TestCase", "MeasurementRecord", "EpochSummary",
    "ResultTable", "analyze_records", "case_orders", "measure_case",
    "measure_adaptive", "NREP_SPENT", "run_design", "map_parallel",
    "FactorSet", "capture_torch_factors", "assert_comparable",
    "FactorAxis", "FactorGrid", "GridCell",
    "RetryPolicy", "RetryBudgetExceeded", "retry_call",
]

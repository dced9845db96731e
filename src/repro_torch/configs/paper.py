"""The paper's own experimental configuration (§3, Appendix C), a copy of
the JAX package's ``repro.configs.paper``.

Not an LM architecture: this is the benchmark-suite config used by the
paper's experiments — the operations, message sizes, process counts and
method parameters of Table 4 / Appendix C, exposed so `benchmarks/` and the
examples share one source of truth.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PaperSuite:
    # §3.6 machines: TUWien 16..512 processes; we simulate the same range.
    process_counts: tuple = (8, 16, 32, 64, 128, 256, 512)
    # Table 1 / §6 message sizes: 1 B .. 32 KiB powers of two.
    message_sizes: tuple = tuple(2 ** i for i in range(0, 16))
    # §2/§5 collective operations studied.
    operations: tuple = ("bcast", "allreduce", "alltoall", "scan", "barrier")
    # §6 experimental design defaults (30 mpiruns x 1000 measurements).
    n_launch_epochs: int = 30
    nrep: int = 1000
    # §4 synchronization parameters (N_FITPTS, N_EXCHANGES) grid of Fig. 10.
    sync_params: tuple = ((10, 10), (60, 20), (100, 30), (200, 40),
                          (500, 100), (1000, 100))
    window_sizes_us: tuple = (30, 100, 150, 300, 500, 1000, 10_000)
    significance_level: float = 0.05


CONFIG = PaperSuite()

# Reduced suite for CI-speed runs (same structure, smaller counts).
SMOKE = PaperSuite(
    process_counts=(8, 16),
    message_sizes=(16, 256, 4096),
    n_launch_epochs=6,
    nrep=60,
    sync_params=((60, 20), (200, 40)),
    window_sizes_us=(100, 400),
)

"""Fault-tolerant fleet execution for factor sweeps, on the port (the JAX
package's ``repro.fleet``, with workers that may each hold a CUDA
context).

§5.2 of the paper treats a benchmark campaign as an *experiment*: which
cells get measured must not depend on which machine happened to die.
This package makes that a property of the scheduler rather than of luck:

- :mod:`~repro_torch.fleet.queue` — the lease-based work queue (claim →
  heartbeat → expiry → jittered-backoff retry → quarantine), a pure
  state machine tests drive on a fake clock;
- :mod:`~repro_torch.fleet.faults` — deterministic, seeded fault
  injection (crashes, stragglers, torn writes, transient exceptions),
  deciding the same faults as the reference's plan for every
  ``(seed, cell, attempt)``;
- :mod:`~repro_torch.fleet.federation` — idempotent merging of
  per-worker shard stores into one authoritative, resumable sweep store
  (the store format both packages read);
- :mod:`~repro_torch.fleet.scheduler` — the :class:`FleetScheduler`
  driving one worker process per attempt, forked from a fork server that
  never touched CUDA, with the invariant that the merged fleet store is
  record-identical to a serial no-fault run (quarantined cells excepted,
  and explicitly reported). Every cell samples through ``sim_scan`` on
  the card when its backend is on ``"cuda"``. ::

      from repro_torch.campaign import ResultStore
      from repro_torch.fleet import FaultPlan, FleetConfig, FleetScheduler
      from repro_torch.sweeps import default_sim_sweep

      spec, backend = default_sim_sweep(axes=("tuning", "dtype"))
      cfg = FleetConfig(n_workers=3,
                        faults=FaultPlan.parse("crash=0.5,raise=0.3,seed=7"))
      res = FleetScheduler(spec, backend, ResultStore("fleet.jsonl"),
                           cfg).run()
"""

from .faults import (CRASH_EXIT_CODE, CrashFault, Fault, FaultPlan,
                     FaultyBackend, TransientFault)
from .federation import MergeStats, merge_stores
from .queue import CellTask, LeaseQueue
from .scheduler import FleetConfig, FleetScheduler, FleetSweepResult

__all__ = [
    "CellTask", "LeaseQueue",
    "Fault", "FaultPlan", "FaultyBackend", "CrashFault", "TransientFault",
    "CRASH_EXIT_CODE",
    "MergeStats", "merge_stores",
    "FleetConfig", "FleetScheduler", "FleetSweepResult",
]

"""Lease-based work queue: which cell runs where, and what happens when
a worker dies holding it (copied from the JAX package's
``repro.fleet.queue``).

Static sharding (cell *i* belongs to worker ``i % n``) has exactly the
failure mode §5.2 warns about: a dead worker silently removes *its*
cells from the sweep — a systematic, factor-correlated hole in the
design. The :class:`LeaseQueue` replaces it with work stealing under
*leases*: a worker claims the next eligible cell and must keep the lease
alive by heartbeating; a lease that goes quiet past its TTL expires and
the cell returns to the queue, gated by an exponential-backoff-with-full-
jitter delay (:class:`~repro_torch.core.retry.RetryPolicy`). A cell that fails
its whole retry budget is **quarantined** — recorded, reported, and
excluded — instead of wedging the sweep.

The queue is deliberately *pure*: every method takes ``now`` explicitly,
nothing sleeps, nothing spawns. The :class:`~repro_torch.fleet.FleetScheduler`
drives it with wall-clock time and real processes; the tier-1 tests
drive it with a hand-rolled clock and assert the exact lease/backoff/
quarantine schedule.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.retry import RetryPolicy

__all__ = ["CellTask", "LeaseQueue"]

#: Task lifecycle: pending -> leased -> (done | pending (retry) | quarantined)
PENDING, LEASED, DONE, QUARANTINED = ("pending", "leased", "done",
                                      "quarantined")


@dataclass
class CellTask:
    """One sweep cell's place in the queue."""

    index: int                     # grid cell index
    fingerprint: str               # factor fingerprint (the store key)
    state: str = PENDING
    attempts: int = 0              # finished (failed) attempts so far
    not_before: float = 0.0        # backoff gate: ineligible before this
    worker: str | None = None      # current lease holder
    lease_expires: float = 0.0     # heartbeat deadline while leased
    errors: list = field(default_factory=list)   # one entry per failure


class LeaseQueue:
    """Cells → leases → retries → quarantine, as a deterministic state
    machine.

    ``retry_budget`` is the number of *attempts* a cell gets before
    quarantine (a budget of 3 = one initial try + two retries);
    ``policy`` shapes the delay between them, jitter-keyed by the cell
    index so two cells released together do not retry together.
    """

    def __init__(self, cells: list[tuple[int, str]], lease_ttl: float,
                 policy: RetryPolicy | None = None, retry_budget: int = 3):
        if lease_ttl <= 0:
            raise ValueError("LeaseQueue: lease_ttl must be > 0")
        if retry_budget < 1:
            raise ValueError("LeaseQueue: retry_budget must be >= 1")
        self.lease_ttl = float(lease_ttl)
        self.policy = policy or RetryPolicy(seed=0)
        self.retry_budget = int(retry_budget)
        self.tasks: dict[int, CellTask] = {
            int(i): CellTask(index=int(i), fingerprint=fp) for i, fp in cells}

    # -- claiming & heartbeats --------------------------------------------

    def claim(self, worker: str, now: float) -> CellTask | None:
        """Lease the next eligible pending cell to ``worker`` (lowest
        index first, respecting backoff gates); ``None`` when nothing is
        eligible *right now* (there may still be gated retries — see
        :meth:`next_wake`)."""
        for task in sorted(self.tasks.values(), key=lambda t: t.index):
            if task.state == PENDING and task.not_before <= now:
                task.state = LEASED
                task.worker = worker
                task.lease_expires = now + self.lease_ttl
                return task
        return None

    def heartbeat(self, index: int, now: float) -> None:
        """Progress signal from the lease holder: push the expiry out.
        Heartbeats on non-leased cells are ignored (a stale worker may
        still phone home after its lease was revoked)."""
        task = self.tasks[index]
        if task.state == LEASED:
            task.lease_expires = now + self.lease_ttl

    def expired(self, now: float) -> list[CellTask]:
        """Leases whose heartbeat went quiet past the TTL. The scheduler
        must kill the holder (it may be alive-but-stalled) and then
        :meth:`release` the cell."""
        return [t for t in sorted(self.tasks.values(), key=lambda t: t.index)
                if t.state == LEASED and t.lease_expires <= now]

    # -- completion & failure ---------------------------------------------

    def complete(self, index: int) -> None:
        task = self.tasks[index]
        task.state = DONE
        task.worker = None

    def release(self, index: int, now: float, error: str) -> str:
        """A leased attempt failed (crash, stall, exception). Returns the
        cell's new state: ``"pending"`` (requeued behind a jittered
        backoff gate) or ``"quarantined"`` (budget exhausted)."""
        task = self.tasks[index]
        task.worker = None
        task.attempts += 1
        task.errors.append(str(error))
        if task.attempts >= self.retry_budget:
            task.state = QUARANTINED
            return QUARANTINED
        # 0-based backoff attempt: first retry waits ~policy.base
        delay = self.policy.delay(task.attempts - 1, key=task.index)
        task.not_before = now + delay
        task.state = PENDING
        return PENDING

    # -- introspection -----------------------------------------------------

    def finished(self) -> bool:
        """No cell will ever run again: everything done or quarantined."""
        return all(t.state in (DONE, QUARANTINED)
                   for t in self.tasks.values())

    def next_wake(self, now: float) -> float | None:
        """Earliest future instant at which something becomes actionable
        (a backoff gate opens or a lease can expire); ``None`` when
        :meth:`finished`. The scheduler sleeps until then instead of
        spinning."""
        times = [t.not_before for t in self.tasks.values()
                 if t.state == PENDING and t.not_before > now]
        times += [t.lease_expires for t in self.tasks.values()
                  if t.state == LEASED]
        return min(times) if times else None

    def by_state(self, state: str) -> list[CellTask]:
        return [t for t in sorted(self.tasks.values(), key=lambda t: t.index)
                if t.state == state]

    def quarantined(self) -> list[CellTask]:
        return self.by_state(QUARANTINED)

    def stats(self) -> dict:
        tasks = list(self.tasks.values())
        return dict(
            n_cells=len(tasks),
            n_done=sum(t.state == DONE for t in tasks),
            n_quarantined=sum(t.state == QUARANTINED for t in tasks),
            # attempts only ever increments on failure, so this is the
            # total number of failed attempts across the whole sweep
            n_failed_attempts=sum(t.attempts for t in tasks),
        )

"""Exponential backoff with full jitter (copied from the JAX package's
``repro.core.retry``).

A measurement fleet retries constantly: a crashed worker's cell goes back
on the queue, a stalled lease is re-claimed, a transient exception is
re-attempted. Every one of those retries must (a) back off exponentially
so a sick host does not hammer the scheduler, (b) jitter the delay so a
fleet of workers whose leases expired together does not retry in
lock-step (the "thundering herd" the AWS architecture blog's *full
jitter* policy exists to break), and (c) be *deterministic under a seed*
so the tier-1 tests can assert the exact retry schedule instead of
trusting it.

:class:`RetryPolicy` is a frozen dataclass computing per-attempt delays;
:func:`retry_call` is the loop. There is deliberately no ad-hoc
``time.sleep`` in the epoch fan-out of :func:`~.design.map_parallel` —
every wait is a policy delay, every policy is seedable.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable

import numpy as np

__all__ = ["RetryPolicy", "RetryBudgetExceeded", "retry_call"]


class RetryBudgetExceeded(Exception):
    """Raised by :func:`retry_call` when every attempt failed; carries the
    last underlying exception as ``__cause__`` and the attempt count."""

    def __init__(self, attempts: int, last: BaseException):
        super().__init__(f"all {attempts} attempts failed "
                         f"(last: {type(last).__name__}: {last})")
        self.attempts = attempts
        self.last = last


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with *full* jitter and a deadline cap.

    ``delay(attempt)`` for attempt ``k`` (0-based: the delay *before*
    retry ``k+1``) is drawn uniformly from ``[0, min(max_delay,
    base * factor**k)]`` — full jitter, not equal jitter: the whole
    interval is randomized, which de-correlates retries best. With a
    ``seed`` the draw is a pure function of ``(seed, key, attempt)``, so
    a test (or a resumed scheduler) replays the identical schedule;
    ``key`` lets many independent schedules (one per sweep cell) share
    one policy without sharing their jitter streams.

    ``deadline`` caps the *cumulative* delay: :func:`retry_call` stops
    retrying once the total backoff spent would exceed it, whatever
    ``attempts`` says.
    """

    base: float = 0.05            # first backoff ceiling [s]
    factor: float = 2.0           # exponential growth per attempt
    max_delay: float = 2.0        # per-attempt ceiling [s]
    attempts: int = 4             # total tries (1 initial + attempts-1 retries)
    deadline: float | None = None  # cumulative backoff cap [s]
    seed: int | None = None       # None = nondeterministic jitter

    def __post_init__(self):
        if self.base < 0 or self.max_delay < 0:
            raise ValueError("RetryPolicy: delays must be >= 0")
        if self.factor < 1.0:
            raise ValueError("RetryPolicy: factor must be >= 1 (backoff "
                             "must not shrink)")
        if self.attempts < 1:
            raise ValueError("RetryPolicy: attempts must be >= 1")

    def ceiling(self, attempt: int) -> float:
        """The un-jittered backoff ceiling for 0-based ``attempt``."""
        return float(min(self.max_delay, self.base * self.factor ** attempt))

    def delay(self, attempt: int, key: int = 0) -> float:
        """The jittered delay before retry ``attempt + 1``."""
        hi = self.ceiling(attempt)
        if hi == 0.0:
            return 0.0
        if self.seed is None:
            rng = np.random.default_rng()
        else:
            # stateless: a pure function of (seed, key, attempt), so the
            # schedule survives process restarts and replays under test
            rng = np.random.default_rng((self.seed, key, attempt))
        return float(rng.uniform(0.0, hi))

    def delays(self, key: int = 0) -> Iterable[float]:
        """The full (deadline-capped) delay schedule, one entry per retry."""
        spent = 0.0
        for k in range(self.attempts - 1):
            d = self.delay(k, key)
            if self.deadline is not None and spent + d > self.deadline:
                return
            spent += d
            yield d


def retry_call(
    fn: Callable[[], Any],
    policy: RetryPolicy,
    retry_on: tuple[type[BaseException], ...] = (Exception,),
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Callable[[int, BaseException, float], None] | None = None,
    key: int = 0,
) -> Any:
    """Call ``fn()`` under ``policy``: up to ``policy.attempts`` tries,
    sleeping the policy's jittered delay between them.

    Only exceptions matching ``retry_on`` are retried; anything else
    propagates immediately (a programming error must not be retried into
    silence). ``on_retry(attempt, exc, delay)`` fires before each sleep —
    the logging hook. Raises :class:`RetryBudgetExceeded` (chaining the
    last exception) when the budget — attempts or cumulative deadline —
    is exhausted.
    """
    last: BaseException | None = None
    spent = 0.0
    for attempt in range(policy.attempts):
        try:
            return fn()
        except retry_on as e:
            last = e
        d = policy.delay(attempt, key)
        if attempt == policy.attempts - 1 or (
                policy.deadline is not None and spent + d > policy.deadline):
            break
        if on_retry is not None:
            on_retry(attempt, last, d)
        sleep(d)
        spent += d
    raise RetryBudgetExceeded(attempt + 1, last) from last

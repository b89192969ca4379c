"""Restart policy: exponential backoff and crash-loop detection.

Counterpart: `paddle_tpu/resilience/backoff.py`, copied (the port imports
nothing of the JAX package).  The serving router's respawns and the
transport's retries use it; so will the launcher and the loader's worker
pool when they are ported.
"""
from __future__ import annotations

import collections
import time


class Backoff:
    """Exponential backoff: delay(k) = min(max_delay, base * factor**k).

    `sleep` is injectable so that supervisors with their own loop (and
    tests) can schedule instead of block."""

    def __init__(self, base=1.0, factor=2.0, max_delay=30.0,
                 sleep=time.sleep):
        self.base = float(base)
        self.factor = float(factor)
        self.max_delay = float(max_delay)
        self._sleep = sleep

    def delay(self, attempt):
        """Seconds before restart number `attempt` (0-based)."""
        if self.base <= 0:
            return 0.0
        return min(self.max_delay, self.base * self.factor ** attempt)

    def wait(self, attempt):
        d = self.delay(attempt)
        if d > 0:
            self._sleep(d)
        return d


class CrashLoopDetector:
    """`threshold` failures within `window` seconds means the workload is
    crash-looping (a deterministic startup failure, a poisoned input) and
    restarting cannot help: abort instead of burning restarts."""

    def __init__(self, threshold=3, window=60.0, clock=time.monotonic):
        self.threshold = int(threshold)
        self.window = float(window)
        self._clock = clock
        self._failures = collections.deque()

    def record_failure(self):
        """Record one failure; True when the threshold is reached (the
        caller aborts rather than restarts)."""
        now = self._clock()
        self._failures.append(now)
        while self._failures and now - self._failures[0] > self.window:
            self._failures.popleft()
        return (self.threshold > 0 and
                len(self._failures) >= self.threshold)

    @property
    def recent_failures(self):
        return len(self._failures)

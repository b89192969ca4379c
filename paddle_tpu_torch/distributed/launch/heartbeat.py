"""Heartbeat: the liveness signal that tells a *hung* process from a
*crashed* one.

Counterpart: `paddle_tpu/distributed/launch/heartbeat.py`, copied (the
port imports nothing of the JAX package).  A crashed process has an exit
code; a hung one (a deadlocked collective, a wedged kernel launch) has
none, and without a liveness signal it wedges whoever waits on it.  The
process touches a file; the watcher reads the file's mtime as a change
detector and measures the silence on its OWN monotonic clock.

`start_heartbeat` / `stop_heartbeat` run one beating thread a process:
`distributed.init_parallel_env` arms it when the launcher set
PT_HEARTBEAT_FILE.  The serving router uses the two classes directly.
"""
from __future__ import annotations

import os
import threading
import time

_ACTIVE = None      # one beating thread a process


class Heartbeat:
    """The beat writer.  Two modes:

    * ``start()`` arms a daemon thread that beats every `interval`
      seconds: *process* liveness (it keeps beating while the main
      thread is stuck in native code).
    * ``beat()`` from a loop, no thread: *loop* liveness.  The serving
      router's replicas beat from their scheduler loop, because for a
      serving replica "alive" means making scheduling progress; a daemon
      thread would keep a wedged engine looking healthy."""

    def __init__(self, path, interval=1.0):
        self.path = path
        self.interval = float(interval)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="pt-heartbeat")

    def beat(self):
        with open(self.path, "a"):
            os.utime(self.path, None)

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self.beat()
            except OSError:
                pass    # a vanished directory must not kill the process

    def start(self):
        """First beat synchronously (the watcher sees a live file before
        any interval elapses), then the daemon thread."""
        self.beat()
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()


class BeatWatch:
    """Watcher-side staleness detector for one beat file.  Silence is
    measured on the watcher's monotonic clock, never from the mtime
    itself (a wall-clock step must not declare every process hung at
    once).  A fresh watch starts its clock at construction, so a
    just-(re)spawned process gets a full timeout before it must beat.

    `grace` widens that spawn window: until this watch sees its first
    beat, the allowed silence is ``max(timeout, grace)``, so a worker
    that spends tens of seconds importing and building before its first
    beat is not evicted as hung while it starts.  The file's state at
    construction is the baseline, not a beat: a dead predecessor's
    leftover file cannot disarm the new worker's grace; only an mtime
    change does, after which the plain timeout applies.  The router
    re-arms the grace by building a fresh watch at every (re)spawn."""

    def __init__(self, path, timeout, clock=time.monotonic, grace=None):
        self.path = path
        self.timeout = float(timeout)
        self.grace = self.timeout if grace is None else float(grace)
        self._clock = clock
        try:
            self._last_mtime = os.stat(path).st_mtime
        except OSError:
            self._last_mtime = None
        self._seen_beat = False
        self._last_change = clock()

    @property
    def silent_for(self):
        return self._clock() - self._last_change

    def stale(self):
        """True when the file has not changed for longer than `timeout`
        on this watcher's clock (``max(timeout, grace)`` until this watch
        sees its first beat)."""
        now = self._clock()
        try:
            mtime = os.stat(self.path).st_mtime
        except OSError:
            mtime = None          # never beat yet: the grace applies
        if mtime is not None and mtime != self._last_mtime:
            self._last_mtime = mtime
            self._last_change = now
            self._seen_beat = True
            return False
        limit = self.timeout if self._seen_beat \
            else max(self.timeout, self.grace)
        return now - self._last_change > limit


def start_heartbeat(path=None, interval=None):
    """Start (or return the running) heartbeat thread.  With no
    arguments, reads PT_HEARTBEAT_FILE / PT_HEARTBEAT_INTERVAL from the
    environment; returns None when neither names a file (not launched
    under a watching supervisor)."""
    global _ACTIVE
    if _ACTIVE is not None:
        return _ACTIVE
    path = path or os.environ.get("PT_HEARTBEAT_FILE")
    if not path:
        return None
    interval = interval if interval is not None else float(
        os.environ.get("PT_HEARTBEAT_INTERVAL", "1.0"))
    _ACTIVE = Heartbeat(path, interval).start()
    return _ACTIVE


def stop_heartbeat():
    global _ACTIVE
    if _ACTIVE is not None:
        _ACTIVE.stop()
        _ACTIVE = None

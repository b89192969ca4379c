"""The profiler (counterpart: `paddle_tpu/profiler.py`; reference:
python/paddle/profiler/), over `torch.profiler`.

- `RecordEvent(name)`: a `torch.profiler.record_function` range (a user
  annotation in a torch.profiler trace) that also adds its host time to
  the event table `Profiler.summary` prints, and, while telemetry is on
  (`observability.enable()`), a "host" span to the trace buffer.
- `make_scheduler(closed=, ready=, record=, repeat=, skip_first=)`: the
  capture windows, with the reference's arithmetic: `skip_first` steps,
  then cycles of (closed, ready, record); `repeat=k` gives k windows,
  `repeat=0` one.  The result is the first (start, end) pair with the
  list of windows as `.windows`.
- `Profiler(scheduler=, on_trace_ready=, timer_only=, log_dir=)`: times
  every step (`step(num_samples)`: step times, throughput) and, inside
  each window (every step without a scheduler), runs a
  `torch.profiler.profile` over CPU activity, and CUDA activity when
  there is a card; when a window closes its Chrome trace is written into
  `log_dir` (`trace_<pid>_<window>.json`), the finished profile is kept
  (`torch_profile`, replaced when the next window closes) so a caller
  can read its kernel events.  `on_trace_ready` is taken and not called, as
  in the reference.  `timer_only=True` times the steps and traces
  nothing.
  `summary(sorted_by=)` prints the reference's table: the step line
  (steps, avg, min, max, throughput) and the RecordEvent table sorted by
  total, count, avg or max.
- `program_stats(fn, *args)`: {"flops": the floating-point operations
  of one call of fn(*args)} counted by
  `torch.utils.flop_counter.FlopCounterMode` (matrix products and
  convolutions at 2 flops a multiply-add; the port's flash and paged
  operators by their registered formulas), as `api.flops` counts.  The
  reference asks XLA's cost analysis, which also reports bytes and
  estimated seconds; the port reports no number it does not measure.
- `profile(log_dir)`: a Profiler started and stopped around a block.
- `reset_events()`: clear the RecordEvent table.
"""
from __future__ import annotations

import collections
import contextlib
import os
import time

import torch

from . import observability as _obs

_event_stats = collections.defaultdict(lambda: [0, 0.0, 0.0])  # n, tot, max


def reset_events():
    _event_stats.clear()


class RecordEvent:
    """A named range: a user annotation in the torch.profiler trace and
    a row of the host event table."""

    def __init__(self, name):
        self.name = name
        self._ctx = None

    def __enter__(self):
        self._ctx = torch.profiler.record_function(self.name)
        self._ctx.__enter__()
        self.begin = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter()
        self._ctx.__exit__(*exc)
        dt = self.end - self.begin
        s = _event_stats[self.name]
        s[0] += 1
        s[1] += dt
        s[2] = max(s[2], dt)
        if _obs.enabled():
            _obs.trace.add_complete(self.name, "host", self.begin, dt)
        return False


class _Schedule(tuple):
    """The first (lo, hi) window, with every window in `.windows`."""

    def __new__(cls, windows):
        self = super().__new__(cls, windows[0])
        self.windows = list(windows)
        return self


def make_scheduler(*, closed=0, ready=0, record=1, repeat=0, skip_first=0):
    """Capture windows: `skip_first` steps, then repeating cycles of
    (closed, ready, record); `repeat=k` records k windows, 0 one."""
    cycle = closed + ready + record
    start = skip_first + closed + ready
    n = max(1, repeat)
    if n > 1 and cycle <= 0:
        raise ValueError("repeat > 1 needs a positive "
                         "closed + ready + record cycle")
    return _Schedule([(start + i * cycle, start + i * cycle + record)
                      for i in range(n)])


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class Profiler:
    """profiler.Profiler(scheduler=(2, 5)) traces steps [2, 5) while
    timing every step."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, log_dir="./profiler_log"):
        self.log_dir = log_dir
        self.timer_only = timer_only
        if scheduler is None:
            self.scheduler = None
            self._windows = None
        else:
            self.scheduler = tuple(scheduler)
            self._windows = list(getattr(scheduler, "windows",
                                         [self.scheduler]))
        self._windows_captured = 0
        self._cur_window = None
        self._step_idx = 0
        self._step_times = []
        self._samples = []
        self._t0 = None
        self._started = False
        self._prof = None
        self.torch_profile = None   # the last finished torch profile
        self.trace_files = []

    # ------------------------------------------------------------- control
    def _start_trace(self):
        self._prof = torch.profiler.profile(activities=_activities())
        self._prof.__enter__()

    def _stop_trace(self):
        prof, self._prof = self._prof, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(
            self.log_dir,
            f"trace_{os.getpid()}_{len(self.trace_files)}.json")
        prof.export_chrome_trace(path)
        self.trace_files.append(path)
        self.torch_profile = prof

    def _maybe_trace(self):
        if self.timer_only:
            return
        if self.scheduler is None:
            if self._prof is None:
                self._start_trace()
            return
        # stop first, so a zero-width window (lo == hi) records nothing;
        # crossing into another window closes the previous capture first
        widx = next((i for i, (lo, hi) in enumerate(self._windows)
                     if lo <= self._step_idx < hi), None)
        if self._prof is not None and widx != self._cur_window:
            self._stop_trace()
        if self._prof is None and widx is not None:
            self._start_trace()
            self._cur_window = widx
            self._windows_captured += 1

    def start(self):
        self._started = True
        self._step_idx = 0
        self._step_times = []
        self._samples = []
        self._windows_captured = 0
        self._cur_window = None
        reset_events()   # each profiling session has its own events
        self._maybe_trace()
        self._t0 = time.perf_counter()

    def step(self, num_samples=None):
        if not self._started:
            return   # step() outside start() / stop() starts no trace
        t = time.perf_counter()
        if self._t0 is not None:
            self._step_times.append(t - self._t0)
            self._samples.append(num_samples or 0)
            if _obs.enabled():
                _obs.trace.add_complete("profiler_step", "step", self._t0,
                                        t - self._t0,
                                        args={"idx": self._step_idx,
                                              "samples": num_samples or 0})
        self._t0 = t
        self._step_idx += 1
        self._maybe_trace()

    def stop(self):
        if self._started and self._prof is not None:
            self._stop_trace()
        self._started = False

    # ------------------------------------------------------------- reports
    _SORT_KEYS = {
        None: lambda kv: -kv[1][1],          # default: total time
        "total": lambda kv: -kv[1][1],
        "count": lambda kv: -kv[1][0],
        "avg": lambda kv: -(kv[1][1] / kv[1][0]),
        "max": lambda kv: -kv[1][2],
    }

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        if sorted_by not in self._SORT_KEYS:
            raise ValueError(
                f"sorted_by={sorted_by!r}: expected one of "
                f"'count', 'total', 'avg', 'max'")
        lines = []
        if self._step_times:
            times = self._step_times
            avg = sum(times) / len(times)
            line = (f"steps={len(times)} avg={avg*1e3:.2f}ms "
                    f"min={min(times)*1e3:.2f}ms max={max(times)*1e3:.2f}ms")
            n_samples = sum(self._samples)
            if n_samples:
                line += f" throughput={n_samples / sum(times):.1f}/s"
            lines.append(line)
        else:
            lines.append("no steps recorded")
        if op_detail and _event_stats:
            lines.append(f"{'event':<30} {'count':>7} {'total_ms':>10} "
                         f"{'avg_ms':>9} {'max_ms':>9}")
            items = sorted(_event_stats.items(),
                           key=self._SORT_KEYS[sorted_by])
            for name, (n, tot, mx) in items:
                lines.append(f"{name:<30} {n:>7} {tot*1e3:>10.2f} "
                             f"{tot/n*1e3:>9.2f} {mx*1e3:>9.2f}")
        return "\n".join(lines)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def program_stats(fn, *args, **kwargs):
    """{"flops": the floating-point operations of one call of
    fn(*args, **kwargs)}, counted by FlopCounterMode while it runs."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": int(counter.get_total_flops())}


@contextlib.contextmanager
def profile(log_dir="./profiler_log"):
    p = Profiler(log_dir=log_dir)
    p.start()
    try:
        yield p
    finally:
        p.stop()

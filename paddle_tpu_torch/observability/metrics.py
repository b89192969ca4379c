"""Metrics registry: counters, gauges and histograms with reservoir
percentiles, export-time collectors, and the exports: `snapshot()`,
JSON lines (`to_jsonl`, one metric a line, sorted keys) and the
Prometheus text format (`to_prometheus`, histograms as summaries with
the 0.5 / 0.9 / 0.99 quantiles, `_count` and `_sum`).

Counterpart: `paddle_tpu/observability/metrics.py`, copied in behaviour
(the port imports nothing of the JAX package): the same metrics give
the same text in both.
"""
from __future__ import annotations

import json
import math
import random
import threading

# one lock for scalar read-modify-write: counters and gauges update at
# step rates, so contention is negligible and no increment is lost
_VAL_LOCK = threading.Lock()


class Counter:
    kind = "counter"
    __slots__ = ("_v",)

    def __init__(self):
        self._v = 0

    def inc(self, n=1):
        with _VAL_LOCK:
            self._v += n

    def _set_total(self, v):
        """Collector hook: overwrite with a total kept elsewhere."""
        self._v = v

    @property
    def value(self):
        return self._v

    def snapshot(self):
        return {"value": self._v}


class Gauge:
    kind = "gauge"
    __slots__ = ("_v",)

    def __init__(self):
        self._v = 0.0

    def set(self, v):
        self._v = v

    def inc(self, n=1):
        with _VAL_LOCK:
            self._v += n

    def dec(self, n=1):
        with _VAL_LOCK:
            self._v -= n

    @property
    def value(self):
        return self._v

    def snapshot(self):
        return {"value": self._v}


class Histogram:
    """Streaming histogram with reservoir-sampled percentiles (algorithm R,
    fixed seed, so a fixed workload exports the same numbers)."""

    kind = "histogram"
    __slots__ = ("_n", "_sum", "_min", "_max", "_sample", "_k", "_rng",
                 "_lock")

    def __init__(self, reservoir=1024):
        self._n = 0
        self._sum = 0.0
        self._min = None
        self._max = None
        self._sample = []
        self._k = reservoir
        self._rng = random.Random(0x5EED)
        self._lock = threading.Lock()

    def observe(self, v):
        v = float(v)
        with self._lock:
            self._n += 1
            self._sum += v
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)
            if len(self._sample) < self._k:
                self._sample.append(v)
            else:
                j = self._rng.randrange(self._n)
                if j < self._k:
                    self._sample[j] = v

    @property
    def count(self):
        return self._n

    @property
    def sum(self):
        return self._sum

    def percentile(self, p):
        """Nearest-rank percentile, p in [0, 100]; None when empty."""
        with self._lock:
            sample = sorted(self._sample)
        if not sample:
            return None
        idx = max(0, min(len(sample) - 1,
                         math.ceil(p / 100.0 * len(sample)) - 1))
        return sample[idx]

    def snapshot(self):
        out = {"count": self._n, "sum": self._sum}
        if self._n:
            out.update(min=self._min, max=self._max,
                       p50=self.percentile(50), p90=self.percentile(90),
                       p99=self.percentile(99))
        return out


class MetricsRegistry:
    """Get-or-create table of metrics keyed by (name, sorted labels)."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.RLock()
        self._collectors = []

    def _get(self, cls, name, labels, **kwargs):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(**kwargs)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r}{labels} already registered as "
                    f"{m.kind}, requested {cls.kind}")
            return m

    def counter(self, name, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name, reservoir=1024, **labels) -> Histogram:
        return self._get(Histogram, name, labels, reservoir=reservoir)

    # ----------------------------------------------------------- collectors
    def add_collector(self, fn):
        """fn(registry) runs before every export, writing values kept
        outside the registry into it."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)
        return fn

    def remove_collector(self, fn):
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def collect(self):
        for fn in list(self._collectors):
            fn(self)

    # -------------------------------------------------------------- exports
    def snapshot(self):
        """[{name, type, labels, ...values}], sorted by name and labels;
        the collectors run first."""
        self.collect()
        with self._lock:
            items = sorted(self._metrics.items())
        out = []
        for (name, labels), m in items:
            rec = {"name": name, "type": m.kind, "labels": dict(labels)}
            rec.update(m.snapshot())
            out.append(rec)
        return out

    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(rec, sort_keys=True)
                         for rec in self.snapshot())

    def to_prometheus(self) -> str:
        """Prometheus text exposition; histograms export as summaries."""
        lines = []
        typed = set()
        for rec in self.snapshot():
            name, kind, labels = rec["name"], rec["type"], rec["labels"]
            if kind == "histogram":
                if name not in typed:
                    lines.append(f"# TYPE {name} summary")
                    typed.add(name)
                for q, key in (("0.5", "p50"), ("0.9", "p90"),
                               ("0.99", "p99")):
                    if rec.get(key) is not None:
                        lines.append(f"{name}"
                                     f"{_labels(labels, quantile=q)} "
                                     f"{_num(rec[key])}")
                lines.append(f"{name}_count{_labels(labels)} {rec['count']}")
                lines.append(f"{name}_sum{_labels(labels)} "
                             f"{_num(rec['sum'])}")
            else:
                if name not in typed:
                    lines.append(f"# TYPE {name} {kind}")
                    typed.add(name)
                lines.append(f"{name}{_labels(labels)} {_num(rec['value'])}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self):
        with self._lock:
            self._metrics.clear()


def _esc(v):
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace(
        "\n", r"\n")


def _labels(labels, **extra):
    all_labels = dict(labels, **extra)
    if not all_labels:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"'
                     for k, v in sorted(all_labels.items()))
    return "{" + inner + "}"


def _num(v):
    v = float(v)
    return repr(int(v)) if v.is_integer() and abs(v) < 2**53 else repr(v)


_default = MetricsRegistry()
_active = _default


def registry() -> MetricsRegistry:
    """The ACTIVE registry every instrument of the port writes to: the
    process default unless `observability.enable(registry_=...)` (or
    `set_registry`) retargeted it."""
    return _active


def set_registry(reg):
    """Retarget the active registry (None restores the process default);
    returns the now-active registry."""
    global _active
    _active = reg if reg is not None else _default
    return _active

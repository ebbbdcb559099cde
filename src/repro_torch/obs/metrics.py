"""Counters / gauges / histograms registry for run-level telemetry.

A :class:`MetricsRegistry` is a get-or-create namespace of named
instruments whose :meth:`~MetricsRegistry.snapshot` is a plain-JSON dict —
the shape stored under ``RunResult.meta["obs"]``. The module-level
:data:`REGISTRY` is the process default; ``runtime/serving_jax`` feeds it
jit-cache hit/miss counters and compile-vs-steady execution histograms
around ``get_program`` (the PR-6 ``serving_scale`` split, generalized to
every serving_jax run, sweep cube, and smoke job).
"""

from __future__ import annotations

import math
import time
from contextlib import contextmanager
from typing import Dict, List

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "timed"]


class Counter:
    __slots__ = ("name", "_n")

    def __init__(self, name: str) -> None:
        self.name = name
        self._n = 0

    def inc(self, n: int = 1) -> None:
        self._n += n

    @property
    def value(self) -> int:
        return self._n


class Gauge:
    __slots__ = ("name", "_v")

    def __init__(self, name: str) -> None:
        self.name = name
        self._v = 0.0

    def set(self, v: float) -> None:
        self._v = float(v)

    @property
    def value(self) -> float:
        return self._v


def _quantile(sorted_vals: List[float], q: float) -> float:
    # nearest-rank on the sorted sample; no numpy needed for a snapshot
    idx = min(len(sorted_vals) - 1, max(0, math.ceil(q * len(sorted_vals)) - 1))
    return sorted_vals[idx]


class Histogram:
    """Stores raw observations (run-scale cardinality — dozens, not
    millions); snapshot computes count/sum/mean/min/max/p50/p90/p99."""

    __slots__ = ("name", "_vals")

    def __init__(self, name: str) -> None:
        self.name = name
        self._vals: List[float] = []

    def observe(self, v: float) -> None:
        self._vals.append(float(v))

    @property
    def count(self) -> int:
        return len(self._vals)

    def snapshot(self) -> Dict[str, float]:
        if not self._vals:
            return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                    "max": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0}
        vals = sorted(self._vals)
        total = sum(vals)
        return {"count": len(vals), "sum": total,
                "mean": total / len(vals), "min": vals[0], "max": vals[-1],
                "p50": _quantile(vals, 0.50), "p90": _quantile(vals, 0.90),
                "p99": _quantile(vals, 0.99)}


class MetricsRegistry:
    """Get-or-create instrument namespace. Asking for an existing name with
    a different instrument kind raises — names are globally typed."""

    def __init__(self) -> None:
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls):
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = cls(name)
        elif not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(inst).__name__}, not {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> Dict[str, dict]:
        return {
            "counters": {n: i.value for n, i in self._instruments.items()
                         if isinstance(i, Counter)},
            "gauges": {n: i.value for n, i in self._instruments.items()
                       if isinstance(i, Gauge)},
            "histograms": {n: i.snapshot()
                           for n, i in self._instruments.items()
                           if isinstance(i, Histogram)},
        }

    def reset(self) -> None:
        self._instruments.clear()


#: process-default registry (serving_jax instrumentation lands here)
REGISTRY = MetricsRegistry()


@contextmanager
def timed(name: str, registry: MetricsRegistry = REGISTRY):
    """Observe the wrapped block's wall time (perf_counter seconds) into
    ``registry.histogram(name)``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        registry.histogram(name).observe(time.perf_counter() - t0)

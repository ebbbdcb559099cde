"""Deterministic trace persistence: flat-npz save/load and a params-keyed
cache so expensive traces (24 h google_like is ~50k jobs / ~1.7M tasks) are
synthesized once and shared across benchmark runs.

The on-disk layout is four flat arrays (arrival, is_long, task counts,
concatenated durations) plus a JSON meta blob — loads back into the exact
same :class:`~repro_torch.core.jobs.Trace` (round-trip checked in tests).

Cache keys hash the builder name and its full kwargs (sorted JSON), so a
changed parameter can never silently reuse a stale file.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import pathlib
import warnings
import zipfile
from typing import Callable, Union

import numpy as np

from repro_torch.core.jobs import Job, Trace


def save_trace(path: Union[str, pathlib.Path], trace: Trace) -> pathlib.Path:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrivals = np.asarray([j.arrival for j in trace.jobs], np.float64)
    is_long = np.asarray([j.is_long for j in trace.jobs], np.bool_)
    n_tasks = np.asarray([j.n_tasks for j in trace.jobs], np.int64)
    durations = (np.concatenate([j.durations for j in trace.jobs])
                 if trace.jobs else np.empty(0))
    np.savez_compressed(
        path, arrivals=arrivals, is_long=is_long, n_tasks=n_tasks,
        durations=np.asarray(durations, np.float64),
        horizon=np.float64(trace.horizon),
        meta=np.frombuffer(json.dumps(trace.meta, sort_keys=True,
                                      default=float).encode(), np.uint8))
    return path


def load_trace(path: Union[str, pathlib.Path]) -> Trace:
    with np.load(pathlib.Path(path)) as z:
        arrivals = z["arrivals"]
        is_long = z["is_long"]
        n_tasks = z["n_tasks"]
        durations = z["durations"]
        horizon = float(z["horizon"])
        meta = json.loads(bytes(z["meta"]).decode()) if z["meta"].size else {}
    jobs = []
    offsets = np.concatenate([[0], np.cumsum(n_tasks)])
    for i in range(len(arrivals)):
        jobs.append(Job(i, float(arrivals[i]),
                        durations[offsets[i]:offsets[i + 1]].copy(),
                        bool(is_long[i])))
    return Trace(jobs, horizon, meta=meta)


def trace_key(builder_name: str, **params) -> str:
    """Deterministic cache key: sha256 of the builder name + sorted kwargs."""
    blob = json.dumps({"builder": builder_name, "params": params},
                      sort_keys=True, default=float)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _full_params(builder: Callable[..., Trace], params: dict) -> dict:
    """Explicit kwargs merged over the builder's signature defaults, so a
    changed calibration default invalidates the cache key too."""
    try:
        defaults = {k: v.default for k, v in
                    inspect.signature(builder).parameters.items()
                    if v.default is not inspect.Parameter.empty}
    except (TypeError, ValueError):
        defaults = {}
    return {**defaults, **params}


def cached_trace(builder: Callable[..., Trace],
                 cache_dir: Union[str, pathlib.Path], **params) -> Trace:
    """Build (or load) the trace for ``builder(**params)``, keyed by the
    builder's ``__name__`` and its full kwargs (explicit ones merged over
    signature defaults).  Corrupt/unreadable cache files are rebuilt rather
    than crashing the benchmark."""
    cache_dir = pathlib.Path(cache_dir)
    name = getattr(builder, "__name__", "trace")
    key = trace_key(name, **_full_params(builder, params))
    path = cache_dir / f"{name}-{key}.npz"
    if path.exists():
        try:
            return load_trace(path)
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as exc:
            # BadZipFile covers a truncated .npz (np.load opens it as a
            # zip archive); anything outside this set is a real bug and
            # should crash, not silently regenerate
            warnings.warn(f"corrupt trace cache {path}: "
                          f"{type(exc).__name__}: {exc} — rebuilding",
                          stacklevel=2)
            path.unlink(missing_ok=True)
    tr = builder(**params)
    save_trace(path, tr)
    return tr

"""Burstiness / concurrency metrics over traces and arrival vectors.

The quantitative vocabulary behind the paper's Fig. 1 argument ("concurrency
swings >6x"): peak-to-mean and peak-to-trough ratios, index of dispersion,
the Goh–Barabási burstiness coefficient, and the smoothed concurrency curve.
Consumed by ``benchmarks/fig1_burstiness.py`` and the scenario-catalog
tests; works on both serial traces and JAX slot-count batches.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.jobs import Trace


def slot_counts(times: np.ndarray, horizon: float, dt: float) -> np.ndarray:
    """Bin arrival times into per-slot counts (the serial mirror of the JAX
    batch sampler's output)."""
    n = int(np.ceil(horizon / dt))
    times = np.asarray(times, float)
    times = times[(times >= 0) & (times < horizon)]
    idx = np.minimum((times // dt).astype(int), n - 1)
    return np.bincount(idx, minlength=n)


def peak_to_mean(x: np.ndarray) -> float:
    x = np.asarray(x, float)
    m = x.mean()
    return float(x.max() / m) if m > 0 else 0.0


def index_of_dispersion(counts: np.ndarray) -> float:
    """Var/mean of slot counts — 1 for Poisson, >1 for bursty arrivals."""
    counts = np.asarray(counts, float)
    m = counts.mean()
    return float(counts.var() / m) if m > 0 else 0.0


def burstiness_coefficient(times: np.ndarray) -> float:
    """Goh–Barabási B = (σ−μ)/(σ+μ) of inter-arrival times: −1 periodic,
    0 Poisson, →1 extremely bursty."""
    iat = np.diff(np.sort(np.asarray(times, float)))
    if iat.size < 2:
        return 0.0
    mu, sigma = iat.mean(), iat.std()
    return float((sigma - mu) / (sigma + mu)) if (sigma + mu) > 0 else 0.0


def smooth(x: np.ndarray, window: int) -> np.ndarray:
    """Moving average with a ``window``-sample boxcar (``mode='valid'``)."""
    window = max(int(window), 1)
    if window <= 1:
        return np.asarray(x, float)
    kernel = np.ones(window) / window
    return np.convolve(np.asarray(x, float), kernel, mode="valid")


def sparkline(x: np.ndarray, width: int = 64) -> str:
    """ASCII sparkline (the Fig. 1 terminal rendering)."""
    bars = " ▁▂▃▄▅▆▇█"
    x = np.asarray(x, float)
    if x.size == 0:
        return ""
    idx = np.linspace(0, len(x) - 1, min(width, len(x))).astype(int)
    lo, hi = x.min(), x.max()
    return "".join(bars[int((x[i] - lo) / max(hi - lo, 1e-9) * 8)]
                   for i in idx)


def concurrency_stats(trace: Trace, *, bin_s: float = 100.0,
                      window_s: float = 4 * 3600.0) -> Dict:
    """The paper's Fig. 1 readout: theoretical concurrent tasks (unlimited
    resources, omniscient zero-delay scheduler) in ``bin_s`` bins, smoothed
    over ``window_s`` windows; peak/trough/mean over the active region."""
    conc = trace.concurrent_tasks(bin_s=bin_s)
    sm = smooth(conc, int(window_s / bin_s))
    active = sm[sm > 0]
    if active.size == 0:
        active = np.zeros(1)
    arrivals = np.asarray([j.arrival for j in trace.jobs])
    return {
        "n_jobs": trace.n_jobs,
        "n_tasks": trace.n_tasks,
        "max_tasks_per_job": max((j.n_tasks for j in trace.jobs), default=0),
        "mean_concurrent": float(active.mean()),
        "std_concurrent": float(active.std()),
        "peak_concurrent": float(active.max()),
        "trough_concurrent": float(active.min()),
        "peak_over_trough": float(active.max() / max(active.min(), 1e-9)),
        "peak_over_mean": peak_to_mean(active),
        "arrival_dispersion": index_of_dispersion(
            slot_counts(arrivals, trace.horizon, bin_s)),
        "arrival_burstiness": burstiness_coefficient(arrivals),
        "sparkline": sparkline(sm),
    }

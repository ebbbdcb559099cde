"""Workload model: jobs with per-task durations, arrival times, and a
long/short class (hybrid schedulers assume runtime estimates; following the
Eagle/Hawk simulators the class is known at arrival)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


@dataclass
class Job:
    job_id: int
    arrival: float
    durations: np.ndarray  # (n_tasks,) seconds
    is_long: bool
    tenant_id: int = 0  # multi-tenant traces stamp the owning tenant

    @property
    def n_tasks(self) -> int:
        return int(self.durations.shape[0])

    @property
    def work(self) -> float:
        return float(self.durations.sum())


@dataclass
class Trace:
    jobs: List[Job]
    horizon: float
    meta: Dict = field(default_factory=dict)

    @property
    def n_jobs(self) -> int:
        return len(self.jobs)

    @property
    def n_tasks(self) -> int:
        return sum(j.n_tasks for j in self.jobs)

    @property
    def total_work(self) -> float:
        return sum(j.work for j in self.jobs)

    def utilization(self, n_servers: int) -> float:
        return self.total_work / (n_servers * self.horizon)

    def concurrent_tasks(self, bin_s: float = 100.0) -> np.ndarray:
        """Fig.1 curve: theoretical concurrent tasks with unlimited resources
        and an omniscient zero-delay scheduler, averaged over ``bin_s`` bins."""
        events = []
        for j in self.jobs:
            ends = j.arrival + j.durations
            events.append((np.full(j.n_tasks, j.arrival), np.ones(j.n_tasks)))
            events.append((ends, -np.ones(j.n_tasks)))
        times = np.concatenate([e[0] for e in events])
        deltas = np.concatenate([e[1] for e in events])
        order = np.argsort(times, kind="stable")
        times, deltas = times[order], deltas[order]
        # integrate concurrency into fixed bins
        n_bins = int(np.ceil(self.horizon / bin_s)) + 1
        out = np.zeros(n_bins)
        cur = 0.0
        last_t = 0.0
        for t, d in zip(times, deltas):
            t = min(max(t, 0.0), self.horizon)
            b0, b1 = int(last_t // bin_s), int(t // bin_s)
            if b0 == b1:
                out[b0] += cur * (t - last_t)
            else:
                out[b0] += cur * ((b0 + 1) * bin_s - last_t)
                out[b0 + 1:b1] += cur * bin_s
                out[b1] += cur * (t - b1 * bin_s)
            cur += d
            last_t = t
        return out / bin_s

"""Job-size / duration mixes: arrival times → :class:`repro_torch.core.jobs.Job`s.

Extracted from the historical ``traces/synthetic.py`` so any
:class:`~repro_torch.workload.arrivals.ArrivalProcess` can be paired with any job
mix.  The two calibrated mixes the paper relies on:

  * :class:`TwoClassLognormalMix` ("yahoo") — ~10% long jobs that dominate
    cluster time (Chen et al. MASCOTS'11; Delgado et al. ATC'15/SoCC'16);
  * :class:`HeavyTailMix` ("google") — heavy-tailed tasks-per-job
    (lognormal body + Pareto tail up to ~50k tasks, mean ~35; Reiss et al.
    SoCC'12).

Both consume the RNG in exactly the order the historical generators did, so
the ``traces.synthetic`` shim reproduces pre-subsystem traces byte-for-byte
(hash-checked in tests/test_workload.py).

``mean_work_per_job`` is the calibration hook: builders size the arrival
rate as ``target_work / mean_work_per_job / horizon`` (the same equation
the legacy generators used inline).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from repro_torch.core.jobs import Job, Trace


def lognormal_mean(rng, mean, sigma, size):
    """Lognormal with the requested arithmetic mean (legacy helper)."""
    mu = np.log(mean) - 0.5 * sigma**2
    return rng.lognormal(mu, sigma, size)


class JobMix:
    """Turns arrival times into Jobs, drawing sizes from a shared stream."""

    def jobs(self, rng: np.random.Generator,
             arrivals: np.ndarray) -> List[Job]:
        raise NotImplementedError

    def mean_work_per_job(self) -> float:
        """Expected server-seconds per job (arrival-rate calibration)."""
        raise NotImplementedError


@dataclass(frozen=True)
class TwoClassLognormalMix(JobMix):
    """Yahoo-style two-class mix: rare long fan-out jobs + short jobs.

    Per job (legacy RNG order): class Bernoulli, lognormal task count,
    lognormal per-task durations.
    """

    long_frac: float = 0.095
    short_mean_s: float = 55.0
    long_mean_s: float = 1100.0
    short_tasks_mean: float = 4.0
    long_tasks_mean: float = 130.0
    tasks_sigma: float = 1.0
    short_dur_sigma: float = 0.7
    long_dur_sigma: float = 0.6

    def jobs(self, rng, arrivals):
        out = []
        for i, t in enumerate(arrivals):
            is_long = rng.random() < self.long_frac
            if is_long:
                n = max(1, int(lognormal_mean(rng, self.long_tasks_mean,
                                              self.tasks_sigma, 1)[0]))
                durs = lognormal_mean(rng, self.long_mean_s,
                                      self.long_dur_sigma, n)
            else:
                n = max(1, int(lognormal_mean(rng, self.short_tasks_mean,
                                              self.tasks_sigma, 1)[0]))
                durs = lognormal_mean(rng, self.short_mean_s,
                                      self.short_dur_sigma, n)
            out.append(Job(i, float(t), durs.astype(np.float64), is_long))
        return out

    def mean_work_per_job(self):
        return (self.long_frac * self.long_tasks_mean * self.long_mean_s
                + (1 - self.long_frac) * self.short_tasks_mean
                * self.short_mean_s)


@dataclass(frozen=True)
class HeavyTailMix(JobMix):
    """Google-style mix: heavy-tailed tasks-per-job, two duration classes.

    Task counts are drawn vectorized for the whole batch first, then per
    job the class and durations (legacy RNG order).
    """

    long_frac: float = 0.08
    short_mean_s: float = 40.0
    long_mean_s: float = 1500.0
    tasks_body_mean: float = 18.0
    tasks_body_sigma: float = 1.2
    tail_frac: float = 0.02
    tail_alpha: float = 1.3
    tail_scale: float = 200.0
    max_tasks: int = 49960
    dur_sigma: float = 0.8
    mean_tasks: float = 35.0  # Reiss et al. calibration constant

    def tasks_per_job(self, rng, n):
        body = lognormal_mean(rng, self.tasks_body_mean,
                              self.tasks_body_sigma, n)
        tail_mask = rng.random(n) < self.tail_frac
        tail = (rng.pareto(self.tail_alpha, n) + 1) * self.tail_scale
        out = np.where(tail_mask, tail, body)
        return np.clip(out, 1, self.max_tasks).astype(int)

    def jobs(self, rng, arrivals):
        counts = self.tasks_per_job(rng, len(arrivals))
        out = []
        for i, (t, n) in enumerate(zip(arrivals, counts)):
            is_long = rng.random() < self.long_frac
            mean = self.long_mean_s if is_long else self.short_mean_s
            durs = lognormal_mean(rng, mean, self.dur_sigma, int(n))
            out.append(Job(i, float(t), durs.astype(np.float64), is_long))
        return out

    def mean_work_per_job(self):
        return (self.long_frac * self.mean_tasks * self.long_mean_s
                + (1 - self.long_frac) * self.mean_tasks * self.short_mean_s)


def build_trace(process, mix: JobMix, *, seed, horizon: float,
                meta=None) -> Trace:
    """Generic composition: sample arrivals, draw the job mix, wrap a Trace.

    One shared RNG stream (arrivals first, then sizes) keeps the result a
    pure function of ``(process, mix, seed, horizon)``.
    """
    rng = np.random.default_rng(seed)
    arrivals = process.sample(rng, horizon)
    jobs = mix.jobs(rng, arrivals)
    return Trace(jobs, horizon, meta=dict(meta or {}))

"""Named trace builders: arrival process × job mix × calibration → Trace.

The calibrated generators the scenario registry refers to by name
(``Scenario.trace_fn``).  ``yahoo_like`` / ``google_like`` reproduce the
historical ``traces/synthetic.py`` output byte-for-byte (same RNG order;
hash-checked in tests) — ``traces.synthetic`` is now a shim over this
module.  The new regimes unlock the ROADMAP scenario-diversity item:

  * :func:`diurnal_like` — Yahoo mix on diurnal×MMPP arrivals (Alibaba-style
    day/night modulation under the usual calm/burst switching);
  * :func:`flash_crowd_like` — Yahoo mix with flash-crowd rate spikes
    multiplying the MMPP base (BoPF's bursty-tenant regime);
  * :func:`poisson_like` — homogeneous-Poisson control (no burstiness; the
    null hypothesis for any burstiness-sensitive result).

All builders share the interface ``(seed, n_servers, n_short, horizon,
**calibration)`` so scenario scale presets apply uniformly, and all expose
their arrival process via the ``*_arrivals`` helpers for direct (e.g.
batched-JAX) sampling.  Register new builders in ``TRACE_BUILDERS``.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from repro_torch.core.jobs import Trace
from repro_torch.workload.arrivals import (ArrivalProcess, Diurnal, FlashCrowd,
                                     MMPP, Modulated, Poisson)
from repro_torch.workload.jobmix import (HeavyTailMix, JobMix, TwoClassLognormalMix,
                                   build_trace)

#: builder-name → callable registry (``repro_torch.sched.Scenario.trace_fn`` values)
TRACE_BUILDERS: Dict[str, Callable[..., Trace]] = {}


def register_builder(fn: Callable[..., Trace]) -> Callable[..., Trace]:
    TRACE_BUILDERS[fn.__name__] = fn
    return fn


# ------------------------------------------------------------- calibration

def yahoo_rate(n_servers: int, n_short: int, horizon: float, long_util: float,
               short_util: float, mix: JobMix) -> float:
    """Arrival rate loading the general partition to ``long_util`` and the
    short partition to ``short_util`` (legacy calibration equation)."""
    n_general = n_servers - n_short
    target_work = (long_util * n_general + short_util * n_short) * horizon
    return target_work / mix.mean_work_per_job() / horizon


def yahoo_arrivals(rate: float, burst_mult: float = 5.0,
                   calm_frac: float = 0.8) -> MMPP:
    return MMPP.from_burst(rate, burst_mult, calm_frac)


def google_arrivals(n_servers: int = 4000, target_util: float = 0.75,
                    long_frac: float = 0.08, burst_mult: float = 6.0,
                    calm_frac: float = 0.75) -> MMPP:
    mix = HeavyTailMix(long_frac=long_frac)
    rate = target_util * n_servers / mix.mean_work_per_job()
    return MMPP.from_burst(rate, burst_mult, calm_frac)


# ---------------------------------------------------------- legacy builders

@register_builder
def yahoo_like(seed=0, n_servers=4000, n_short=80, horizon=24 * 3600.0,
               long_util=0.97, short_util=0.65,
               long_frac=0.095, short_mean_s=55.0, long_mean_s=1100.0,
               short_tasks_mean=4.0, long_tasks_mean=130.0,
               burst_mult=5.0, calm_frac=0.8) -> Trace:
    """Yahoo-calibrated bursty trace (paper §4 evaluation workload).

    Calibration (Hawk/Eagle's Yahoo characterization): ~10% of jobs are long
    but they carry ~99% of cluster time; the general partition runs
    long-saturated (``long_util`` of its capacity) so the long-load ratio
    hovers around the paper's L_r^T = 0.95, while short work alone would load
    the short-only partition at ``short_util``. At the paper's scale
    (4000 servers / 80 short / 24 h) this yields ~24k jobs — the size of the
    original Yahoo trace.
    """
    mix = TwoClassLognormalMix(
        long_frac=long_frac, short_mean_s=short_mean_s,
        long_mean_s=long_mean_s, short_tasks_mean=short_tasks_mean,
        long_tasks_mean=long_tasks_mean)
    rate = yahoo_rate(n_servers, n_short, horizon, long_util, short_util, mix)
    tr = build_trace(yahoo_arrivals(rate, burst_mult, calm_frac), mix,
                     seed=seed, horizon=horizon, meta={
                         "kind": "yahoo_like", "seed": seed,
                         "long_util": long_util, "short_util": short_util,
                         "n_servers": n_servers,
                     })
    tr.meta["utilization"] = tr.utilization(n_servers)
    return tr


@register_builder
def google_like(seed=0, n_servers=4000, horizon=24 * 3600.0, target_util=0.75,
                long_frac=0.08, max_tasks=49960, n_short=None) -> Trace:
    """Google-calibrated trace: heavy-tailed tasks-per-job (Pareto body up to
    ~50k tasks) for the Fig. 1 burstiness analysis.

    ``n_short`` is accepted (and ignored — the google calibration targets
    whole-cluster utilization) so scenario scale presets apply uniformly.
    """
    mix = HeavyTailMix(long_frac=long_frac, max_tasks=max_tasks)
    rate = target_util * n_servers / mix.mean_work_per_job()
    tr = build_trace(yahoo_arrivals(rate, burst_mult=6.0, calm_frac=0.75),
                     mix, seed=seed, horizon=horizon, meta={
                         "kind": "google_like", "seed": seed,
                         "target_util": target_util, "n_servers": n_servers,
                     })
    tr.meta["utilization"] = tr.utilization(n_servers)
    return tr


# ------------------------------------------------------------ new regimes

@register_builder
def diurnal_like(seed=0, n_servers=4000, n_short=80, horizon=24 * 3600.0,
                 long_util=0.9, short_util=0.6, rel_amplitude=0.6,
                 period=24 * 3600.0, phase=0.0, burst_mult=5.0,
                 calm_frac=0.8) -> Trace:
    """Yahoo mix on diurnal×MMPP arrivals: the calm/burst switching rides a
    sinusoidal day/night envelope (peak ``1+rel_amplitude`` × mean), the
    dominant modulation in the Alibaba characterization (Cheng et al. 2018).
    Mean utilization is calibrated like ``yahoo_like``; the diurnal peak
    intentionally over-subscribes the static cluster."""
    mix = TwoClassLognormalMix()
    rate = yahoo_rate(n_servers, n_short, horizon, long_util, short_util, mix)
    proc = Modulated(
        base=yahoo_arrivals(rate, burst_mult, calm_frac),
        envelope=Diurnal(rate=1.0, rel_amplitude=rel_amplitude,
                         period=period, phase=phase))
    tr = build_trace(proc, mix, seed=seed, horizon=horizon, meta={
        "kind": "diurnal_like", "seed": seed, "rel_amplitude": rel_amplitude,
        "period": period, "n_servers": n_servers,
    })
    tr.meta["utilization"] = tr.utilization(n_servers)
    return tr


@register_builder
def flash_crowd_like(seed=0, n_servers=4000, n_short=80, horizon=24 * 3600.0,
                     long_util=0.9, short_util=0.55, spike_mult=8.0,
                     spike_duration=1800.0, n_spikes=3, burst_mult=4.0,
                     calm_frac=0.8) -> Trace:
    """Yahoo mix with flash-crowd spikes: ``n_spikes`` windows of
    ``spike_duration`` seconds multiply the MMPP base rate by
    ``spike_mult`` (normalized so the time-average stays calibrated) — the
    bursty-tenant regime BoPF (Le et al. 2019) evaluates against, and the
    stress test for ``BurstGuardProbing``'s admission control."""
    mix = TwoClassLognormalMix()
    rate = yahoo_rate(n_servers, n_short, horizon, long_util, short_util, mix)
    proc = Modulated(
        base=yahoo_arrivals(rate, burst_mult, calm_frac),
        envelope=FlashCrowd(rate=1.0, spike_mult=spike_mult,
                            spike_duration=spike_duration,
                            n_spikes=n_spikes))
    tr = build_trace(proc, mix, seed=seed, horizon=horizon, meta={
        "kind": "flash_crowd_like", "seed": seed, "spike_mult": spike_mult,
        "n_spikes": n_spikes, "n_servers": n_servers,
    })
    tr.meta["utilization"] = tr.utilization(n_servers)
    return tr


@register_builder
def poisson_like(seed=0, n_servers=4000, n_short=80, horizon=24 * 3600.0,
                 long_util=0.9, short_util=0.6) -> Trace:
    """Homogeneous-Poisson control: identical job mix and calibration to
    ``yahoo_like`` but no arrival burstiness — isolates how much of any
    result is due to burstiness rather than load."""
    mix = TwoClassLognormalMix()
    rate = yahoo_rate(n_servers, n_short, horizon, long_util, short_util, mix)
    tr = build_trace(Poisson(rate), mix, seed=seed, horizon=horizon, meta={
        "kind": "poisson_like", "seed": seed, "n_servers": n_servers,
    })
    tr.meta["utilization"] = tr.utilization(n_servers)
    return tr


# ------------------------------------------------------------- multi-tenant

@register_builder
def multi_tenant(seed=0, n_servers=4000, n_short=80, horizon=24 * 3600.0,
                 tenant_set="trio", long_util=0.9, short_util=0.6) -> Trace:
    """Superposition of per-tenant traces (``repro_torch.tenancy``).

    Each tenant in the set gets its ``rate_share`` of the aggregate
    calibrated rate, shaped by its own arrival process and job mix, drawn
    from an *independent* RNG stream (``default_rng([seed, tenant_id])``)
    — so adding a tenant never perturbs another tenant's jobs. The merged
    trace is sorted by arrival and renumbered so that

        ``job_id % n_tenants == tenant_id``

    (``job_id = per_tenant_index * n_tenants + tenant_id``): every engine
    — including the jitted ``serving_jax`` scan, where a side table would
    be a dynamic lookup — recovers the owning tenant from the id alone.
    ``Job.tenant_id`` is stamped too; single-tenant builders leave it at
    the default 0.

    The aggregate rate solves the same legacy calibration equation as
    ``yahoo_like`` against the share-weighted mean work per job, so the
    fleet-level load matches the single-tenant presets.
    """
    from repro_torch.tenancy import get_tenant_set

    ts = get_tenant_set(tenant_set) if isinstance(tenant_set, str) \
        else tenant_set
    shares = ts.shares()
    mixes = [t.job_mix() for t in ts.tenants]
    n_general = n_servers - n_short
    target_work = (long_util * n_general + short_util * n_short) * horizon
    mean_work = sum(s * m.mean_work_per_job() for s, m in zip(shares, mixes))
    rate = target_work / mean_work / horizon

    tagged = []  # (arrival, tenant_id, per_tenant_index, job)
    for tid, (spec, share, mix) in enumerate(zip(ts.tenants, shares, mixes)):
        # normalize to the share's exact mean rate: spiky processes (flash
        # crowd) have mean_rate > their base-rate parameter, and every
        # registered process is linear in it, so one probe calibrates
        probe = spec.arrival_process(1.0)
        scale = rate * share / max(probe.mean_rate(horizon), 1e-12)
        proc = spec.arrival_process(scale)
        sub = build_trace(proc, mix, seed=[seed, tid], horizon=horizon)
        for j in sub.jobs:
            tagged.append((j.arrival, tid, j.job_id, j))
    tagged.sort(key=lambda rec: (rec[0], rec[1], rec[2]))
    counters = [0] * ts.n_tenants
    jobs = []
    for _, tid, _, j in tagged:
        j.job_id = counters[tid] * ts.n_tenants + tid
        j.tenant_id = tid
        counters[tid] += 1
        jobs.append(j)
    tr = Trace(jobs, horizon, meta={
        "kind": "multi_tenant", "seed": seed, "n_servers": n_servers,
        "tenant_set": ts.name, "tenants": list(ts.names),
        "tenant_shares": [float(s) for s in shares],
        "tenant_slo_s": [float(s) for s in ts.slo_targets_s()],
        "tenant_credit_rate": [float(r) for r in ts.credit_rates()],
        "tenant_credit_burst": [float(b) for b in ts.credit_bursts()],
        "tenant_n_jobs": counters,
    })
    tr.meta["utilization"] = tr.utilization(n_servers)
    return tr

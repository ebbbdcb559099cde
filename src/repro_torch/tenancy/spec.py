"""Tenant model — who shares the fleet, what they were promised.

CloudCoaster sizes one aggregate short partition; the clusters it targets
serve many competing user populations whose bursts collide (BoPF, Le et
al. 2019; the Alibaba co-located trace study, Cheng et al. 2018 shows how
skewed real tenant mixes are). This module is the declarative half of the
multi-tenant layer:

  * :class:`TenantSpec` — one tenant: a share of the aggregate arrival
    rate shaped by a named :mod:`repro_torch.workload.arrivals` process, a job
    mix, an SLO target (p99 wait ≤ X s), and token-bucket burst-credit
    parameters (see :mod:`repro_torch.tenancy.admission`);
  * :class:`TenantSet` — a frozen, hashable bundle of tenants plus the
    ``TENANT_SETS`` registry scenario presets and trace builders refer to
    by name.

Everything downstream keys tenants by *index* (the position in the set):
the multi-tenant trace builder encodes the index into ``job_id`` as
``job_id % n_tenants`` and stamps ``Job.tenant_id``, so every engine —
including the jitted ``serving_jax`` scan, where the tenant count is a
static shape — recovers the tenant without a side table.

Register a tenant set::

    from repro_torch.tenancy import TenantSet, TenantSpec, register_tenant_set

    register_tenant_set(TenantSet("mine", (
        TenantSpec("steady", rate_share=0.5, arrival="poisson",
                   slo_p99_wait_s=60.0, credit_rate=0.5, credit_burst=600.0),
        TenantSpec("bursty", rate_share=0.5, arrival="flash_crowd",
                   arrival_kwargs=(("spike_mult", 8.0),),
                   slo_p99_wait_s=300.0, credit_rate=0.5,
                   credit_burst=600.0),
    )))

then point a scenario at it (``trace_kwargs=dict(tenant_set="mine")`` on
the ``multi_tenant`` builder, ``policy_kwargs=dict(tenant_set="mine")``
on ``tenant_guard``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

__all__ = ["TenantSpec", "TenantSet", "TENANT_SETS", "register_tenant_set",
           "get_tenant_set", "tenant_set_names"]


@dataclass(frozen=True)
class TenantSpec:
    """One tenant sharing the elastic fleet.

    ``rate_share`` is this tenant's fraction of the aggregate calibrated
    arrival rate (shares are normalized across the set, so they need not
    sum to 1). ``arrival`` names an ``ARRIVAL_PROCESSES`` factory; the
    builder injects the tenant's absolute rate into the right parameter
    (``rate_avg`` for ``mmpp_burst``, ``rate`` otherwise) and passes
    ``arrival_kwargs`` through. ``mix`` picks the job-size mix ("yahoo" =
    :class:`~repro_torch.workload.jobmix.TwoClassLognormalMix`, "google" =
    :class:`~repro_torch.workload.jobmix.HeavyTailMix`).

    ``slo_p99_wait_s`` is the promise: p99 short-request wait at or below
    this many seconds (``slo_attainment`` = fraction of requests meeting
    it). ``credit_rate`` / ``credit_burst`` parameterize the token bucket
    in :mod:`repro_torch.tenancy.admission`: credits refill at ``credit_rate``
    work-units per engine time unit up to a depth of ``credit_burst``,
    and every placement costs a request's service demand — an over-credit
    tenant is confined to its home slice of the general partition (see
    ``repro_torch.sched.policy.TenantGuardProbing``).
    """

    name: str
    rate_share: float = 1.0
    arrival: str = "mmpp_burst"
    arrival_kwargs: Tuple[Tuple[str, float], ...] = ()
    mix: str = "yahoo"
    mix_kwargs: Tuple[Tuple[str, float], ...] = ()
    slo_p99_wait_s: float = 120.0
    credit_rate: float = 1.0
    credit_burst: float = 300.0

    def arrival_process(self, rate: float):
        """Instantiate this tenant's arrival process at absolute ``rate``."""
        from repro_torch.workload.arrivals import make_arrival_process

        kwargs = dict(self.arrival_kwargs)
        key = "rate_avg" if self.arrival == "mmpp_burst" else "rate"
        kwargs[key] = rate
        return make_arrival_process(self.arrival, **kwargs)

    def job_mix(self):
        from repro_torch.workload.jobmix import HeavyTailMix, TwoClassLognormalMix

        mixes = {"yahoo": TwoClassLognormalMix, "google": HeavyTailMix}
        try:
            cls = mixes[self.mix]
        except KeyError:
            raise ValueError(f"unknown job mix {self.mix!r}; "
                             f"expected one of {sorted(mixes)}") from None
        return cls(**dict(self.mix_kwargs))


@dataclass(frozen=True)
class TenantSet:
    """A named, ordered bundle of tenants — the unit scenarios refer to."""

    name: str
    tenants: Tuple[TenantSpec, ...]

    def __post_init__(self):
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in set "
                             f"{self.name!r}: {names}")

    @property
    def n_tenants(self) -> int:
        return len(self.tenants)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(t.name for t in self.tenants)

    def shares(self) -> Tuple[float, ...]:
        total = sum(t.rate_share for t in self.tenants)
        return tuple(t.rate_share / total for t in self.tenants)

    def slo_targets_s(self) -> Tuple[float, ...]:
        return tuple(t.slo_p99_wait_s for t in self.tenants)

    def credit_rates(self) -> Tuple[float, ...]:
        return tuple(t.credit_rate for t in self.tenants)

    def credit_bursts(self) -> Tuple[float, ...]:
        return tuple(t.credit_burst for t in self.tenants)

    def index(self, name: str) -> int:
        for i, t in enumerate(self.tenants):
            if t.name == name:
                return i
        raise KeyError(f"no tenant {name!r} in set {self.name!r}")


#: name → TenantSet registry (trace builders / policies resolve by name)
TENANT_SETS: Dict[str, TenantSet] = {}


def register_tenant_set(ts: TenantSet) -> TenantSet:
    TENANT_SETS[ts.name] = ts
    return ts


def get_tenant_set(name: str) -> TenantSet:
    try:
        return TENANT_SETS[name]
    except KeyError:
        raise ValueError(f"unknown tenant set {name!r}; "
                         f"registered: {sorted(TENANT_SETS)}") from None


def tenant_set_names() -> Tuple[str, ...]:
    return tuple(sorted(TENANT_SETS))


# ------------------------------------------------------------------ presets

#: the canonical 3-tenant evaluation set: a steady Poisson tenant with a
#: tight SLO, a flash-crowd tenant whose spikes are the fairness stressor,
#: and a heavy-tailed (google-mix) tenant on MMPP arrivals. Credit rates
#: are each tenant's fair share of the quick-scale short-partition work
#: rate (``short_util * n_short = 0.6 * 8``) with ~25% headroom, so a
#: tenant arriving at its share never drains its bucket while a multi-x
#: spike exhausts the ``credit_burst`` depth (work-seconds of burst above
#: the paid rate) shortly after onset. Budgets are absolute paid rates —
#: the fairness-frontier benchmark sweeps a scale factor on them.
register_tenant_set(TenantSet("trio", (
    TenantSpec("steady", rate_share=0.45, arrival="poisson",
               slo_p99_wait_s=90.0, credit_rate=2.7, credit_burst=600.0),
    TenantSpec("bursty", rate_share=0.35, arrival="flash_crowd",
               arrival_kwargs=(("spike_mult", 6.0),
                               ("spike_duration", 1200.0),
                               ("n_spikes", 3)),
               slo_p99_wait_s=300.0, credit_rate=2.1, credit_burst=300.0),
    TenantSpec("heavytail", rate_share=0.2, arrival="mmpp_burst",
               arrival_kwargs=(("burst_mult", 5.0), ("calm_frac", 0.8)),
               # max_tasks=100: at quick scale a single 500-task job is a
               # fifth of the whole trace and its sampling noise drowns
               # every load knob
               mix="google", mix_kwargs=(("max_tasks", 100),),
               slo_p99_wait_s=180.0, credit_rate=1.2, credit_burst=300.0),
)))

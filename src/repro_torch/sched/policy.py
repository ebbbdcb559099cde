"""Placement policies — every scheduling decision the DES makes, as
swappable objects.

The discrete-event engine (``repro_torch.core.engine``) is a thin event loop; the
*policy* layer here decides where tasks go:

  * :class:`LeastLoadedCentral` — the centralized long-job scheduler
    (least-loaded over the general partition, lazy min-heap);
  * :class:`EagleProbing` — decentralized short-task probing (power-of-d
    with Eagle's succinct-state long-avoidance, falling back to the
    short-only partition);
  * :class:`BurstGuardProbing` — BoPF-inspired burst guard (Le et al. 2019):
    per-class admission control on the short partition so one bursty job
    cannot monopolize the protected servers;
  * :class:`TenantGuardProbing` — the per-tenant generalization: token-
    bucket burst credits (``repro_torch.tenancy``) gate the fallback, throttling
    over-credit tenants to their fair general share;
  * :class:`SpotAwareProbing` — spot/burstable-aware placement (Teylo et
    al. 2020): biases the fallback away from transient servers in
    proportion to the expected rework cost of a revocation.

Policies see the cluster through the duck-typed view the engine passes to
:meth:`PlacementPolicy.bind` — it must expose ``servers``, ``general_ids``,
``short_pool()``, ``rng`` and ``cfg``. The same objects therefore drive unit
tests with hand-built clusters.

Slot-aware views (the serving fleet's continuous-batching replicas) extend
the per-server protocol: ``pending_work`` is *effective* drain time (queued
decode ticks divided by the replica's slot count, so probes compare real
headroom rather than a replica-count proxy), ``n_slots`` / ``free_slots``
report batching headroom, and ``running_tasks`` lists every slot-resident
task where single-task servers expose only ``running`` — policies that scan
running work must go through :func:`running_entries` so both server shapes
count correctly.

Each short policy also exposes :meth:`ShortPlacementPolicy.fluid_params`
— its aggregate (fluid-model) signature consumed by
``repro_torch.core.simjax.simulate_fluid`` — so every policy runs in both the DES
and the fluid sweep engine.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Type


@dataclass(frozen=True)
class FluidPolicyParams:
    """Aggregate form of a short-placement policy for the fluid simulator.

    Defaults are the identity (plain Eagle probing): the fluid step with
    default params is bit-identical to the historical hardcoded model.

      backlog_partition_share — burst guard: at most this share of the
        protected short-partition capacity may be spent draining *standing*
        backlog per slot (fresh arrivals always admit first); the rest of
        the backlog waits for idle general capacity. 1.0 = no guard.
      transient_availability — spot awareness: transients count at this
        fraction of a stable server when serving shorts (expected uptime
        under revocations). 1.0 = fully trusted.
    """

    backlog_partition_share: float = 1.0
    transient_availability: float = 1.0

    @property
    def is_identity(self) -> bool:
        return (self.backlog_partition_share >= 1.0
                and self.transient_availability >= 1.0)


def project_fluid_params(*, backlog_share: float = 1.0,
                         mttf: float = 0.0, sim_config=None,
                         ) -> FluidPolicyParams:
    """The one fluid projection every short policy shares.

    ``backlog_share`` caps the protected partition's standing-backlog
    drain share (BurstGuard / TenantGuard admission aggregates to this);
    a positive ``mttf`` discounts transient capacity by the expected
    availability over one provisioning period (SpotAware), reading the
    replacement delay off ``sim_config``. Defaults produce the identity
    (plain Eagle)."""
    availability = 1.0
    if mttf > 0:
        # expected availability of a transient over a provisioning period
        # (the time lost replacing a revoked server)
        delay = getattr(sim_config, "provisioning_delay", 120.0)
        availability = mttf / (mttf + delay)
    return FluidPolicyParams(backlog_partition_share=backlog_share,
                             transient_availability=availability)


def running_entries(server) -> tuple:
    """Every running task tuple on a server, slot-aware.

    Multi-slot serving replicas run several concurrent decodes and expose
    them as ``running_tasks``; single-task servers (the DES ``Server``)
    expose only ``running``. Per-class accounting (BurstGuard's backlog
    share) must count all slot residents, not a one-task proxy — a
    single-slot view's ``running_tasks`` degenerates to exactly the one
    entry ``running`` reports."""
    tasks = getattr(server, "running_tasks", None)
    if tasks is not None:
        return tuple(tasks)
    r = server.running
    return () if r is None else (r,)


class PlacementPolicy:
    """Base: a policy is bound to one cluster view, then queried per task."""

    name = "abstract"

    def bind(self, cluster) -> "PlacementPolicy":
        self._cluster = cluster
        return self

    def select(self, dur: float, job_id: int) -> int:
        raise NotImplementedError


class LeastLoadedCentral(PlacementPolicy):
    """Centralized long-job scheduler: least-loaded general server.

    Keeps a lazy min-heap over ``pending_work``: stale entries are dropped
    on pop (the stored key no longer matches the server), and the engine
    notifies the policy on placement and on every general-server task finish
    so fresh keys re-enter the heap.
    """

    name = "least_loaded_central"

    def bind(self, cluster) -> "LeastLoadedCentral":
        super().bind(cluster)
        self._heap = [(0.0, sid) for sid in cluster.general_ids]
        heapq.heapify(self._heap)
        return self

    def select(self, dur: float, job_id: int) -> int:
        servers = self._cluster.servers
        while True:
            work, sid = heapq.heappop(self._heap)
            s = servers[sid]
            if math.isclose(work, s.pending_work, rel_tol=0, abs_tol=1e-9):
                return sid
            heapq.heappush(self._heap, (s.pending_work, sid))

    def placed(self, sid: int) -> None:
        heapq.heappush(self._heap,
                       (self._cluster.servers[sid].pending_work, sid))

    def task_finished(self, sid: int) -> None:
        heapq.heappush(self._heap,
                       (self._cluster.servers[sid].pending_work, sid))


class ShortPlacementPolicy(PlacementPolicy):
    """Base for decentralized short-task policies (adds the fluid adapter).

    ``fluid_params`` may consult the ``SimConfig`` the fluid run mirrors
    (revocation MTTF, provisioning delay) — the same knobs the DES form
    reads off the bound cluster.
    """

    def fluid_params(self, sim_config=None) -> FluidPolicyParams:
        return project_fluid_params()


class EagleProbing(ShortPlacementPolicy):
    """Eagle short-task probing: power-of-d with succinct-state avoidance.

    Probes ``probe_d`` random general servers per round for up to
    ``probe_retries`` rounds, skipping long-occupied servers; if every round
    fails, falls back to the short-only partition (static short + active
    transients) — Eagle's guarantee that shorts never queue behind longs.
    If the short-only pool is empty (``replace_fraction=1.0`` before any
    transient is online) the task goes to the least-loaded general server —
    queueing behind a long beats crashing the scheduler.
    """

    name = "eagle"

    def select(self, dur: float, job_id: int) -> int:
        c = self._cluster
        cfg = c.cfg
        servers = c.servers
        pool = c.general_ids  # shorts may probe anywhere; general is 98%
        best: Optional[int] = None
        for _ in range(cfg.probe_retries):
            cand = c.rng.integers(0, len(pool), cfg.probe_d)
            for i in cand:
                sid = pool[int(i)]
                s = servers[sid]
                if s.long_occupied:
                    continue
                if best is None or s.pending_work < servers[best].pending_work:
                    best = sid
            if best is not None:
                break
        if best is None:
            best = self._fallback(dur, job_id)
        return best

    # ---------------------------------------------------------- fallback path

    def _fallback(self, dur: float, job_id: int) -> int:
        """All probes hit long-occupied servers: use the short-only pool."""
        c = self._cluster
        spool = c.short_pool()
        if not spool:
            return self._least_loaded_general()
        cand = c.rng.integers(0, len(spool), min(c.cfg.probe_d, len(spool)))
        return min((spool[int(i)] for i in cand),
                   key=self._fallback_key(dur))

    def _fallback_key(self, dur: float):
        servers = self._cluster.servers
        return lambda sid: servers[sid].pending_work

    def _least_loaded_general(self) -> int:
        c = self._cluster
        return min(c.general_ids, key=lambda sid: c.servers[sid].pending_work)


class BurstGuardProbing(EagleProbing):
    """BoPF-inspired burst guard on the short-only partition.

    The short partition is the shared safety valve: during bursts, one job
    that fans out thousands of tasks can fill every protected queue and
    starve the other tenants (the burstiness-unfairness BoPF targets). The
    guard tracks, at fallback time, the share of queued short-partition
    tasks belonging to the arriving task's class (``job_id mod n_classes``);
    a class above ``guard_frac`` of the backlog is redirected to the
    least-loaded *unoccupied* general server when one exists. Admission is
    work-conserving: with no free general server the task is admitted
    anyway.
    """

    name = "burst_guard"

    def __init__(self, guard_frac: float = 0.5, n_classes: int = 64,
                 min_backlog: int = 8, scan_cap: int = 256):
        self.guard_frac = guard_frac
        self.n_classes = n_classes
        self.min_backlog = min_backlog
        self.scan_cap = scan_cap  # bounds the per-placement backlog scan

    def _fallback(self, dur: float, job_id: int) -> int:
        c = self._cluster
        spool = c.short_pool()
        if spool and self._over_share(spool, job_id):
            free = [sid for sid in c.general_ids
                    if not c.servers[sid].long_occupied]
            if free:
                return min(free, key=lambda sid: c.servers[sid].pending_work)
        return super()._fallback(dur, job_id)

    def _over_share(self, spool: List[int], job_id: int) -> bool:
        """Estimate this class's share of the short-partition backlog.

        Sampling is capped at ``scan_cap`` queue entries (spread across the
        pool) so a deep burst backlog — exactly when fallbacks are most
        frequent — costs O(cap), not O(backlog), per placement.
        """
        servers = self._cluster.servers
        cls = job_id % self.n_classes
        per_server = max(self.scan_cap // max(len(spool), 1), 1)
        total = mine = 0
        for sid in spool:
            s = servers[sid]
            for entry in running_entries(s):  # every slot resident counts
                total += 1
                mine += entry[3] % self.n_classes == cls
            for i, entry in enumerate(s.queue):
                if i >= per_server:
                    break
                total += 1
                mine += entry[3] % self.n_classes == cls
        return total >= self.min_backlog and mine > self.guard_frac * total

    def fluid_params(self, sim_config=None) -> FluidPolicyParams:
        return project_fluid_params(backlog_share=self.guard_frac)


class TenantGuardProbing(EagleProbing):
    """Per-tenant token-bucket admission on the short-only partition
    (BoPF done properly — the generalization of :class:`BurstGuardProbing`
    from one aggregate backlog share to per-tenant burst credits).

    Every tenant owns a :class:`repro_torch.tenancy.admission.TokenBucket` that
    refills at (roughly) the tenant's fair share of short-partition
    capacity in work per engine time unit. *Every* placement pays the
    request's service demand from the owning tenant's bucket (tenant =
    ``job_id % n_tenants``, the encoding the ``multi_tenant`` builder
    guarantees), so the bucket level tracks offered load relative to the
    paid rate: a tenant arriving below its credit rate never drains its
    bucket, while a flash crowd at several times the rate exhausts the
    ``credit_burst`` depth within seconds of spike onset. A funded
    request routes like plain Eagle (probe anywhere, fall back to the
    transient pool); an over-credit tenant is *throttled* — confined to
    its *home slice* of the general partition
    (``server_id % n_tenants == tenant``). Confinement is what makes
    throttling fair rather than merely work-moving: an over-credit spike
    self-queues on the owner's own 1/n of the static servers instead of
    spreading across the replicas every other tenant's traffic rides on.
    Admission stays work-conserving: with no free home-slice server the
    request routes normally (and nothing is debited).

    The engines drive the bucket clock via :meth:`advance` (guarded
    ``getattr`` — other policies don't carry one) and read
    ``n_throttled`` deltas to emit THROTTLE events at the decision site.
    """

    name = "tenant_guard"

    def __init__(self, tenant_set=None, n_tenants: int = 1,
                 credit_rate=1.0, credit_burst=300.0,
                 guard_frac: float = 0.5):
        from repro_torch.tenancy import TenantCredits, get_tenant_set

        if tenant_set is not None:
            ts = get_tenant_set(tenant_set) if isinstance(tenant_set, str) \
                else tenant_set
            n_tenants = ts.n_tenants
            credit_rate = ts.credit_rates()
            credit_burst = ts.credit_bursts()
        self.n_tenants = int(n_tenants)
        rates = self._vec(credit_rate)
        bursts = self._vec(credit_burst)
        self.credits = TenantCredits(rates, bursts)
        self.guard_frac = guard_frac
        self.n_throttled = 0

    def _vec(self, v):
        if isinstance(v, (int, float)):
            return [float(v)] * self.n_tenants
        out = [float(x) for x in v]
        if len(out) != self.n_tenants:
            raise ValueError(f"expected {self.n_tenants} per-tenant values, "
                             f"got {len(out)}")
        return out

    def advance(self, t: float) -> None:
        """Refill every tenant's bucket up to engine time ``t``."""
        self.credits.advance(t)

    def scale_costs(self, cost_scale: float) -> "TenantGuardProbing":
        """Move the buckets into a different cost unit (work-seconds ->
        work-ticks: ``cost_scale = 1 / tick_s``). Refill rates are work
        per unit *time* and both units rescale together, so only the
        depths change. Resets the buckets (call before a run starts)."""
        from repro_torch.tenancy import TenantCredits

        self.credits = TenantCredits(
            [b.rate for b in self.credits.buckets],
            [b.burst * cost_scale for b in self.credits.buckets])
        return self

    def select(self, dur: float, job_id: int) -> int:
        tid = job_id % self.n_tenants
        if not self.credits.try_spend(tid, dur):
            c = self._cluster
            home = [sid for sid in c.general_ids
                    if sid % self.n_tenants == tid
                    and not c.servers[sid].long_occupied]
            if home:
                self.n_throttled += 1
                return min(home, key=lambda sid: c.servers[sid].pending_work)
        return super().select(dur, job_id)

    def fluid_params(self, sim_config=None) -> FluidPolicyParams:
        return project_fluid_params(backlog_share=self.guard_frac)


class SpotAwareProbing(EagleProbing):
    """Spot-aware fallback: price revocation risk into transient placement.

    Following the bag-of-tasks-on-spot literature (Teylo et al. 2020), a
    task placed on a transient server risks losing ``wait + dur`` seconds of
    progress if the server is revoked first; with exponential revocations
    (MTTF ``m``) the expected rework is ~``dur * (pending + dur) / m``. The
    fallback choice minimizes ``pending_work + risk_weight * rework`` so
    transients still absorb bursts but long tasks and deep queues prefer
    stable servers.
    """

    name = "spot_aware"

    def __init__(self, risk_weight: float = 1.0,
                 mttf_override: Optional[float] = None):
        self.risk_weight = risk_weight
        self.mttf_override = mttf_override

    def _mttf(self) -> float:
        if self.mttf_override is not None:
            return self.mttf_override
        m = getattr(self._cluster.cfg, "revocation_mttf", 0.0)
        return m if m > 0 else math.inf

    def _fallback_key(self, dur: float):
        servers = self._cluster.servers
        mttf = self._mttf()

        def key(sid: int) -> float:
            s = servers[sid]
            if s.kind != "transient" or math.isinf(mttf):
                return s.pending_work
            rework = dur * (s.pending_work + dur) / mttf
            return s.pending_work + self.risk_weight * rework

        return key

    def fluid_params(self, sim_config=None) -> FluidPolicyParams:
        mttf = self.mttf_override or getattr(sim_config, "revocation_mttf",
                                             0.0)
        return project_fluid_params(mttf=mttf, sim_config=sim_config)


# registry-parity lint rule: every entry must keep a callable
# fluid_params() (the base identity counts) or be named in
# repro_torch.analysis.rules.FLUID_EXEMPT — the fluid engine calibrates against
# whatever lands here
SHORT_POLICIES: Dict[str, Type[ShortPlacementPolicy]] = {
    EagleProbing.name: EagleProbing,
    BurstGuardProbing.name: BurstGuardProbing,
    TenantGuardProbing.name: TenantGuardProbing,
    SpotAwareProbing.name: SpotAwareProbing,
}

LONG_POLICIES: Dict[str, Type[PlacementPolicy]] = {
    LeastLoadedCentral.name: LeastLoadedCentral,
}


def make_short_policy(name: str, **kwargs) -> ShortPlacementPolicy:
    try:
        return SHORT_POLICIES[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown short policy {name!r}; "
                         f"registered: {sorted(SHORT_POLICIES)}") from None


def make_long_policy(name: str = LeastLoadedCentral.name, **kwargs
                     ) -> PlacementPolicy:
    try:
        return LONG_POLICIES[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown long policy {name!r}; "
                         f"registered: {sorted(LONG_POLICIES)}") from None

"""Scenario registry: named ``trace x policy x SimConfig`` presets.

Every experiment surface (``repro_torch.launch.sim``, ``benchmarks/run.py``,
``examples/trace_replay.py``, tests) builds its runs from this registry
instead of hand-assembling configs, so "the paper's r=3 setup" means the
same thing everywhere.

  from repro_torch.sched import get_scenario, scenario_names
  res = get_scenario("coaster_r3").run(quick=True)

Scenarios scale between the paper's full configuration (4000 servers /
80 short / 24 h) and a quick CI-sized one (400 / 8 / 4 h) via the ``quick``
flag; ``trace_overrides`` / ``sim_overrides`` tweak individual knobs
(e.g. the paper-band burst calibration in benchmarks/fig3).

Registering a new scenario::

  register_scenario(Scenario(
      name="my_policy_r3", description="...",
      sim_kwargs=dict(replace_fraction=0.5, cost_ratio=3.0),
      short_policy="burst_guard", policy_kwargs=dict(guard_frac=0.4)))
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, replace
from typing import Dict, List, Optional, Tuple

from repro_torch.core.cluster import SimConfig
from repro_torch.sched.controller import ControllerSpec
from repro_torch.sched.policy import (FluidPolicyParams, PlacementPolicy,
                                ShortPlacementPolicy, make_long_policy,
                                make_short_policy)

#: paper §4 evaluation scale and the CI-sized reduction used by --quick paths
PAPER_SCALE = dict(n_servers=4000, n_short=80, horizon=24 * 3600.0)
QUICK_SCALE = dict(n_servers=400, n_short=8, horizon=4 * 3600.0)


@dataclass(frozen=True)
class Scenario:
    """A named, reproducible experiment preset."""

    name: str
    description: str = ""
    trace_fn: str = "yahoo_like"
    trace_kwargs: Dict = field(default_factory=dict)
    sim_kwargs: Dict = field(default_factory=dict)
    long_policy: str = "least_loaded_central"
    short_policy: str = "eagle"
    policy_kwargs: Dict = field(default_factory=dict)
    drain_preference: str = "least_loaded"
    #: serving-engine-only knobs (ServingFleetConfig fields that have no
    #: SimConfig counterpart, e.g. pin_scale / n_reserve / hedge_factor)
    serving_kwargs: Dict = field(default_factory=dict)

    # ------------------------------------------------------------- components

    def scale(self, quick: bool = False) -> Dict:
        return dict(QUICK_SCALE if quick else PAPER_SCALE)

    def trace_params(self, *, quick: bool = False, seed: int = 42,
                     trace_overrides: Optional[Dict] = None) -> Dict:
        """The full kwargs ``trace()`` passes to the builder — the single
        merge point shared with cached synthesis (``sim.py --trace-cache``)."""
        return {"seed": seed, **self.scale(quick), **self.trace_kwargs,
                **(trace_overrides or {})}

    def trace(self, *, quick: bool = False, seed: int = 42,
              trace_overrides: Optional[Dict] = None):
        import repro_torch.traces as traces

        kw = self.trace_params(quick=quick, seed=seed,
                               trace_overrides=trace_overrides)
        return getattr(traces, self.trace_fn)(**kw)

    def sim_config(self, *, quick: bool = False, seed: int = 0,
                   sim_overrides: Optional[Dict] = None) -> SimConfig:
        sc = self.scale(quick)
        kw = dict(n_servers=sc["n_servers"], n_short_reserved=sc["n_short"],
                  seed=seed, **self.sim_kwargs)
        kw.update(sim_overrides or {})
        bad = set(kw) - {f.name for f in fields(SimConfig)}
        if bad:  # a clear error beats SimConfig's opaque TypeError
            raise ValueError(
                f"override(s) {sorted(bad)} are not SimConfig fields; "
                f"serving-only knobs (max_slots, n_reserve, pin_scale, ...) "
                f"apply only to engine='serving'")
        return SimConfig(**kw)

    def policies(self) -> Tuple[PlacementPolicy, ShortPlacementPolicy]:
        return (make_long_policy(self.long_policy),
                make_short_policy(self.short_policy, **self.policy_kwargs))

    def controller(self, cfg: SimConfig) -> ControllerSpec:
        return ControllerSpec.from_sim_config(
            cfg, drain_preference=self.drain_preference)

    # ------------------------------------------------------------------- runs

    def run(self, *, quick: bool = False, seed: int = 42, sim_seed: int = 0,
            trace=None, trace_overrides: Optional[Dict] = None,
            sim_overrides: Optional[Dict] = None, recorder=None):
        """Run the DES for this scenario; returns ``SimResult``.

        ``trace`` short-circuits trace synthesis so several scenarios can
        share one workload (the fig3/table1 pattern).  ``recorder`` (an
        ``repro_torch.obs.EventRecorder``) captures the scheduler event stream.
        """
        from repro_torch.core.engine import simulate

        if trace is None:
            trace = self.trace(quick=quick, seed=seed,
                               trace_overrides=trace_overrides)
        cfg = self.sim_config(quick=quick, seed=sim_seed,
                              sim_overrides=sim_overrides)
        long_pol, short_pol = self.policies()
        return simulate(trace, cfg, long_policy=long_pol,
                        short_policy=short_pol,
                        controller=self.controller(cfg),
                        recorder=recorder)

    def serving_config(self, *, quick: bool = False,
                       sim_overrides: Optional[Dict] = None):
        """Resolve a :class:`~repro_torch.runtime.serving.ServingFleetConfig` for
        ``repro_torch.exp.run(..., engine="serving")``.

        Shared knobs (threshold, provisioning_delay, revocation_mttf,
        probe_*) and the transient budget K = r * N_s * p flow through the
        scenario's ``SimConfig`` — the fleet is sized like the short
        partition (N_s replicas) and pinning is scaled against the general
        partition. Serving-only keys in ``sim_overrides`` (``max_transient``,
        ``n_reserve``, ``pin_scale``, ...) override ``serving_kwargs``, so
        they work as pointwise ``sweep`` axes.
        """
        from dataclasses import fields as _fields

        from repro_torch.runtime.serving import ServingFleetConfig

        over = dict(sim_overrides or {})
        sim_fields = {f.name for f in _fields(SimConfig)}
        serve_fields = {f.name for f in _fields(ServingFleetConfig)}
        serve_over = {k: over.pop(k) for k in list(over)
                      if k in serve_fields - sim_fields}
        cfg = self.sim_config(quick=quick, sim_overrides=over)
        kw = dict(n_replicas=cfg.n_short_reserved,
                  max_transient=cfg.max_transient,
                  threshold=cfg.threshold,
                  provisioning_delay=cfg.provisioning_delay,
                  revocation_mttf=cfg.revocation_mttf,
                  probe_d=cfg.probe_d, probe_retries=cfg.probe_retries,
                  n_general_ref=cfg.n_general)
        kw.update(self.serving_kwargs)
        kw.update(serve_over)
        return ServingFleetConfig(**kw)

    def fluid_params(self, *, quick: bool = False) -> FluidPolicyParams:
        pol = make_short_policy(self.short_policy, **self.policy_kwargs)
        return pol.fluid_params(self.sim_config(quick=quick))

    def fluid_setup(self, *, quick: bool = False, seed: int = 42,
                    dt: float = 10.0, trace=None,
                    trace_overrides: Optional[Dict] = None,
                    sim_overrides: Optional[Dict] = None):
        """(long_work, short_work, FluidConfig, controller kwargs) for the
        torch fluid simulator — same scenario, fluid mode."""
        from repro_torch.core.simtorch import FluidConfig, trace_to_rates

        if trace is None:
            trace = self.trace(quick=quick, seed=seed,
                               trace_overrides=trace_overrides)
        cfg = self.sim_config(quick=quick, sim_overrides=sim_overrides)
        lw, sw = trace_to_rates(trace, dt)
        # heterogeneous speeds project into the fluid model as effective
        # general capacity (n_general servers at the mean service speed)
        n_general_eff = int(round(cfg.n_general * cfg.mean_general_speed))
        fcfg = FluidConfig(
            n_general=n_general_eff, n_static_short=cfg.n_static_short,
            dt=dt, provision_slots=max(int(cfg.provisioning_delay // dt), 1))
        ctrl = dict(threshold=cfg.threshold, max_transient=cfg.max_transient)
        return lw, sw, fcfg, ctrl


# ---------------------------------------------------------------- registry

_REGISTRY: Dict[str, Scenario] = {}


def register_scenario(sc: Scenario, *, overwrite: bool = False) -> Scenario:
    if sc.name in _REGISTRY and not overwrite:
        raise ValueError(f"scenario {sc.name!r} already registered")
    _REGISTRY[sc.name] = sc
    return sc


def get_scenario(name: str, **overrides) -> Scenario:
    try:
        sc = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; "
                         f"registered: {scenario_names()}") from None
    return replace(sc, **overrides) if overrides else sc


def scenario_names() -> List[str]:
    return sorted(_REGISTRY)


def _coaster(r: float, **kw) -> Dict:
    return dict(sim_kwargs=dict(replace_fraction=0.5, cost_ratio=r, **kw))


register_scenario(Scenario(
    name="eagle",
    description="Eagle baseline: hybrid placement, no transient manager"))
for _r in (1, 2, 3):
    register_scenario(Scenario(
        name=f"coaster_r{_r}",
        description=f"CloudCoaster p=0.5 r={_r} (paper §4)",
        **_coaster(float(_r))))
register_scenario(Scenario(
    name="coaster_r3_paperband",
    description="r=3 on the milder burst calibration that lands in the "
                "paper's 4.8x improvement band",
    trace_kwargs=dict(burst_mult=2.5, long_util=0.96),
    **_coaster(3.0)))
register_scenario(Scenario(
    name="burst_guard_r3",
    description="r=3 with BoPF-style per-class short-partition admission",
    short_policy="burst_guard", policy_kwargs=dict(guard_frac=0.5),
    **_coaster(3.0)))
register_scenario(Scenario(
    name="spot_r3",
    description="r=3 under spot revocations (2 h MTTF) with risk-priced "
                "placement and oldest-first drain",
    short_policy="spot_aware", policy_kwargs=dict(mttf_override=7200.0),
    drain_preference="oldest",
    **_coaster(3.0, revocation_mttf=7200.0)))

# ---------------- workload-subsystem scenarios (repro_torch.workload builders) ----

register_scenario(Scenario(
    name="google_eagle",
    description="Eagle baseline on the Google heavy-tail trace (Fig. 1 "
                "workload; tasks-per-job up to ~50k)",
    trace_fn="google_like"))
register_scenario(Scenario(
    name="google_r3",
    description="CloudCoaster p=0.5 r=3 on the Google heavy-tail trace",
    trace_fn="google_like", **_coaster(3.0)))
register_scenario(Scenario(
    name="diurnal_r3",
    description="r=3 on diurnal x MMPP arrivals (Alibaba-style day/night "
                "envelope, peak 1.6x mean)",
    trace_fn="diurnal_like", **_coaster(3.0)))
register_scenario(Scenario(
    name="flash_crowd_r3",
    description="r=3 with burst-guard admission under flash-crowd spikes "
                "(8x rate for 30 min windows; BoPF's bursty-tenant regime)",
    trace_fn="flash_crowd_like",
    short_policy="burst_guard", policy_kwargs=dict(guard_frac=0.5),
    **_coaster(3.0)))
register_scenario(Scenario(
    name="hetero_speed_r3",
    description="r=3 with heterogeneous server speeds (30% of the general "
                "partition at 0.6x) — co-located-hardware regime",
    **_coaster(3.0, hetero_slow_frac=0.3, hetero_slow_speed=0.6)))
# ---------------- serving-engine scenarios (repro_torch.runtime.serving) ---------
#
# Runnable on all three engines; engine="serving" maps short tasks to decode
# requests and the long class to replica pinning (see Scenario.serving_config
# and repro_torch.runtime.serving.build_serving_workload).  The serving fleet is
# short-partition-sized, so the controller's transient rentals are what keep
# request delay bounded while long jobs pin most of the pods.

#: shared serving calibration: p=0.5 r=3 budget, pod-level threshold 0.5
#: (the fleet is short-partition-sized, so the controller must keep roughly
#: one serving replica per pinned replica), fast (30 s) provisioning.
#: ``pin_scale`` calibrates the trace's offered long concurrency onto pod
#: co-location pressure; tuned per trace so pinning saturates during bursts.
_SERVE = dict(replace_fraction=0.5, cost_ratio=3.0, threshold=0.5,
              provisioning_delay=30.0)

register_scenario(Scenario(
    name="serve_yahoo",
    description="elastic serving fleet on the Yahoo bursty trace: short "
                "tasks as decode requests, long class pins replicas "
                "(engine='serving')",
    sim_kwargs=dict(_SERVE),
    serving_kwargs=dict(pin_scale=1.3)))
register_scenario(Scenario(
    name="serve_flash_crowd",
    description="serving fleet under flash-crowd request spikes with "
                "BurstGuard per-class admission on request routing",
    trace_fn="flash_crowd_like",
    short_policy="burst_guard", policy_kwargs=dict(guard_frac=0.5),
    sim_kwargs=dict(_SERVE),
    serving_kwargs=dict(pin_scale=2.2)))
register_scenario(Scenario(
    name="serve_batched_yahoo",
    description="serve_yahoo with slot-level continuous batching: every "
                "replica decodes up to 4 concurrent requests "
                "(max_slots=4, admit-on-free-slot)",
    sim_kwargs=dict(_SERVE),
    serving_kwargs=dict(pin_scale=1.3, max_slots=4)))
register_scenario(Scenario(
    name="serve_batched_flash_crowd",
    description="flash-crowd serving with BurstGuard per-class admission "
                "over 4-slot continuous-batching replicas",
    trace_fn="flash_crowd_like",
    short_policy="burst_guard", policy_kwargs=dict(guard_frac=0.5),
    sim_kwargs=dict(_SERVE),
    serving_kwargs=dict(pin_scale=2.2, max_slots=4)))
register_scenario(Scenario(
    name="serve_spot",
    description="serving fleet on spot transients (1 h MTTF): "
                "revocation-priced routing, §3.3 hedge duplication to the "
                "on-demand reserve, oldest-first drain",
    short_policy="spot_aware",
    drain_preference="oldest",
    sim_kwargs=dict(_SERVE, revocation_mttf=3600.0),
    serving_kwargs=dict(pin_scale=1.3)))

#: the multi-tenant serving calibration: ``long_util=0.4`` keeps the
#: request load on the short-sized fleet moderate (Eagle steady-tenant
#: attainment ~0.5 at quick scale) so routing — not a capacity deficit —
#: decides who meets their SLO; at the default 0.9 every tenant drowns
#: (attainment ~0.2) and no admission policy can tell them apart.
_TRIO_TRACE = dict(tenant_set="trio", long_util=0.4)

register_scenario(Scenario(
    name="serve_tenant_trio",
    description="3-tenant serving fleet (steady / bursty / heavy-tail) with "
                "TenantGuard per-tenant burst credits on request routing "
                "and SLO-debt-aware drain/hedge victim selection",
    trace_fn="multi_tenant",
    trace_kwargs=dict(_TRIO_TRACE),
    short_policy="tenant_guard", policy_kwargs=dict(tenant_set="trio"),
    sim_kwargs=dict(_SERVE),
    serving_kwargs=dict(pin_scale=1.3)))
register_scenario(Scenario(
    name="serve_tenant_trio_eagle",
    description="the trio tenant mix on plain Eagle routing — the "
                "no-credit baseline the fairness frontier compares against",
    trace_fn="multi_tenant",
    trace_kwargs=dict(_TRIO_TRACE),
    sim_kwargs=dict(_SERVE),
    serving_kwargs=dict(pin_scale=1.3)))

register_scenario(Scenario(
    name="spot_diurnal_r3",
    description="r=3 spot-aware under diurnal arrivals with 2 h MTTF "
                "revocations — transient risk moves with the daily peak",
    trace_fn="diurnal_like",
    short_policy="spot_aware", policy_kwargs=dict(mttf_override=7200.0),
    drain_preference="oldest",
    **_coaster(3.0, revocation_mttf=7200.0)))

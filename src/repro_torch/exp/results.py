"""Unified experiment result schema — one ``RunResult`` for every engine.

The paper's headline numbers are comparisons *across* engines (DES vs the
JAX fluid model) and parameter grids, so every experiment surface funnels
through this one frozen record:

  * ``engine`` tag + ``scenario`` name + the fully resolved engine config
    and the user-supplied overrides (reproducibility),
  * a scalar ``metrics`` dict with canonical names shared by the DES and
    the fluid adapter (``short_avg_wait_s``, ``short_p90_wait_s``,
    ``avg_active_transients``, ...),
  * optional named time ``series`` (per-task waits, per-slot fluid
    trajectories) — kept, not discarded, and npz-persistable,
  * seed / wall-time provenance.

Adapters: :func:`from_sim_result` (DES — also reachable as
``SimResult.to_run_result``), :func:`from_fluid_output` (the dict
``repro_torch.core.simjax.simulate_fluid`` returns),
:func:`from_serving_fleet` (``repro_torch.runtime.serving.ElasticServingFleet``)
and :func:`from_serving_jax` (the metric/series bundle
``repro_torch.runtime.serving_jax.run_workload`` emits).  Serialization is
deterministic: ``to_json`` sorts keys; ``save``/``load`` round-trip through
JSON (scalars) or flat npz (scalars + series), checked in tests/test_exp.py.
"""

from __future__ import annotations

import json
import pathlib
from dataclasses import asdict, dataclass, field, is_dataclass
from typing import Dict, Optional, Union

import numpy as np

from repro_torch.core.metrics import SimResult, _pctl

SCHEMA_VERSION = 1

#: canonical scalar-metric names every engine adapter must emit (engines may
#: add extras on top — the DES adds long waits and transient lifetimes, the
#: fluid adapter adds ``avg_lr``)
CANONICAL_METRICS = (
    "short_avg_wait_s",
    "short_max_wait_s",
    "short_p50_wait_s",
    "short_p90_wait_s",
    "short_p99_wait_s",
    "avg_active_transients",
    "peak_active_transients",
)

#: per-engine series that must be present and non-empty in a valid persisted
#: RunResult (engines may emit more; e.g. the DES's transient_lifetimes is
#: legitimately empty when no transient was ever rented)
REQUIRED_SERIES = {
    "des": ("short_waits", "lr"),
    "fluid": ("short_delay", "lr"),
    "serving": ("short_waits", "active_transients", "batch_occupancy"),
    "serving_jax": ("short_waits", "active_transients", "batch_occupancy",
                    "event_counts"),
    "serving_torch": ("short_waits", "active_transients", "batch_occupancy",
                      "event_counts"),
}

#: keys ``meta["obs"]`` must carry on a serving_jax result (the
#: ``serving_jax.last_run_obs`` snapshot: jit-cache counters plus the
#: compile/steady wall-time split)
_OBS_KEYS = ("jit_cache", "compile", "steady")


def validate_run_result(rr: "RunResult") -> list:
    """Schema gate for persisted RunResults — the list of violations (empty
    when valid). The CI smoke driver (``repro_torch.launch.smoke``) fails on any
    violation, not just on crashes: canonical metric names present and
    finite, the engine's required series present and non-empty, seed /
    engine provenance set, resolved config recorded."""
    problems = []
    if not rr.engine:
        problems.append("empty engine tag")
    if not rr.scenario:
        problems.append("empty scenario name")
    if rr.schema_version != SCHEMA_VERSION:
        problems.append(f"schema_version {rr.schema_version} != "
                        f"{SCHEMA_VERSION}")
    missing = [m for m in CANONICAL_METRICS if m not in rr.metrics]
    if missing:
        problems.append(f"missing canonical metrics: {missing}")
    bad = [m for m in CANONICAL_METRICS if m in rr.metrics
           and not np.isfinite(rr.metrics[m])]
    if bad:
        problems.append(f"non-finite canonical metrics: {bad}")
    for name in REQUIRED_SERIES.get(rr.engine, ()):
        arr = rr.series.get(name)
        if arr is None:
            problems.append(f"missing series {name!r}")
        elif np.asarray(arr).size == 0:
            problems.append(f"empty series {name!r}")
    if rr.seed is None:
        problems.append("seed (trace provenance) not set")
    if rr.engine in ("des", "serving", "serving_jax", "serving_torch") \
            and rr.sim_seed is None:
        problems.append("sim_seed (engine provenance) not set")
    if not rr.config:
        problems.append("resolved config missing")
    if rr.wall_time_s < 0:
        problems.append(f"negative wall_time_s {rr.wall_time_s}")
    if rr.engine in ("serving_jax", "serving_torch"):
        if "fleet_spec" not in rr.meta:
            problems.append("serving_jax result without meta['fleet_spec'] "
                            "provenance")
        obs = rr.meta.get("obs")
        if not isinstance(obs, dict) or \
                any(k not in obs for k in _OBS_KEYS):
            problems.append("serving_jax result without meta['obs'] "
                            f"telemetry (need keys {list(_OBS_KEYS)})")
    tenants = rr.meta.get("tenants") if isinstance(rr.meta, dict) else None
    if tenants:
        # a tenant-aware run must carry the full per-tenant block: the
        # named p99/SLO metrics, the fairness scalar and the flat
        # (tenant_id, wait_s) series (legitimately empty only when no
        # request ever started)
        need = [f"tenant/{n}/{m}" for n in tenants
                for m in ("p99_wait_s", "slo_attainment")]
        need.append("tenant_jain_fairness")
        t_missing = [m for m in need if m not in rr.metrics]
        if t_missing:
            problems.append(f"tenant-aware result missing metrics: "
                            f"{t_missing}")
        if "tenant_waits" not in rr.series:
            problems.append("tenant-aware result missing series "
                            "'tenant_waits'")
    return problems


def _jsonable(obj):
    """Recursively coerce numpy/JAX scalars so json.dumps is deterministic
    and standard (NaN — e.g. a metric a DES sweep point lacked — becomes
    null, not the non-standard bare ``NaN`` token strict parsers reject)."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return _jsonable(obj.item())
    if isinstance(obj, np.ndarray):
        return _jsonable(obj.tolist())
    if isinstance(obj, float):
        return None if np.isnan(obj) else obj
    if isinstance(obj, (str, int, bool)) or obj is None:
        return obj
    if is_dataclass(obj):
        return _jsonable(asdict(obj))
    return _jsonable(float(obj))  # jax scalars etc.


# ------------------------------------------- shared npz-with-JSON-blob format

def _save_npz(path: pathlib.Path, key: str, meta: Dict,
              arrays: Dict[str, np.ndarray]) -> pathlib.Path:
    """Flat npz with the scalar payload as a JSON blob under ``key`` —
    the one on-disk format RunResult and SweepResult share."""
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix != ".npz":
        path = path.with_suffix(path.suffix + ".npz")
    blob = json.dumps(meta, sort_keys=True, default=float).encode()
    np.savez_compressed(path, **{key: np.frombuffer(blob, np.uint8)},
                        **{k: np.asarray(v) for k, v in arrays.items()})
    return path


def _load_npz(path: pathlib.Path, key: str):
    """-> (meta dict, {array name: array}) saved by :func:`_save_npz`."""
    with np.load(path) as z:
        meta = json.loads(bytes(z[key]).decode())
        arrays = {k: z[k].copy() for k in z.files if k != key}
    return meta, arrays


@dataclass(frozen=True)
class RunResult:
    """One engine run of one scenario, in the unified schema."""

    engine: str
    scenario: str
    config: Dict  # resolved engine configuration (SimConfig / FluidConfig...)
    overrides: Dict  # user-supplied trace/sim overrides, as given
    metrics: Dict[str, float]  # canonical scalar metrics
    series: Dict[str, np.ndarray] = field(default_factory=dict)
    seed: Optional[int] = None  # trace-synthesis seed
    sim_seed: Optional[int] = None  # engine seed (DES RNG)
    quick: bool = False
    wall_time_s: float = 0.0
    meta: Dict = field(default_factory=dict)  # trace stats, engine extras
    schema_version: int = SCHEMA_VERSION

    # ------------------------------------------------------------- readouts

    def cdf(self, key: str = "short_waits", percentiles=None
            ) -> Dict[str, float]:
        """Percentile readout of a named series (``SimResult.wait_cdf``
        compatible — same default percentiles, same empty-input guard).
        An unknown series name raises (a fluid result has ``short_delay``,
        not ``short_waits``) rather than returning an all-zero CDF."""
        if key not in self.series:
            raise KeyError(f"no series {key!r} in this {self.engine} "
                           f"RunResult; available: {sorted(self.series)}")
        percentiles = percentiles or [10, 25, 50, 75, 90, 95, 99, 99.9]
        arr = self.series[key]
        return {f"p{p}": _pctl(arr, p) for p in percentiles}

    def equals(self, other: "RunResult") -> bool:
        """Exact structural equality (dataclass ``==`` is unusable with
        ndarray fields); used by the serialization round-trip tests."""
        if not isinstance(other, RunResult):
            return False
        scalar = ("engine", "scenario", "seed", "sim_seed", "quick",
                  "wall_time_s", "schema_version")
        if any(getattr(self, f) != getattr(other, f) for f in scalar):
            return False
        if (_jsonable(self.config) != _jsonable(other.config)
                or _jsonable(self.overrides) != _jsonable(other.overrides)
                or _jsonable(self.metrics) != _jsonable(other.metrics)
                or _jsonable(self.meta) != _jsonable(other.meta)):
            return False
        if sorted(self.series) != sorted(other.series):
            return False
        return all(np.array_equal(np.asarray(self.series[k]),
                                  np.asarray(other.series[k]))
                   for k in self.series)

    # -------------------------------------------------------- serialization

    def to_json_dict(self, include_series: bool = False) -> Dict:
        d = {
            "schema_version": self.schema_version,
            "engine": self.engine,
            "scenario": self.scenario,
            "config": _jsonable(self.config),
            "overrides": _jsonable(self.overrides),
            "metrics": _jsonable(self.metrics),
            "seed": self.seed,
            "sim_seed": self.sim_seed,
            "quick": self.quick,
            "wall_time_s": float(self.wall_time_s),
            "meta": _jsonable(self.meta),
        }
        if include_series:
            d["series"] = {k: np.asarray(v).tolist()
                           for k, v in self.series.items()}
        else:
            d["series_keys"] = sorted(self.series)
        return d

    def to_json(self, include_series: bool = False) -> str:
        return json.dumps(self.to_json_dict(include_series),
                          sort_keys=True, indent=1, default=float)

    def save(self, path: Union[str, pathlib.Path]) -> pathlib.Path:
        """Persist the full result. ``*.json`` stores everything including
        series as JSON; any other suffix stores flat npz (``.npz`` appended
        if missing) — series as native arrays, scalars as a JSON blob."""
        path = pathlib.Path(path)
        if path.suffix == ".json":
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(self.to_json(include_series=True))
            return path
        return _save_npz(path, "__runresult__",
                         self.to_json_dict(include_series=False),
                         {f"series__{k}": v for k, v in self.series.items()})

    @classmethod
    def _from_json_dict(cls, d: Dict, series: Dict) -> "RunResult":
        return cls(engine=d["engine"], scenario=d["scenario"],
                   config=d.get("config", {}),
                   overrides=d.get("overrides", {}),
                   metrics=d.get("metrics", {}), series=series,
                   seed=d.get("seed"), sim_seed=d.get("sim_seed"),
                   quick=bool(d.get("quick", False)),
                   wall_time_s=float(d.get("wall_time_s", 0.0)),
                   meta=d.get("meta", {}),
                   schema_version=int(d.get("schema_version",
                                            SCHEMA_VERSION)))

    @classmethod
    def load(cls, path: Union[str, pathlib.Path]) -> "RunResult":
        path = pathlib.Path(path)
        if path.suffix == ".json":
            d = json.loads(path.read_text())
            series = {k: np.asarray(v, float)
                      for k, v in d.get("series", {}).items()}
            return cls._from_json_dict(d, series)
        d, arrays = _load_npz(path, "__runresult__")
        series = {k[len("series__"):]: v for k, v in arrays.items()
                  if k.startswith("series__")}
        return cls._from_json_dict(d, series)


# ------------------------------------------------------------ engine adapters

def _trace_meta(trace) -> Dict:
    return {"n_jobs": int(trace.n_jobs), "n_tasks": int(trace.n_tasks),
            "horizon": float(trace.horizon),
            "utilization": float(trace.meta.get("utilization", 0.0))}


def _attach_tenant_block(metrics: Dict, series: Dict, waits_by_tenant,
                         names, slo_targets_s) -> None:
    """Fold the shared per-tenant metric block (p99 / SLO attainment /
    Jain fairness + the flat ``tenant_waits`` series) into an adapter's
    output — one computation for every engine, so cross-engine per-tenant
    comparisons diff like-for-like."""
    from repro_torch.tenancy import tenant_metric_block

    tmetrics, twaits = tenant_metric_block(waits_by_tenant, names,
                                           slo_targets_s)
    metrics.update(tmetrics)
    series["tenant_waits"] = twaits


def from_sim_result(res: SimResult, *, scenario: str, engine: str = "des",
                    overrides: Optional[Dict] = None, quick: bool = False,
                    seed: Optional[int] = None, sim_seed: Optional[int] = None,
                    wall_time_s: float = 0.0, trace=None) -> RunResult:
    """DES adapter: ``SimResult`` -> ``RunResult``.

    ``metrics`` is exactly ``SimResult.summary()`` (same keys, same order,
    same floats — the launcher's DES output stays byte-identical); the full
    per-task wait arrays, transient lifetimes and l_r samples survive as
    named series instead of being dropped.
    """
    lr = np.asarray(res.lr_samples, float)
    lr = lr.reshape(-1, 2) if lr.size else np.empty((0, 2))
    series = {
        "short_waits": np.asarray(res.short_waits, float),
        "long_waits": np.asarray(res.long_waits, float),
        "transient_lifetimes": np.asarray(res.transient_lifetimes, float),
        "lr_t": lr[:, 0].copy(),
        "lr": lr[:, 1].copy(),
    }
    cfg = res.config
    config = asdict(cfg) if is_dataclass(cfg) else dict(cfg or {})
    meta = {**(res.extras or {}),
            "n_revocations": int(res.n_revocations),
            "n_rescheduled": int(res.n_rescheduled)}
    if trace is not None:
        meta["trace"] = _trace_meta(trace)
    metrics = {k: float(v) for k, v in res.summary().items()}
    # multi-tenant DES runs surface per-tenant waits through extras (the
    # raw arrays become the tenant block, not JSON meta payload)
    t_waits = meta.pop("tenant_short_waits", None)
    if t_waits is not None:
        _attach_tenant_block(metrics, series, t_waits, meta["tenants"],
                             meta["tenant_slo_s"])
    if "n_throttled" in meta:
        metrics["n_throttled"] = float(meta["n_throttled"])
    return RunResult(
        engine=engine, scenario=scenario, config=_jsonable(config),
        overrides=dict(overrides or {}),
        metrics=metrics,
        series=series, seed=seed, sim_seed=sim_seed, quick=quick,
        wall_time_s=float(wall_time_s), meta=_jsonable(meta))


def from_fluid_output(out: Dict, *, scenario: str, fluid_config,
                      controller: Optional[Dict] = None, policy=None,
                      overrides: Optional[Dict] = None, quick: bool = False,
                      seed: Optional[int] = None, wall_time_s: float = 0.0,
                      trace=None) -> RunResult:
    """Fluid adapter: ``simulate_fluid`` output dict -> ``RunResult``.

    Canonical names map onto the DES's (``avg_short_delay`` ->
    ``short_avg_wait_s``, ...); the short-wait percentiles come from the
    per-slot delay series through the same ``_pctl`` guard the DES summary
    uses.  Caveat for comparisons: fluid percentiles are over *time slots*,
    DES percentiles over *tasks* — means and maxima are the directly
    comparable pairs (what ``repro_torch.exp.compare`` weights).
    """
    series = {k: np.asarray(v, float)
              for k, v in (out.get("series") or {}).items()}
    delays = series.get("short_delay", np.empty(0))
    metrics = {
        "short_avg_wait_s": float(out["avg_short_delay"]),
        "short_max_wait_s": float(out["max_short_delay"]),
        "short_p50_wait_s": _pctl(delays, 50),
        "short_p90_wait_s": _pctl(delays, 90),
        "short_p99_wait_s": _pctl(delays, 99),
        "avg_active_transients": float(out["avg_transients"]),
        "peak_active_transients": float(out["peak_transients"]),
        "avg_lr": float(out["avg_lr"]),
    }
    config = asdict(fluid_config) if is_dataclass(fluid_config) else dict(
        fluid_config or {})
    config["controller"] = _jsonable(dict(controller or {}))
    if policy is not None:
        config["policy"] = _jsonable(policy)
    meta = {"trace": _trace_meta(trace)} if trace is not None else {}
    return RunResult(
        engine="fluid", scenario=scenario, config=_jsonable(config),
        overrides=dict(overrides or {}), metrics=metrics, series=series,
        seed=seed, sim_seed=None, quick=quick,
        wall_time_s=float(wall_time_s), meta=meta)


def from_serving_fleet(fleet, requests, *, scenario: str, config,
                       workload_meta: Optional[Dict] = None,
                       overrides: Optional[Dict] = None, quick: bool = False,
                       seed: Optional[int] = None,
                       sim_seed: Optional[int] = None,
                       wall_time_s: float = 0.0, trace=None,
                       recorder=None) -> RunResult:
    """Serving adapter: a finished ``ElasticServingFleet`` run over its
    ``Request`` stream -> ``RunResult``.

    ``recorder`` (the ``repro_torch.obs.EventRecorder`` the fleet ran with, if
    any) lands as a per-tick ``event_counts`` series plus per-type totals
    under ``meta["obs"]["events"]`` — the same shape ``serving_jax`` emits,
    so persisted results diff across engines.

    Canonical names map per-request queueing waits (ticks -> seconds via
    ``config.tick_s``) onto the DES's task-wait metrics through the shared
    ``_pctl`` guard; serving extras (hedges, cancellations, revocations,
    transient usage) ride alongside.  Requests never started by run end are
    censored out of the wait metrics and reported as ``n_unfinished``; a run
    where *nothing* started yields finite zeros (the ``_pctl`` empty-input
    convention), never NaN/inf — ``validate_run_result`` rejects non-finite
    canonical metrics, so a crashed adapter can't sneak a NaN through as
    "valid".
    """
    summary = fleet.summary(requests)
    tick_s = float(config.tick_s)
    waits = np.asarray([q.wait for q in requests if q.wait is not None],
                       float) * tick_s
    series = {
        "short_waits": waits,
        "active_transients": np.asarray(fleet.transient_counts, float),
        "transient_lifetimes": np.asarray(fleet.lifetimes, float) * tick_s,
        # per-tick decoded-slots / paid-slot-capacity (continuous batching)
        "batch_occupancy": np.asarray(fleet.batch_occupancy, float),
    }
    wl_meta = dict(workload_meta or {})
    pinned = wl_meta.pop("pinned_per_tick", None)
    if pinned is not None:
        series["pinned_replicas"] = np.asarray(pinned, float)
    metrics = {
        "short_avg_wait_s": float(np.mean(waits)) if waits.size else 0.0,
        "short_max_wait_s": float(np.max(waits)) if waits.size else 0.0,
        "short_p50_wait_s": _pctl(waits, 50),
        "short_p90_wait_s": _pctl(waits, 90),
        "short_p99_wait_s": _pctl(waits, 99),
        "avg_active_transients": float(summary["avg_active_transients"]),
        "peak_active_transients": float(summary["peak_active_transients"]),
        "n_requests": float(summary["n_requests"]),
        "n_done": float(summary["n_done"]),
        "n_unfinished": float(summary["n_requests"] - summary["n_done"]),
        "n_hedges": float(summary["n_hedges"]),
        "n_hedge_cancelled": float(summary["n_hedge_cancelled"]),
        "n_revocations": float(summary["n_revocations"]),
        "n_transients_used": float(summary["n_transients_used"]),
        "avg_transient_lifetime_s": float(summary["avg_lifetime_ticks"])
        * tick_s,
        "avg_slot_occupancy": float(summary["avg_slot_occupancy"]),
        "transient_slot_occupancy": float(
            summary["transient_slot_occupancy"]),
    }
    cfg = asdict(config) if is_dataclass(config) else dict(config or {})
    meta = {"workload": _jsonable(wl_meta)}
    if recorder is not None:
        series["event_counts"] = recorder.counts(fleet._ticks).astype(float)
        meta["obs"] = {"events": recorder.type_counts()}
    if trace is not None:
        meta["trace"] = _trace_meta(trace)
    tenancy = getattr(fleet, "tenancy", None)
    if tenancy is not None:
        _attach_tenant_block(
            metrics, series,
            [np.asarray(w, float) * tick_s for w in tenancy.waits],
            tenancy.names,
            [s * tick_s for s in tenancy.slo_targets])
        meta["tenants"] = list(tenancy.names)
    n_thr = getattr(getattr(fleet, "short_policy", None), "n_throttled",
                    None)
    if n_thr is not None:
        metrics["n_throttled"] = float(n_thr)
    return RunResult(
        engine="serving", scenario=scenario, config=_jsonable(cfg),
        overrides=dict(overrides or {}), metrics=metrics, series=series,
        seed=seed, sim_seed=sim_seed, quick=quick,
        wall_time_s=float(wall_time_s), meta=meta)


def from_serving_jax(metrics: Dict[str, float], series: Dict, *,
                     scenario: str, config, spec=None,
                     workload_meta: Optional[Dict] = None,
                     overrides: Optional[Dict] = None, quick: bool = False,
                     seed: Optional[int] = None,
                     sim_seed: Optional[int] = None,
                     wall_time_s: float = 0.0, trace=None,
                     obs: Optional[Dict] = None) -> RunResult:
    """Serving-JAX adapter: ``repro_torch.runtime.serving_jax.run_workload``
    output -> ``RunResult``.

    ``obs`` is the ``serving_jax.last_run_obs()`` snapshot (jit-cache
    hit/miss counters, compile-vs-steady wall-time split), stored under
    ``meta["obs"]`` — ``validate_run_result`` requires it on serving_jax
    results.

    ``run_workload`` already emits the canonical metric names and the
    ``from_serving_fleet`` series (its ``summarize`` goes through the same
    ``_pctl`` guard), so this adapter only attaches provenance: the resolved
    fleet config, the static :class:`~repro_torch.runtime.serving_jax.FleetSpec`
    (the compiled-program cache key, recorded under ``meta["fleet_spec"]``
    so a persisted result pins its bucketing) and the workload meta.
    """
    series = {k: np.asarray(v, float) for k, v in series.items()}
    wl_meta = dict(workload_meta or {})
    pinned = wl_meta.pop("pinned_per_tick", None)
    if pinned is not None:
        series.setdefault("pinned_replicas", np.asarray(pinned, float))
    cfg = asdict(config) if is_dataclass(config) else dict(config or {})
    meta = {"workload": _jsonable(wl_meta)}
    if spec is not None:
        meta["fleet_spec"] = _jsonable(spec)
    if obs is not None:
        meta["obs"] = _jsonable(obs)
    if trace is not None:
        meta["trace"] = _trace_meta(trace)
    metrics = {k: float(v) for k, v in metrics.items()}
    # tenant-aware runs: the engine already emitted exact per-request
    # (tenant, wait) pairs; name them with the trace meta's tenant list
    names = (trace.meta or {}).get("tenants") if trace is not None else None
    t_waits = series.get("tenant_waits")
    if names and t_waits is not None:
        slo = trace.meta.get("tenant_slo_s", [120.0] * len(names))
        waits_by = [t_waits[t_waits[:, 0] == i, 1]
                    for i in range(len(names))]
        _attach_tenant_block(metrics, series, waits_by, names, slo)
        meta["tenants"] = list(names)
    return RunResult(
        engine="serving_jax", scenario=scenario, config=_jsonable(cfg),
        overrides=dict(overrides or {}),
        metrics=metrics, series=series,
        seed=seed, sim_seed=sim_seed, quick=quick,
        wall_time_s=float(wall_time_s), meta=meta)

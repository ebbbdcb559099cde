"""The one experiment entry point: ``run(scenario, engine=...)`` and grid
``sweep(scenario, grid, engine=...)``.

Engines are pluggable adapters registered in this package's own registry
(``des`` — the exact discrete-event simulator, ``fluid`` — the slotted
fluid model as a torch program, on ``cuda`` unless ``device="cpu"``,
``serving`` — the pod-level elastic serving fleet driven by the same trace
builders, on the host, ``serving_torch`` — the same fleet as one device
program, the port of the JAX package's ``serving_jax``, on ``cuda`` unless
``device="cpu"``); they take the same call signature and emit the same
:class:`~repro_torch.exp.results.RunResult` schema, so a consumer can flip
engines with one string.  ``sweep`` fans a scenario out over a parameter
grid: serial (optionally multiprocess) DES or serving runs per grid point,
or a single-program cube for the array engines (the (replace_fraction x
threshold x max_transient) fluid cube, the (threshold x max_transient x
max_slots) cube for ``serving_torch``), each one lane axis — same
signature, results addressable by grid point either way.

Register a new engine adapter::

    from repro_torch.exp import register_engine

    def _run_mine(sc, *, quick, seed, sim_seed, trace,
                  trace_overrides, sim_overrides, **kw):
        ...  # -> RunResult (use results.from_* or build one directly)
    register_engine("mine", _run_mine)

Add a DES sweep axis: any ``SimConfig`` field name (or an
:data:`OVERRIDE_SPEC` alias like ``r`` / ``p``) already works as a grid key;
to add a *named* alias, append one ``Override`` entry to ``OVERRIDE_SPEC``.
Fluid sweep axes are the lane-batched trio ``replace_fraction`` /
``threshold`` / ``max_transient``.
"""

from __future__ import annotations

import itertools
import json
import pathlib
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.exp.results import (RunResult, _jsonable, _load_npz,
                                     _save_npz, from_fluid_output,
                                     from_serving_fleet, from_serving_jax,
                                     from_sim_result)
from repro_torch.sched import Scenario, get_scenario

# --------------------------------------------------------- declarative overrides

#: scale factors applied before the value lands in the override dict
_HOURS = 3600.0


@dataclass(frozen=True)
class Override:
    """One named experiment knob: where it lands (trace and/or sim override
    dicts), its CLI type, an optional unit scale, and its help string —
    the launcher builds its flags from this table instead of an if-chain."""

    trace_key: Optional[str] = None
    sim_key: Optional[str] = None
    type: type = float
    scale: float = 1.0
    help: str = ""


#: name -> Override; the single source of truth for experiment knobs shared
#: by ``repro_torch.launch.sim`` flags, ``run(overrides=...)`` and DES sweep axes.
#: ``repro_torch.analysis`` harvests these names (aliases + sim_keys) as traced
#: sweep params: the static-shape lint rule fails CI if any of them ever
#: becomes a ``FleetSpec`` field, and the registry-parity rule checks every
#: ``sim_key``/``trace_key`` still names a real config field / builder kwarg
OVERRIDE_SPEC: Dict[str, Override] = {
    "servers": Override(trace_key="n_servers", sim_key="n_servers", type=int,
                        help="cluster size (trace + sim)"),
    "short": Override(trace_key="n_short", sim_key="n_short_reserved",
                      type=int, help="short-only partition size N_s"),
    "p": Override(sim_key="replace_fraction",
                  help="replace fraction p of the short partition"),
    "r": Override(sim_key="cost_ratio", help="transient cost ratio r"),
    "threshold": Override(sim_key="threshold",
                          help="controller long-load-ratio threshold L_r^T"),
    "provisioning": Override(sim_key="provisioning_delay",
                             help="transient provisioning delay (s)"),
    "horizon_h": Override(trace_key="horizon", scale=_HOURS,
                          help="trace horizon (hours)"),
    "burst_mult": Override(trace_key="burst_mult",
                           help="MMPP burst-state rate multiplier"),
    "rel_amplitude": Override(trace_key="rel_amplitude",
                              help="diurnal envelope amplitude "
                                   "(diurnal_* scenarios)"),
    "spike_mult": Override(trace_key="spike_mult",
                           help="flash-crowd spike multiplier "
                                "(flash_crowd_*)"),
    "hetero_slow_frac": Override(sim_key="hetero_slow_frac",
                                 help="fraction of general servers that "
                                      "run slow"),
    "hetero_slow_speed": Override(sim_key="hetero_slow_speed",
                                  help="relative speed of the slow general "
                                       "servers"),
    "revocation_mttf_h": Override(sim_key="revocation_mttf", scale=_HOURS,
                                  help="spot revocation MTTF (hours)"),
    "max_slots": Override(sim_key="max_slots", type=int,
                          help="decode slots per serving replica "
                               "(continuous batching; serving engine)"),
}


def resolve_overrides(**named) -> Tuple[Dict, Dict]:
    """Map named knobs through :data:`OVERRIDE_SPEC` into
    ``(trace_overrides, sim_overrides)``; ``None`` values are skipped, names
    outside the spec land directly in ``sim_overrides`` (raw ``SimConfig``
    fields)."""
    trace_over: Dict = {}
    sim_over: Dict = {}
    for name, value in named.items():
        if value is None:
            continue
        spec = OVERRIDE_SPEC.get(name)
        if spec is None:
            sim_over[name] = value
            continue
        scaled = spec.type(value) * spec.scale if spec.scale != 1.0 \
            else spec.type(value)
        if spec.trace_key:
            trace_over[spec.trace_key] = scaled
        if spec.sim_key:
            sim_over[spec.sim_key] = scaled
    return trace_over, sim_over


# ------------------------------------------------------------ engine registry

EngineAdapter = Callable[..., RunResult]
_ENGINES: Dict[str, EngineAdapter] = {}


def register_engine(name: str, adapter: EngineAdapter, *,
                    overwrite: bool = False) -> EngineAdapter:
    if name in _ENGINES and not overwrite:
        raise ValueError(f"engine {name!r} already registered")
    _ENGINES[name] = adapter
    return adapter


def engine_names() -> List[str]:
    return sorted(_ENGINES)


def _coerce(scenario: Union[str, Scenario]) -> Scenario:
    return scenario if isinstance(scenario, Scenario) else \
        get_scenario(scenario)


def _get_engine(engine: str) -> EngineAdapter:
    try:
        return _ENGINES[engine]
    except KeyError:
        raise ValueError(f"unknown engine {engine!r}; "
                         f"registered: {engine_names()}") from None


def run(scenario: Union[str, Scenario], engine: str = "des", *,
        quick: bool = False, seed: int = 42, sim_seed: int = 0,
        trace=None, trace_overrides: Optional[Dict] = None,
        sim_overrides: Optional[Dict] = None, **engine_kwargs) -> RunResult:
    """Run one scenario on one engine; every engine returns the same
    :class:`RunResult` schema.

    ``trace`` short-circuits synthesis so several runs share one workload
    (the fig3/table1/compare pattern); ``engine_kwargs`` pass through to the
    adapter (e.g. ``policy=FluidPolicyParams(...)`` for ``fluid``).
    """
    sc = _coerce(scenario)
    adapter = _get_engine(engine)
    return adapter(sc, quick=quick, seed=seed, sim_seed=sim_seed, trace=trace,
                   trace_overrides=dict(trace_overrides or {}),
                   sim_overrides=dict(sim_overrides or {}), **engine_kwargs)


# ---------------------------------------------------------- built-in engines

def _run_des(sc: Scenario, *, quick: bool, seed: int, sim_seed: int, trace,
             trace_overrides: Dict, sim_overrides: Dict) -> RunResult:
    """Exact discrete-event engine (``repro_torch.core.engine``); the underlying
    run is byte-identical to the legacy ``Scenario.run()`` path."""
    t0 = time.perf_counter()
    if trace is None:
        trace = sc.trace(quick=quick, seed=seed,
                         trace_overrides=trace_overrides)
    res = sc.run(quick=quick, trace=trace, sim_seed=sim_seed,
                 sim_overrides=sim_overrides)
    return from_sim_result(
        res, scenario=sc.name, quick=quick, seed=seed, sim_seed=sim_seed,
        overrides={"trace": trace_overrides, "sim": sim_overrides},
        wall_time_s=time.perf_counter() - t0, trace=trace)


def _to_host(out: Dict) -> Dict:
    """A fluid output dict of device tensors -> host numpy, one copy each."""
    return {k: _to_host(v) if isinstance(v, dict) else v.cpu().numpy()
            for k, v in out.items()}


def _run_fluid(sc: Scenario, *, quick: bool, seed: int, sim_seed: int = 0,
               trace, trace_overrides: Dict, sim_overrides: Dict,
               dt: float = 10.0, policy=None, device=None) -> RunResult:
    """Slotted fluid engine (``repro_torch.core.simtorch``) on ``device``
    (``cuda`` unless the caller passes ``"cpu"``); ``policy`` overrides the
    scenario's ``FluidPolicyParams`` (calibration fits)."""
    from repro_torch.core.simtorch import simulate_fluid

    t0 = time.perf_counter()
    if trace is None:
        trace = sc.trace(quick=quick, seed=seed,
                         trace_overrides=trace_overrides)
    lw, sw, fcfg, ctrl = sc.fluid_setup(quick=quick, dt=dt, trace=trace,
                                        sim_overrides=sim_overrides)
    pol = policy if policy is not None else sc.fluid_params(quick=quick)
    out = _to_host(simulate_fluid(lw, sw, fcfg, policy=pol, device=device,
                                  **ctrl))
    return from_fluid_output(
        out, scenario=sc.name, fluid_config=fcfg, controller=ctrl, policy=pol,
        overrides={"trace": trace_overrides, "sim": sim_overrides},
        quick=quick, seed=seed, wall_time_s=time.perf_counter() - t0, trace=trace)


def _run_serving(sc: Scenario, *, quick: bool, seed: int, sim_seed: int,
                 trace, trace_overrides: Dict, sim_overrides: Dict,
                 decode_fn=None, record_events: bool = False,
                 tracer=None) -> RunResult:
    """Pod-level serving engine (``repro_torch.runtime.serving``), on the
    host: the scenario's trace becomes a decode-request stream + long-job
    pinning signal, routed by the scenario's short-placement policy over an
    ``ElasticServingFleet``.  ``decode_fn`` optionally runs a real model
    decode step per replica tick (``repro_torch.examples.serve_bursty``).
    ``record_events=True`` captures the typed scheduler event stream into
    the result (``series["event_counts"]`` + event totals under
    ``meta["obs"]``); ``tracer`` (an ``obs.Tracer``) collects the Perfetto
    timeline — both off by default (zero cost)."""
    from repro_torch.runtime.serving import (ElasticServingFleet,
                                             build_serving_workload)

    t0 = time.perf_counter()
    if trace is None:
        trace = sc.trace(quick=quick, seed=seed,
                         trace_overrides=trace_overrides)
    cfg = sc.serving_config(quick=quick, sim_overrides=sim_overrides)
    requests, pinned_fn, max_ticks, wl_meta = build_serving_workload(trace,
                                                                     cfg)
    _, short_pol = sc.policies()
    # multi-tenant trace: per-tenant SLO bookkeeping (tick units) drives
    # the fleet's debt-aware drain/hedge victim selection; the policy's
    # token buckets move from work-seconds to work-ticks
    tenancy = None
    t_names = (trace.meta or {}).get("tenants")
    if t_names:
        from repro_torch.tenancy import TenancyState

        slo = trace.meta.get("tenant_slo_s", [120.0] * len(t_names))
        tenancy = TenancyState(t_names, [s / cfg.tick_s for s in slo])
        if hasattr(short_pol, "scale_costs") and cfg.tick_s != 1.0:
            short_pol.scale_costs(1.0 / cfg.tick_s)
    recorder = None
    if record_events:
        from repro_torch.obs import EventRecorder

        recorder = EventRecorder()
    fleet = ElasticServingFleet.from_config(
        cfg, short_policy=short_pol, decode_fn=decode_fn, seed=sim_seed,
        drain_preference=sc.drain_preference, recorder=recorder,
        tracer=tracer, tenancy=tenancy)
    fleet.run(requests, pinned_fn, max_ticks)
    return from_serving_fleet(
        fleet, requests, scenario=sc.name, config=cfg, workload_meta=wl_meta,
        overrides={"trace": trace_overrides, "sim": sim_overrides},
        quick=quick, seed=seed, sim_seed=sim_seed,
        wall_time_s=time.perf_counter() - t0, trace=trace,
        recorder=recorder)


def _serving_torch_setup(sc: Scenario, *, quick: bool, seed: int, trace,
                         trace_overrides: Dict, sim_overrides: Dict):
    """Shared trace -> (cfg, requests, pinning, wl_meta, spot, tenancy)
    prologue for the serving_torch run and sweep paths (the reference's
    ``_serving_jax_setup``).  The tenancy triple is ``(n_tenants,
    credit_rate, credit_burst)``: tenant count from the trace meta (a static
    shape), token-bucket vectors in tick units from the scenario's
    ``tenant_guard`` policy (``None`` — an inert gate — under any other
    policy)."""
    from repro_torch.runtime.serving import build_serving_workload

    if trace is None:
        trace = sc.trace(quick=quick, seed=seed,
                         trace_overrides=trace_overrides)
    cfg = sc.serving_config(quick=quick, sim_overrides=sim_overrides)
    requests, _, max_ticks, wl_meta = build_serving_workload(trace, cfg)
    _, short_pol = sc.policies()
    spot = getattr(short_pol, "name", "") == "spot_aware"
    t_names = (trace.meta or {}).get("tenants")
    n_tenants = len(t_names) if t_names else 1
    credit_rate = credit_burst = None
    if n_tenants > 1 and getattr(short_pol, "name", "") == "tenant_guard":
        buckets = short_pol.credits.buckets
        credit_rate = [b.rate for b in buckets]
        credit_burst = [b.burst / cfg.tick_s for b in buckets]
    return (trace, cfg, requests, max_ticks, wl_meta, spot,
            (n_tenants, credit_rate, credit_burst))


def _run_serving_torch(sc: Scenario, *, quick: bool, seed: int,
                       sim_seed: int, trace, trace_overrides: Dict,
                       sim_overrides: Dict, queue_cap: Optional[int] = None,
                       device=None) -> RunResult:
    """The serving fleet as one device program
    (``repro_torch.runtime.serving_torch``) on ``device`` (``cuda`` unless
    the caller passes ``"cpu"``): the same trace -> request-stream/pinning
    mapping as ``serving``, one kernel launch for the whole horizon on the
    card.  Its draws are the reference ``serving_jax`` engine's, so a run
    equals that engine's bit for bit; the result carries the same series,
    ``meta["fleet_spec"]`` and ``meta["obs"]``, under the engine tag
    ``serving_torch``."""
    from repro_torch.runtime import serving_torch

    t0 = time.perf_counter()
    (trace, cfg, requests, max_ticks, wl_meta, spot,
     (n_tenants, credit_rate, credit_burst)) = _serving_torch_setup(
        sc, quick=quick, seed=seed, trace=trace,
        trace_overrides=trace_overrides, sim_overrides=sim_overrides)
    metrics, series, spec = serving_torch.run_workload(
        cfg, requests, wl_meta["pinned_per_tick"], max_ticks,
        drain_preference=sc.drain_preference, spot_pricing=spot,
        sim_seed=sim_seed, queue_cap=queue_cap, n_tenants=n_tenants,
        credit_rate=credit_rate, credit_burst=credit_burst, device=device)
    rr = from_serving_jax(
        metrics, series, scenario=sc.name, config=cfg, spec=spec,
        workload_meta=wl_meta,
        overrides={"trace": trace_overrides, "sim": sim_overrides},
        quick=quick, seed=seed, sim_seed=sim_seed,
        wall_time_s=time.perf_counter() - t0, trace=trace,
        obs=serving_torch.last_run_obs())
    return replace(rr, engine="serving_torch")


register_engine("des", _run_des)
register_engine("fluid", _run_fluid)
register_engine("serving", _run_serving)
register_engine("serving_torch", _run_serving_torch)


# ---------------------------------------------------------------- grid sweeps

@dataclass(frozen=True)
class SweepResult:
    """A metric grid: ``metrics[name]`` has one axis per ``axes`` entry, in
    order; grid points are addressable by axis value via :meth:`at`."""

    engine: str
    scenario: str
    axes: Dict[str, np.ndarray]  # axis name -> values, in array-dim order
    metrics: Dict[str, np.ndarray]  # metric -> grid-shaped array
    meta: Dict = field(default_factory=dict)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(len(v) for v in self.axes.values())

    def index(self, **coords) -> Tuple[int, ...]:
        """Exact grid-point lookup: one value per axis -> array index."""
        if sorted(coords) != sorted(self.axes):
            raise ValueError(f"need exactly one value per axis "
                             f"{sorted(self.axes)}, got {sorted(coords)}")
        idx = []
        for name, values in self.axes.items():
            hits = np.flatnonzero(np.isclose(values, coords[name]))
            if not hits.size:
                raise ValueError(f"{name}={coords[name]!r} is not a grid "
                                 f"value of axis {values.tolist()}")
            idx.append(int(hits[0]))
        return tuple(idx)

    def at(self, **coords) -> Dict[str, float]:
        """All metrics at one grid point (NaN where a DES point lacked a
        metric, e.g. ``dynamic_partition_cost_saving`` with p=0)."""
        idx = self.index(**coords)
        return {k: float(v[idx]) for k, v in self.metrics.items()}

    def best(self, metric: str = "short_avg_wait_s", mode: str = "min"
             ) -> Dict[str, float]:
        """Arg-optimal grid point: axis values + the metric value there."""
        arr = np.asarray(self.metrics[metric])
        pick = np.nanargmin if mode == "min" else np.nanargmax
        idx = np.unravel_index(pick(arr), arr.shape)
        out = {name: float(values[i])
               for (name, values), i in zip(self.axes.items(), idx)}
        out[metric] = float(arr[idx])
        return out

    # -------------------------------------------------------- serialization

    def to_json_dict(self) -> Dict:
        return _jsonable({"engine": self.engine, "scenario": self.scenario,
                          "axes": dict(self.axes),
                          "axis_order": list(self.axes),
                          "metrics": dict(self.metrics),
                          "meta": self.meta})

    def save(self, path: Union[str, pathlib.Path]) -> pathlib.Path:
        path = pathlib.Path(path)
        if path.suffix == ".json":
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(self.to_json_dict(), sort_keys=True,
                                       indent=1, default=float))
            return path
        return _save_npz(
            path, "__sweepresult__",
            {"engine": self.engine, "scenario": self.scenario,
             "axis_order": list(self.axes), "meta": _jsonable(self.meta)},
            {**{f"axis__{k}": v for k, v in self.axes.items()},
             **{f"metric__{k}": v for k, v in self.metrics.items()}})

    @classmethod
    def load(cls, path: Union[str, pathlib.Path]) -> "SweepResult":
        path = pathlib.Path(path)
        if path.suffix == ".json":
            d = json.loads(path.read_text())
            axes = {k: np.asarray(d["axes"][k], float)
                    for k in d["axis_order"]}
            metrics = {k: np.asarray(v, float)  # null -> NaN
                       for k, v in d["metrics"].items()}
        else:
            d, arrays = _load_npz(path, "__sweepresult__")
            axes = {k: arrays[f"axis__{k}"] for k in d["axis_order"]}
            metrics = {k[len("metric__"):]: v for k, v in arrays.items()
                       if k.startswith("metric__")}
        return cls(engine=d["engine"], scenario=d["scenario"], axes=axes,
                   metrics=metrics, meta=d.get("meta", {}))


#: simtorch sweep output name -> canonical RunResult metric name
_FLUID_SWEEP_RENAME = {
    "avg_short_delay": "short_avg_wait_s",
    "max_short_delay": "short_max_wait_s",
    "avg_transients": "avg_active_transients",
    "peak_transients": "peak_active_transients",
    "avg_lr": "avg_lr",
}

#: the fluid cube, in its fixed array-dimension order
_FLUID_AXES = ("replace_fraction", "threshold", "max_transient")


def sweep(scenario: Union[str, Scenario], grid: Dict[str, Sequence],
          engine: str = "fluid", *, quick: bool = False, seed: int = 42,
          sim_seed: int = 0, trace=None,
          trace_overrides: Optional[Dict] = None,
          sim_overrides: Optional[Dict] = None,
          processes: Optional[int] = None, **engine_kwargs) -> SweepResult:
    """Fan one scenario out over a parameter grid on one engine.

    ``grid`` maps axis names to value lists.  The trace is synthesized once
    (or passed in) and shared across every grid point, so axes must be
    engine knobs, not trace knobs.

    * ``engine="fluid"``: axes from ``replace_fraction`` / ``threshold`` /
      ``max_transient``; evaluated as one lane-batched torch program
      (``repro_torch.core.simtorch.sweep``) on ``device`` (``cuda`` unless
      the caller passes ``"cpu"``), missing cube axes pinned to the
      scenario's own value.  Result dims follow the cube order
      (p, threshold, budget) restricted to the requested axes.
    * ``engine="des"``, ``"serving"`` (or any registered adapter):
      Cartesian fan-out, one full engine run per point — serial, or
      multiprocess with ``processes=N``.  Axis names are ``OVERRIDE_SPEC``
      aliases (``r``, ``p``, ``threshold``...) or raw ``SimConfig`` fields
      (and ``ServingFleetConfig`` fields such as ``max_slots`` or
      ``n_reserve`` for ``serving``).  Result dims follow ``grid``
      insertion order.
    """
    sc = _coerce(scenario)
    if not grid or any(len(v) == 0 for v in grid.values()):
        raise ValueError("grid must map at least one axis to non-empty values")
    if engine == "fluid":
        return _sweep_fluid(sc, grid, quick=quick, seed=seed, trace=trace,
                            trace_overrides=trace_overrides,
                            sim_overrides=sim_overrides, **engine_kwargs)
    if engine == "serving_torch" and set(grid) <= set(_SERVING_TORCH_AXES):
        return _sweep_serving_torch(sc, grid, quick=quick, seed=seed,
                                    sim_seed=sim_seed, trace=trace,
                                    trace_overrides=trace_overrides,
                                    sim_overrides=sim_overrides,
                                    **engine_kwargs)
    return _sweep_pointwise(sc, grid, engine, quick=quick, seed=seed,
                            sim_seed=sim_seed, trace=trace,
                            trace_overrides=trace_overrides,
                            sim_overrides=sim_overrides, processes=processes,
                            **engine_kwargs)


def _sweep_fluid(sc: Scenario, grid: Dict[str, Sequence], *, quick: bool,
                 seed: int, trace, trace_overrides: Optional[Dict],
                 sim_overrides: Optional[Dict], dt: float = 10.0,
                 policy=None, device=None) -> SweepResult:
    from repro_torch.core import simtorch

    t0 = time.perf_counter()
    unknown = set(grid) - set(_FLUID_AXES)
    if unknown:
        raise ValueError(f"fluid sweep axes must be among {_FLUID_AXES}; "
                         f"got {sorted(unknown)}")
    if trace is None:
        trace = sc.trace(quick=quick, seed=seed,
                         trace_overrides=dict(trace_overrides or {}))
    lw, sw, fcfg, ctrl = sc.fluid_setup(quick=quick, dt=dt, trace=trace,
                                        sim_overrides=dict(sim_overrides
                                                           or {}))
    cfg0 = sc.sim_config(quick=quick, sim_overrides=dict(sim_overrides or {}))
    pol = policy if policy is not None else sc.fluid_params(quick=quick)
    thr = np.asarray(grid.get("threshold", [ctrl["threshold"]]), float)
    ks = np.asarray(grid.get("max_transient", [ctrl["max_transient"]]), float)
    if "replace_fraction" in grid:
        ps = np.asarray(grid["replace_fraction"], float)
        raw = simtorch.sweep(lw, sw, fcfg, thr, ks, policy=pol,
                             replace_fractions=ps,
                             n_short_reserved=cfg0.n_short_reserved,
                             device=device)
        full_axes = {"replace_fraction": ps, "threshold": thr,
                     "max_transient": ks}
    else:
        raw = simtorch.sweep(lw, sw, fcfg, thr, ks, policy=pol,
                             device=device)
        full_axes = {"threshold": thr, "max_transient": ks}
    # drop the cube axes the caller did not ask for (pinned singletons)
    keep = [i for i, name in enumerate(full_axes) if name in grid]
    axes = {name: full_axes[name] for name in full_axes if name in grid}
    metrics = {}
    for k, arr in _to_host(raw).items():
        for i in reversed(range(arr.ndim)):
            if i not in keep:
                arr = arr.take(0, axis=i)
        metrics[_FLUID_SWEEP_RENAME.get(k, k)] = arr
    return SweepResult(
        engine="fluid", scenario=sc.name, axes=axes, metrics=metrics,
        meta={"quick": quick, "seed": seed, "dt": dt,
              "n_points": int(np.prod([len(v) for v in axes.values()])),
              "wall_time_s": time.perf_counter() - t0})


#: sweep axes the serving_torch cube evaluates as one device program; any
#: other axis set falls back to the pointwise fan-out
_SERVING_TORCH_AXES = ("threshold", "max_transient", "max_slots")


def _sweep_serving_torch(sc: Scenario, grid: Dict[str, Sequence], *,
                         quick: bool, seed: int, sim_seed: int, trace,
                         trace_overrides: Optional[Dict],
                         sim_overrides: Optional[Dict],
                         sim_seeds: Optional[Sequence[int]] = None,
                         queue_cap: Optional[int] = None,
                         batch: str = "map", device=None) -> SweepResult:
    """The (threshold x max_transient x max_slots) serving cube as one
    device program (``serving_torch.sweep_cube``, one lane a grid point and
    seed): one trace, every grid point through the same program.
    ``sim_seeds`` averages the grid over several engine seeds (default:
    just ``sim_seed``); missing cube axes are pinned to the scenario's value
    and dropped from the result dims, mirroring the fluid sweep."""
    from repro_torch.runtime import serving_torch

    t0 = time.perf_counter()
    # the cube sweeps fleet knobs, not tenancy — the tenancy triple is
    # dropped (credit-budget sweeps go through the pointwise path)
    trace, cfg, requests, max_ticks, wl_meta, spot, _ = _serving_torch_setup(
        sc, quick=quick, seed=seed, trace=trace,
        trace_overrides=dict(trace_overrides or {}),
        sim_overrides=dict(sim_overrides or {}))
    seeds = tuple(sim_seeds) if sim_seeds is not None else (sim_seed,)
    full_axes = {
        "threshold": np.asarray(grid.get("threshold", [cfg.threshold]),
                                float),
        "max_transient": np.asarray(grid.get("max_transient",
                                             [cfg.max_transient]), float),
        "max_slots": np.asarray(grid.get("max_slots", [cfg.max_slots]),
                                float),
    }
    grids, spec = serving_torch.sweep_cube(
        cfg, requests, wl_meta["pinned_per_tick"], max_ticks,
        thresholds=full_axes["threshold"],
        max_transients=full_axes["max_transient"].astype(int),
        max_slots_values=full_axes["max_slots"].astype(int),
        sim_seeds=seeds, drain_preference=sc.drain_preference,
        spot_pricing=spot, queue_cap=queue_cap, batch=batch, device=device)
    keep = [i for i, name in enumerate(full_axes) if name in grid]
    axes = {name: full_axes[name] for name in full_axes if name in grid}
    metrics = {}
    for k, v in grids.items():
        arr = np.asarray(v)
        for i in reversed(range(arr.ndim)):
            if i not in keep:
                arr = arr.take(0, axis=i)
        metrics[k] = arr
    return SweepResult(
        engine="serving_torch", scenario=sc.name, axes=axes, metrics=metrics,
        meta={"quick": quick, "seed": seed, "sim_seeds": list(seeds),
              "batch": batch, "fleet_spec": _jsonable(spec),
              "obs": _jsonable(serving_torch.last_run_obs()),
              "n_points": int(np.prod([len(v) for v in axes.values()])),
              "wall_time_s": time.perf_counter() - t0})


def _axis_overrides(grid_names: Sequence[str]) -> None:
    """Validate DES sweep axes: each must resolve to sim-only overrides
    (the trace is shared across the grid)."""
    for name in grid_names:
        spec = OVERRIDE_SPEC.get(name)
        if spec is not None and spec.trace_key is not None:
            raise ValueError(
                f"sweep axis {name!r} changes the trace; sweeps share one "
                f"trace across the grid — pass it via trace_overrides")


def _run_point(payload):
    """One grid point (module-level so multiprocess fan-out can pickle it).

    Carries the adapter *callable*, not the engine name: a spawn-started
    worker re-imports only the built-in registrations, so a name lookup
    would lose custom ``register_engine`` entries; the callable pickles by
    qualified reference and survives."""
    sc, adapter, coords, kw = payload
    _, sim_over = resolve_overrides(**coords)
    kw = dict(kw)
    kw["sim_overrides"] = {**kw.get("sim_overrides", {}), **sim_over}
    return adapter(sc, **kw)


def _sweep_pointwise(sc: Scenario, grid: Dict[str, Sequence], engine: str, *,
                     quick: bool, seed: int, sim_seed: int, trace,
                     trace_overrides: Optional[Dict],
                     sim_overrides: Optional[Dict],
                     processes: Optional[int] = None,
                     **engine_kwargs) -> SweepResult:
    t0 = time.perf_counter()
    _axis_overrides(list(grid))
    if trace is None:
        trace = sc.trace(quick=quick, seed=seed,
                         trace_overrides=dict(trace_overrides or {}))
    axes = {name: np.asarray(values, float) for name, values in grid.items()}
    shape = tuple(len(v) for v in axes.values())
    common = dict(quick=quick, seed=seed, sim_seed=sim_seed, trace=trace,
                  trace_overrides=dict(trace_overrides or {}),
                  sim_overrides=dict(sim_overrides or {}), **engine_kwargs)
    adapter = _get_engine(engine)
    points = [(sc, adapter, dict(zip(grid, combo)), common)
              for combo in itertools.product(*grid.values())]
    if processes and processes > 1:
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(max_workers=processes) as pool:
            results = list(pool.map(_run_point, points))
    else:
        results = [_run_point(p) for p in points]
    names = sorted({m for rr in results for m in rr.metrics})
    metrics = {m: np.full(shape, np.nan) for m in names}
    for flat, rr in enumerate(results):
        idx = np.unravel_index(flat, shape)
        for m, v in rr.metrics.items():
            metrics[m][idx] = v
    return SweepResult(
        engine=engine, scenario=sc.name, axes=axes, metrics=metrics,
        meta={"quick": quick, "seed": seed, "sim_seed": sim_seed,
              "n_points": len(points),
              "processes": int(processes or 1),
              "wall_time_s": time.perf_counter() - t0})

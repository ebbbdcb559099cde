"""The serving fleet as one device program: the port of the reference's
``repro.runtime.serving_jax`` (the ``serving_torch`` engine).

The whole fleet is fixed-shape state, one trajectory a lane, stepped one
decode tick at a time over the horizon; a (threshold x max_transient x
max_slots) sweep cube, and a seed batch on top, is one lane axis of one
program. On the card the program is one hand-written CUDA kernel
(``csrc/serving_fleet.cu``, one thread block a lane, the whole horizon in
one launch); on the CPU it is the plain PyTorch version
(``repro_torch.kernels.serving_fleet.ref``), which is the oracle the
kernel is held to. Both reproduce the reference's routing and revocation
draws (``repro.runtime.serving_jax`` draws them from ``jax.random``;
``repro_torch.runtime.threefry`` is the same generator), so a run equals
the reference's ``serving_jax`` run bit for bit, every output array and
every metric, stochastic presets included.

The numpy front-end (``FleetSpec``, ``make_spec``, ``make_params``,
``build_consts``, ``summarize``) is the reference's text. The known
deviations of ``serving_jax`` from the host fleet
(``repro_torch.runtime.serving``) are therefore this engine's too: see the
reference module's docstring.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import time
from collections import namedtuple
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.runtime.serving import Request, ServingFleetConfig

INT = "int32"

DRAIN_CODES = {"least_loaded": 0, "oldest": 1, "youngest": 2}


def _pow2(n: int, lo: int = 1) -> int:
    n = max(int(n), lo)
    return 1 << (n - 1).bit_length()


# --------------------------------------------------------------- static spec

@dataclass(frozen=True)
class FleetSpec:
    """Static-shape bundle: every field is a Python scalar, so a spec is
    hashable and keys the compiled-program cache. Anything that must stay
    sweepable (threshold, budget, max_slots, hedge factor, revocation rate)
    is a *traced* parameter instead — see :func:`make_params`."""

    n_ondemand: int      # on-demand replicas (base fleet + reserve)
    transient_cap: int   # transient replica slots (>= any swept budget K)
    slot_cap: int        # decode slots per replica (>= any swept max_slots)
    queue_cap: int       # per-replica request ring capacity
    route_cap: int       # reroute-ring pops AND arrivals consumed per tick
    horizon: int         # scan length in ticks
    n_requests: int      # padded request-stream length
    pipe_len: int        # provisioning delay in ticks (shift register)
    probe_d: int
    probe_retries: int
    flush_cap: int       # displaced queue entries recycled per replica/tick
    admit_window: int    # queue-head entries considered per admit pass
    hedge_scan: int      # queue-head entries scanned for hedge eligibility
    hedge_cap: int       # max new hedge duplicates per tick
    lifetime_cap: int    # recorded transient lifetimes (sum/count exact)
    drain_code: int      # DRAIN_CODES[drain_preference]
    spot_pricing: bool   # SpotAwareProbing's rework term in the fallback key
    n_tenants: int = 1   # tenant count is SHAPE (credit vectors, per-tenant
    #                      accumulators); credit rates/bursts stay traced so
    #                      a credit-budget sweep reuses one program

    @property
    def n_replicas(self) -> int:
        return self.n_ondemand + self.transient_cap


def make_spec(cfg: ServingFleetConfig, *, n_requests: int, max_ticks: int,
              max_arrivals_per_tick: int,
              transient_cap: Optional[int] = None,
              slot_cap: Optional[int] = None,
              queue_cap: Optional[int] = None,
              drain_preference: str = "least_loaded",
              spot_pricing: bool = False,
              n_tenants: int = 1) -> FleetSpec:
    """Derive the static spec from a resolved config + workload size.

    ``transient_cap`` / ``slot_cap`` must cover the *largest* swept budget /
    ``max_slots`` so one compiled program serves the whole cube (masked
    columns cost flops, not a retrace)."""
    k_cap = int(transient_cap if transient_cap is not None
                else cfg.max_transient)
    s_cap = int(slot_cap if slot_cap is not None else cfg.max_slots)
    if queue_cap is None:
        queue_cap = _pow2(int(np.clip(n_requests // 2 + 1, 64, 1 << 16)))
    route_cap = _pow2(max_arrivals_per_tick, lo=8)
    return FleetSpec(
        n_ondemand=cfg.n_replicas + cfg.n_reserve,
        transient_cap=max(k_cap, 1),
        slot_cap=max(s_cap, 1),
        queue_cap=int(queue_cap),
        route_cap=route_cap,
        horizon=int(max_ticks),
        n_requests=_pow2(n_requests, lo=16),
        pipe_len=max(cfg.ticks(cfg.provisioning_delay), 1),
        probe_d=cfg.probe_d,
        probe_retries=cfg.probe_retries,
        flush_cap=max(route_cap // 2, 8),
        admit_window=max(s_cap, 1) + 4,
        hedge_scan=8,
        hedge_cap=16,
        lifetime_cap=4096,
        drain_code=DRAIN_CODES[drain_preference],
        spot_pricing=bool(spot_pricing),
        n_tenants=max(int(n_tenants), 1))


def make_params(cfg: ServingFleetConfig, *,
                threshold: Optional[float] = None,
                max_transient: Optional[int] = None,
                max_slots: Optional[int] = None,
                n_tenants: int = 1,
                credit_rate=None,
                credit_burst=None) -> Dict[str, np.ndarray]:
    """The traced (sweepable) parameter bundle for one grid point.

    ``credit_rate`` / ``credit_burst`` are per-tenant token-bucket vectors
    (work-ticks per tick / work-ticks) — scalars broadcast. The default
    (rate 0, infinite burst) makes the credit gate a no-op: every fallback
    is funded, so single-tenant runs are bit-identical to the pre-tenancy
    program."""
    mttf_ticks = (cfg.revocation_mttf / cfg.tick_s
                  if cfg.revocation_mttf else 0.0)
    n_t = max(int(n_tenants), 1)
    cr = (np.zeros(n_t, np.float32) if credit_rate is None
          else np.broadcast_to(np.asarray(credit_rate, np.float32),
                               (n_t,)).copy())
    cb = (np.full(n_t, np.inf, np.float32) if credit_burst is None
          else np.broadcast_to(np.asarray(credit_burst, np.float32),
                               (n_t,)).copy())
    return {
        "threshold": np.float32(cfg.threshold if threshold is None
                                else threshold),
        "max_transient": np.float32(cfg.max_transient if max_transient is None
                                    else max_transient),
        "max_slots": np.int32(cfg.max_slots if max_slots is None
                              else max_slots),
        "hedge_factor": np.float32(cfg.hedge_factor),
        "revoke_prob": np.float32(1.0 / mttf_ticks if mttf_ticks > 0 else 0.0),
        "spot_mttf": np.float32(mttf_ticks if mttf_ticks > 0 else np.inf),
        "credit_rate": cr,
        "credit_burst": cb,
    }


def build_consts(spec: FleetSpec, requests: Sequence[Request],
                 pinned_per_tick: np.ndarray) -> Dict[str, np.ndarray]:
    """Pad the (arrival-sorted) request stream and the pinning signal into
    the spec's static shapes. Padding requests carry ``arrival == horizon``
    so they never enter the arrival window."""
    n = len(requests)
    if n > spec.n_requests:
        raise ValueError(f"{n} requests exceed spec.n_requests "
                         f"{spec.n_requests}")
    T, N = spec.horizon, spec.n_requests
    arrival = np.full(N, T, dtype=np.int32)
    gen = np.ones(N, dtype=np.int32)
    tenant = np.zeros(N, dtype=np.int32)
    arrival[:n] = [q.arrival for q in requests]
    gen[:n] = [q.gen_len for q in requests]
    tenant[:n] = [q.tenant_id % spec.n_tenants for q in requests]
    if n and np.any(np.diff(arrival[:n]) < 0):
        raise ValueError("requests must be sorted by arrival")
    # per-tick arrival windows: requests are arrival-sorted, so tick t owns
    # the contiguous index range [arr_start[t], arr_start[t] + arr_count[t])
    arr_start = np.searchsorted(arrival[:n], np.arange(T),
                                side="left").astype(np.int32)
    arr_count = (np.searchsorted(arrival[:n], np.arange(T), side="right")
                 .astype(np.int32) - arr_start)
    if arr_count.size and int(arr_count.max()) > spec.route_cap:
        raise ValueError(f"{int(arr_count.max())} arrivals in one tick "
                         f"exceed route_cap {spec.route_cap}")
    pin = np.zeros(T, dtype=np.int32)
    m = min(T, len(pinned_per_tick))
    pin[:m] = np.asarray(pinned_per_tick[:m], dtype=np.int32)
    return {"arrival": arrival, "gen": gen, "tenant": tenant,
            "arr_start": arr_start, "arr_count": arr_count,
            "pinned_target": pin, "n_real": np.int32(n)}



# ------------------------------------------------------------- the program

def _lanes(params: Dict, batched: bool) -> Dict[str, torch.Tensor]:
    """Traced parameters as CPU tensors with a leading lane axis."""
    out = {}
    for k, v in params.items():
        t = torch.as_tensor(np.asarray(v))
        out[k] = t if batched else t.unsqueeze(0)
    return out


class FleetProgram:
    """The simulator for one static spec on one device: ``(params, consts,
    keys)`` in, the reference's output dict out, as numpy arrays (with a
    leading grid axis when batched). On ``cuda`` every call is one launch
    of the serving-fleet kernel; on the CPU it runs the plain version."""

    def __init__(self, spec: FleetSpec, batch: Optional[str],
                 device: torch.device) -> None:
        self.spec, self.batch, self.device = spec, batch, device

    def __call__(self, params: Dict, consts: Dict, keys) -> Dict[str, np.ndarray]:
        from repro_torch.kernels.serving_fleet.ops import serving_fleet

        batched = self.batch is not None
        words = torch.as_tensor(np.asarray(keys), dtype=torch.int64)
        words = (words if batched else words[None]).to(self.device)
        out = serving_fleet(self.spec, _lanes(params, batched), consts,
                            (words[:, 0], words[:, 1]))
        out = {k: v.cpu().numpy() for k, v in out.items()}
        return out if batched else {k: v[0] for k, v in out.items()}


# -------------------------------------------------------------- program cache

CacheInfo = namedtuple("CacheInfo", "hits misses size")
_PROGRAMS: Dict[Tuple, FleetProgram] = {}
_CACHE_STATS = {"hits": 0, "misses": 0}


def get_program(spec: FleetSpec, *, batch: Optional[str] = None,
                device=None) -> FleetProgram:
    """The simulator for one static spec, keyed by ``(spec, batch,
    device)``, so repeated ``exp.run`` / ``exp.sweep`` calls over the same
    shapes reuse one program. A program compiles nothing: the cache keeps
    the reference's signature and its hit/miss counters, and on the card
    the kernel is built once per process, at the first launch, whatever
    the cache holds.

    ``batch=None`` takes one ``(params, consts, key)`` point. Both batched
    modes take stacked params/keys (leading grid axis) and run the whole
    cube as **one** program. The reference tells ``"map"`` (grid points in
    turn) from ``"vmap"`` (lanewise); on this port both run one lane a
    thread block on the card, and one lane axis of one tensor program on
    the CPU, so the two give the same result and the same time.
    """
    if batch not in (None, "map", "vmap"):
        raise ValueError(f"batch must be None, 'map' or 'vmap': {batch!r}")
    dev = resolve_device(device)
    cache_key = (spec, batch, dev)
    fn = _PROGRAMS.get(cache_key)
    if fn is None:
        _CACHE_STATS["misses"] += 1
        fn = _PROGRAMS[cache_key] = FleetProgram(spec, batch, dev)
    else:
        _CACHE_STATS["hits"] += 1
    return fn


def cache_info() -> CacheInfo:
    return CacheInfo(_CACHE_STATS["hits"], _CACHE_STATS["misses"],
                     len(_PROGRAMS))


def cache_clear() -> None:
    _PROGRAMS.clear()
    _CACHE_STATS.update(hits=0, misses=0)


# ------------------------------------------------ run-level observability

#: facts about the most recent run_workload / sweep_cube execution
_LAST_OBS: Dict[str, object] = {}
#: what the reference's phase names mean here, where nothing is compiled
PHASE_MEANS = ("compile: the first call for this spec and batch on this device "
               "(a program-cache miss; nothing is compiled); steady: a cache hit")


def _record_exec(phase: str, exec_s: float, **extra) -> None:
    from repro_torch.obs.metrics import REGISTRY

    REGISTRY.counter("serving_torch.jit_cache_"
                     + ("miss" if phase == "compile" else "hit")).inc()
    REGISTRY.histogram(f"serving_torch.{phase}_exec_s").observe(exec_s)
    _LAST_OBS.clear()
    _LAST_OBS.update(phase=phase, phase_means=PHASE_MEANS, exec_s=exec_s,
                     program_cache_hit=phase != "compile", **extra)


def last_run_obs() -> Dict[str, object]:
    """Observability snapshot for ``RunResult.meta["obs"]``: the most
    recent execution's phase (``compile`` when :func:`get_program` missed
    the program cache, ``steady`` on a hit), its device and wall time, plus
    process-cumulative program-cache counters and compile/steady wall-time
    histograms, under the reference's keys. Nothing is compiled on this
    port: ``compile`` names the first call for a spec on a device, and the
    record's ``phase_means`` says so. On the card the kernel is built once
    per process, at its first launch, whatever the cache holds."""
    from repro_torch.obs.metrics import REGISTRY, Histogram

    hists = REGISTRY.snapshot()["histograms"]
    empty = Histogram("").snapshot()
    return {
        **_LAST_OBS,
        "jit_cache": cache_info()._asdict(),
        "compile": hists.get("serving_torch.compile_exec_s", empty),
        "steady": hists.get("serving_torch.steady_exec_s", empty),
    }


# ------------------------------------------------------------- host wrappers

def _seed_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s two words, ``(0, seed)``, for a seed in
    ``[0, 2**32)``."""
    return np.asarray([0, int(seed) & 0xFFFFFFFF], np.int64)


def summarize(spec: FleetSpec, out: Dict, consts: Dict, tick_s: float
              ) -> Tuple[Dict[str, float], Dict[str, np.ndarray]]:
    """Device output -> the oracle's summary metrics + series (host side).

    Wait metrics follow ``ElasticServingFleet.summary`` / the
    ``from_serving_fleet`` mapping: waits over started requests, finite
    zeros when nothing completed (the shared ``_pctl`` convention)."""
    from repro_torch.core.metrics import _pctl

    n = int(consts["n_real"])
    start = np.asarray(out["start"])[:n]
    finish = np.asarray(out["finish"])[:n]
    arrival = np.asarray(consts["arrival"])[:n]
    waits = (start[start >= 0] - arrival[start >= 0]).astype(float) * tick_s
    online_tr = np.asarray(out["active_transients"], float)
    busy = np.asarray(out["busy"], float)
    cap = np.asarray(out["cap"], float)
    tr_busy = np.asarray(out["tr_busy"], float)
    tr_cap = np.asarray(out["tr_cap"], float)
    n_life = int(out["n_lifetimes"])
    lifetimes = np.asarray(out["lifetimes"])[:min(n_life,
                                                  spec.lifetime_cap)]
    n_done = int(np.sum(finish >= 0))
    metrics = {
        "short_avg_wait_s": float(np.mean(waits)) if waits.size else 0.0,
        "short_max_wait_s": float(np.max(waits)) if waits.size else 0.0,
        "short_p50_wait_s": _pctl(waits, 50),
        "short_p90_wait_s": _pctl(waits, 90),
        "short_p99_wait_s": _pctl(waits, 99),
        "avg_active_transients": float(online_tr.mean()) if online_tr.size
        else 0.0,
        "peak_active_transients": float(online_tr.max()) if online_tr.size
        else 0.0,
        "n_requests": float(n),
        "n_done": float(n_done),
        "n_unfinished": float(n - n_done),
        "n_hedges": float(out["n_hedges"]),
        "n_hedge_cancelled": float(out["n_hedge_cancelled"]),
        "n_revocations": float(out["n_revocations"]),
        "n_transients_used": float(out["n_rentals"]),
        "avg_transient_lifetime_s": (float(out["lifetime_sum"])
                                     / n_life * tick_s if n_life else 0.0),
        "avg_slot_occupancy": float(busy.sum() / max(cap.sum(), 1.0)),
        "transient_slot_occupancy": float(tr_busy.sum()
                                          / max(tr_cap.sum(), 1.0)),
        "n_queue_overflow": float(out["n_overflow"]),
        "n_throttled": float(out.get("n_throttled", 0)),
    }
    series = {
        "short_waits": waits,
        "active_transients": online_tr,
        "transient_lifetimes": lifetimes.astype(float) * tick_s,
        "batch_occupancy": np.divide(busy, cap, out=np.zeros_like(busy),
                                     where=cap > 0),
        # per-tick scheduler event counts (obs.events.EVENT_TYPES columns)
        # and end-of-tick fleet queue depth — the flight-recorder series
        "event_counts": np.asarray(out["event_counts"], np.int64),
        "queue_depth": np.asarray(out["queue_depth"], float),
    }
    if spec.n_tenants > 1:
        # exact per-request (tenant, wait) pairs for the canonical
        # tenant_waits series — `exp.results` turns them into named
        # per-tenant metrics with the trace meta's names/SLOs
        tenant = np.asarray(consts["tenant"])[:n]
        started = start >= 0
        series["tenant_waits"] = np.stack(
            [tenant[started].astype(float),
             (start[started] - arrival[started]).astype(float) * tick_s],
            axis=1) if started.any() else np.zeros((0, 2))
        series["tenant_admits"] = np.asarray(out["tenant_admits"], np.int64)
    return metrics, series


def _timed_call(spec: FleetSpec, batch: Optional[str], device, params,
                consts, keys, **extra) -> Dict[str, np.ndarray]:
    info0 = cache_info()
    fn = get_program(spec, batch=batch, device=device)
    fresh = cache_info().misses > info0.misses
    t0 = time.perf_counter()
    out = fn(params, consts, keys)  # host copies: the device work is done
    if batch is not None:
        extra["batch"] = batch
    _record_exec("compile" if fresh else "steady", time.perf_counter() - t0,
                 device=str(fn.device), **extra)
    return out


def run_workload(cfg: ServingFleetConfig, requests: Sequence[Request],
                 pinned_per_tick: np.ndarray, max_ticks: int, *,
                 drain_preference: str = "least_loaded",
                 spot_pricing: bool = False, sim_seed: int = 0,
                 spec: Optional[FleetSpec] = None,
                 queue_cap: Optional[int] = None,
                 n_tenants: int = 1,
                 credit_rate=None, credit_burst=None, device=None
                 ) -> Tuple[Dict[str, float], Dict[str, np.ndarray],
                            FleetSpec]:
    """One grid point, the reference's ``serving_jax.run_workload`` on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``).

    Returns ``(metrics, series, spec)``, equal to the reference's."""
    if spec is None:
        arr = np.asarray([q.arrival for q in requests], dtype=np.int64)
        max_arr = int(np.bincount(arr).max()) if arr.size else 0
        spec = make_spec(cfg, n_requests=len(requests), max_ticks=max_ticks,
                         max_arrivals_per_tick=max_arr, queue_cap=queue_cap,
                         drain_preference=drain_preference,
                         spot_pricing=spot_pricing, n_tenants=n_tenants)
    consts = build_consts(spec, requests, pinned_per_tick)
    params = make_params(cfg, n_tenants=spec.n_tenants,
                         credit_rate=credit_rate, credit_burst=credit_burst)
    out = _timed_call(spec, None, device, params, consts, _seed_key(sim_seed))
    metrics, series = summarize(spec, out, consts, cfg.tick_s)
    return metrics, series, spec


#: sweep-cube axes, in array-dimension order (mirrors ``_FLUID_AXES``)
SWEEP_AXES = ("threshold", "max_transient", "max_slots")


def cube_params(cfg: ServingFleetConfig, grid: Sequence[Tuple]) -> Dict:
    """Stacked traced parameters of ``(seed, threshold, max_transient,
    max_slots)`` grid points, in the reference's ``sweep_cube`` layout."""
    g_seed, g_thr, g_k, g_m = (np.asarray(x) for x in zip(*grid))
    base = make_params(cfg)
    params = dict(base)
    params["threshold"] = g_thr.astype(np.float32)
    params["max_transient"] = g_k.astype(np.float32)
    params["max_slots"] = g_m.astype(np.int32)
    for name in ("hedge_factor", "revoke_prob", "spot_mttf"):
        params[name] = np.full(len(grid), base[name], np.float32)
    for name in ("credit_rate", "credit_burst"):  # (n_points, n_tenants)
        params[name] = np.tile(base[name][None, :], (len(grid), 1))
    return params


def sweep_cube(cfg: ServingFleetConfig, requests: Sequence[Request],
               pinned_per_tick: np.ndarray, max_ticks: int, *,
               thresholds: Sequence[float], max_transients: Sequence[int],
               max_slots_values: Sequence[int], sim_seeds: Sequence[int] = (0,),
               drain_preference: str = "least_loaded",
               spot_pricing: bool = False,
               queue_cap: Optional[int] = None,
               batch: str = "map", device=None
               ) -> Tuple[Dict[str, np.ndarray], FleetSpec]:
    """The whole (threshold x max_transient x max_slots) cube, batched over
    ``sim_seeds`` on top, as **one** program on ``device``: every grid
    point and seed is a lane (one thread block on the card).

    Returns ``(grids, spec)``: metric grids of shape ``(len(thresholds),
    len(max_transients), len(max_slots_values))``, seed-averaged
    (percentile metrics are computed per point on host), equal to the
    reference's."""
    thr = np.asarray(thresholds, np.float32)
    ks = np.asarray(max_transients, np.int32)
    ms = np.asarray(max_slots_values, np.int32)
    seeds = list(sim_seeds)
    arr = np.asarray([q.arrival for q in requests], dtype=np.int64)
    max_arr = int(np.bincount(arr).max()) if arr.size else 0
    spec = make_spec(cfg, n_requests=len(requests), max_ticks=max_ticks,
                     max_arrivals_per_tick=max_arr,
                     transient_cap=max(int(ks.max()), cfg.max_transient, 1),
                     slot_cap=max(int(ms.max()), cfg.max_slots, 1),
                     queue_cap=queue_cap,
                     drain_preference=drain_preference,
                     spot_pricing=spot_pricing)
    consts = build_consts(spec, requests, pinned_per_tick)
    grid = [(s, t, k, m) for s in seeds for t in thr for k in ks for m in ms]
    params = cube_params(cfg, grid)
    keys = np.stack([_seed_key(s) for s, _, _, _ in grid])
    out = _timed_call(spec, batch, device, params, consts, keys,
                      n_points=len(grid))
    shape = (len(seeds), len(thr), len(ks), len(ms))
    per_point: List[Dict[str, float]] = []
    for i in range(len(grid)):
        m, _ = summarize(spec, {k: v[i] for k, v in out.items()}, consts,
                         cfg.tick_s)
        per_point.append(m)
    grids: Dict[str, np.ndarray] = {}
    for name in per_point[0]:
        flat = np.asarray([p[name] for p in per_point], float)
        grids[name] = flat.reshape(shape).mean(axis=0)  # seed-averaged
    return grids, spec

"""Fluid-vs-DES calibration: per-metric error tables across the scenario
registry and a coarse grid auto-fit of ``FluidPolicyParams``.

The fluid model is the sweep engine — thousands of grid points per second —
but it is only useful where its error against the exact DES is known.  This
module quantifies that error per canonical metric and per scenario, and
fits the two fluid policy knobs (``backlog_partition_share``,
``transient_availability``) by coarse grid search to minimize the
``short_avg_wait_s`` error.  Both engines run on the *same* synthesized
trace, so the residual is pure model error, not workload noise.

``benchmarks/calibration.py`` ships the registry-wide study as a JSON
artifact (uploaded by the CI calibration-smoke job).
"""

from __future__ import annotations

import time
from dataclasses import asdict
from typing import Dict, Optional, Sequence, Union

from repro_torch.exp.runner import _coerce, run
from repro_torch.sched import FluidPolicyParams, Scenario, scenario_names

#: metrics the error table reports. Means/maxima/budget usage are directly
#: comparable across engines; percentiles are omitted (DES: per task,
#: fluid: per slot — different distributions by construction).
COMPARE_METRICS = (
    "short_avg_wait_s",
    "short_max_wait_s",
    "avg_active_transients",
    "peak_active_transients",
)

#: coarse fit grids for the two FluidPolicyParams knobs; both include the
#: identity (1.0) so the fit can never do worse than the uncalibrated model
FIT_SHARES = (0.25, 0.5, 0.75, 1.0)
FIT_AVAILS = (0.4, 0.6, 0.8, 1.0)


def _error_table(des_metrics: Dict[str, float], fluid_metrics: Dict[str, float],
                 metrics: Sequence[str]) -> Dict[str, Dict[str, float]]:
    table = {}
    for m in metrics:
        if m not in des_metrics or m not in fluid_metrics:
            continue
        d, f = float(des_metrics[m]), float(fluid_metrics[m])
        table[m] = {"des": d, "fluid": f, "abs_err": f - d,
                    "rel_err": (f - d) / max(abs(d), 1e-9)}
    return table


def compare_engines(scenario: Union[str, Scenario], *, quick: bool = True,
                    seed: int = 42, sim_seed: int = 0,
                    policy: Optional[FluidPolicyParams] = None,
                    metrics: Sequence[str] = COMPARE_METRICS,
                    device=None) -> Dict:
    """Run one scenario through both engines on one shared trace and return
    the per-metric error table (fluid relative to DES); the fluid run is on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``)."""
    sc = _coerce(scenario)
    trace = sc.trace(quick=quick, seed=seed)
    des = run(sc, "des", quick=quick, seed=seed, sim_seed=sim_seed,
              trace=trace)
    fluid = run(sc, "fluid", quick=quick, seed=seed, trace=trace,
                policy=policy, device=device)
    return {"scenario": sc.name, "quick": quick, "seed": seed,
            "policy": None if policy is None else asdict(policy),
            "metrics": _error_table(des.metrics, fluid.metrics, metrics),
            "des_wall_s": des.wall_time_s, "fluid_wall_s": fluid.wall_time_s}


def calibrate(scenario: Union[str, Scenario], *, quick: bool = True,
              seed: int = 42, sim_seed: int = 0, fit: bool = True,
              shares: Sequence[float] = FIT_SHARES,
              avails: Sequence[float] = FIT_AVAILS,
              fit_metric: str = "short_avg_wait_s",
              metrics: Sequence[str] = COMPARE_METRICS,
              device=None) -> Dict:
    """Error table + coarse ``FluidPolicyParams`` grid fit for one scenario.

    One DES run is the target; the scenario's own fluid params give the
    *before* error; the (shares x avails) grid gives the fitted *after*
    error — all on one shared trace, the fluid runs on ``device``.
    """
    sc = _coerce(scenario)
    trace = sc.trace(quick=quick, seed=seed)
    des = run(sc, "des", quick=quick, seed=seed, sim_seed=sim_seed,
              trace=trace)
    base_pol = sc.fluid_params(quick=quick)
    base = run(sc, "fluid", quick=quick, seed=seed, trace=trace,
               policy=base_pol, device=device)
    target = float(des.metrics[fit_metric])
    out = {"scenario": sc.name, "quick": quick, "seed": seed,
           "fit_metric": fit_metric,
           "before": {"policy": asdict(base_pol),
                      "metrics": _error_table(des.metrics, base.metrics,
                                              metrics)}}
    if not fit:
        return out
    best_pol, best_res, best_err = base_pol, base, abs(
        float(base.metrics[fit_metric]) - target)
    for share in shares:
        for avail in avails:
            pol = FluidPolicyParams(backlog_partition_share=float(share),
                                    transient_availability=float(avail))
            if pol == base_pol:
                continue
            fl = run(sc, "fluid", quick=quick, seed=seed, trace=trace,
                     policy=pol, device=device)
            err = abs(float(fl.metrics[fit_metric]) - target)
            if err < best_err:
                best_pol, best_res, best_err = pol, fl, err
    out["fitted"] = {"policy": asdict(best_pol),
                     "metrics": _error_table(des.metrics, best_res.metrics,
                                             metrics),
                     "n_grid_points": len(shares) * len(avails)}
    return out


def calibrate_registry(names: Optional[Sequence[str]] = None, *,
                       quick: bool = True, seed: int = 42, fit: bool = True,
                       shares: Sequence[float] = FIT_SHARES,
                       avails: Sequence[float] = FIT_AVAILS,
                       fit_metric: str = "short_avg_wait_s",
                       device=None) -> Dict:
    """Registry-wide calibration study: per-scenario error tables + fits,
    plus aggregate before/after error (mean |rel err| of the fit metric)."""
    t0 = time.perf_counter()
    names = list(names) if names else scenario_names()
    per_scenario = {}
    rel_before, rel_after = [], []
    for name in names:
        entry = calibrate(name, quick=quick, seed=seed, fit=fit,
                          shares=shares, avails=avails, fit_metric=fit_metric,
                          device=device)
        per_scenario[name] = entry
        rel_before.append(abs(
            entry["before"]["metrics"][fit_metric]["rel_err"]))
        if fit:
            rel_after.append(abs(
                entry["fitted"]["metrics"][fit_metric]["rel_err"]))
    out = {"quick": quick, "seed": seed, "fit_metric": fit_metric,
           "scenarios": per_scenario,
           "mean_abs_rel_err_before": sum(rel_before) / len(rel_before)}
    if fit:
        out["mean_abs_rel_err_after"] = sum(rel_after) / len(rel_after)
    out["elapsed_s"] = time.perf_counter() - t0
    return out

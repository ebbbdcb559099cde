"""Simulation results + the paper's table/figure summaries."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


def _pctl(arr, q) -> float:
    """Percentile with the shared empty-array guard.

    Both engines report ``short_p50/p90/p99`` through this one helper (the
    DES over per-task waits, the fluid adapter over per-slot delays), so the
    canonical names and the empty-input convention (0.0) cannot drift.
    """
    arr = np.asarray(arr)
    return float(np.percentile(arr, q)) if arr.size else 0.0


@dataclass
class SimResult:
    config: object
    short_waits: np.ndarray  # queueing delay per short task (s)
    long_waits: np.ndarray
    transient_lifetimes: np.ndarray  # per transient server (s)
    avg_active_transients: float  # time-averaged
    peak_active_transients: int
    lr_samples: np.ndarray  # (t, l_r) decimated samples
    n_revocations: int = 0
    n_rescheduled: int = 0
    extras: Dict = field(default_factory=dict)

    # ---------------------------------------------------------------- paper

    def summary(self) -> Dict[str, float]:
        sw = self.short_waits
        cfg = self.config
        out = {
            "short_avg_wait_s": float(sw.mean()) if sw.size else 0.0,
            "short_max_wait_s": float(sw.max()) if sw.size else 0.0,
            "short_p50_wait_s": _pctl(sw, 50),
            "short_p90_wait_s": _pctl(sw, 90),
            "short_p99_wait_s": _pctl(sw, 99),
            "long_avg_wait_s": float(self.long_waits.mean()) if self.long_waits.size else 0.0,
            "avg_active_transients": self.avg_active_transients,
            "peak_active_transients": float(self.peak_active_transients),
            "n_transients_used": float(self.transient_lifetimes.size),
        }
        if self.transient_lifetimes.size:
            out["transient_avg_lifetime_h"] = float(self.transient_lifetimes.mean() / 3600)
            out["transient_max_lifetime_h"] = float(self.transient_lifetimes.max() / 3600)
        else:
            out["transient_avg_lifetime_h"] = 0.0
            out["transient_max_lifetime_h"] = 0.0
        r = getattr(cfg, "cost_ratio", 1.0)
        out["r_normalized_avg_ondemand"] = self.avg_active_transients / max(r, 1e-9)
        # cost of the *dynamic half* vs its all-on-demand baseline (paper T.1)
        n_replaced = getattr(cfg, "n_replaced", 0)
        if n_replaced:
            out["dynamic_partition_cost_saving"] = 1.0 - (
                out["r_normalized_avg_ondemand"] / n_replaced)
        return out

    def wait_cdf(self, percentiles=None) -> Dict[str, float]:
        percentiles = percentiles or [10, 25, 50, 75, 90, 95, 99, 99.9]
        sw = self.short_waits
        return {f"p{p}": _pctl(sw, p) for p in percentiles}

    def to_run_result(self, **kwargs):
        """Project into the unified experiment schema (``repro_torch.exp``).

        Keyword arguments are those of
        :func:`repro_torch.exp.results.from_sim_result` (scenario name, overrides,
        seed/wall-time provenance, the trace for its meta stats).
        """
        from repro_torch.exp.results import from_sim_result

        return from_sim_result(self, **kwargs)

"""Compatibility shim — trace synthesis now lives in ``repro_torch.workload``.

``yahoo_like`` / ``google_like`` are re-exported from
``repro_torch.workload.builders`` and remain byte-identical for any given
``(seed, params)`` to the historical in-module generators (the builders
consume the RNG in the same order; tests/test_workload.py pins sha256
hashes of the ``seed=0`` traces).  New arrival regimes (diurnal,
flash-crowd, poisson control) and the composable process/mix layers are in
``repro_torch.workload``; prefer importing from there in new code.
"""

from __future__ import annotations

from repro_torch.workload.builders import google_like, yahoo_like  # noqa: F401
from repro_torch.workload.jobmix import lognormal_mean as _lognormal  # noqa: F401


def _mmpp_arrivals(rng, horizon, rate_avg, burst_mult=5.0, calm_frac=0.8,
                   dwell_calm=3600.0, dwell_burst=900.0):
    """Legacy helper: arrival times of a 2-state MMPP with time-average rate
    ``rate_avg`` (kept for callers of the old private API; now a thin wrapper
    over :class:`repro_torch.workload.arrivals.MMPP`)."""
    from repro_torch.workload.arrivals import MMPP

    proc = MMPP.from_burst(rate_avg, burst_mult, calm_frac,
                           dwell_calm=dwell_calm, dwell_burst=dwell_burst)
    return proc.sample(rng, horizon)

"""Per-tenant result metrics — one computation shared by every engine
adapter in ``repro_torch.exp.results``.

Given per-tenant wait samples (seconds) the block below produces the
tenant-aware slice of the ``RunResult`` schema:

  * ``tenant/<name>/avg_wait_s`` / ``tenant/<name>/p99_wait_s`` — the
    per-tenant analogues of the canonical short-wait metrics;
  * ``tenant/<name>/slo_attainment`` — fraction of the tenant's requests
    whose wait met its SLO target (1.0 for a tenant with no requests: an
    empty promise is trivially kept);
  * ``tenant_jain_fairness`` — Jain's index over the per-tenant SLO
    attainments, the scalar the burstiness–fairness frontier plots
    (1.0 = perfectly fair, 1/n = one tenant gets everything);

plus the ``tenant_waits`` series: an ``(N, 2)`` float array of
``(tenant_id, wait_s)`` rows, the flat form that survives the npz
round-trip and lets post-hoc analysis rebuild any per-tenant CDF.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

__all__ = ["jain_index", "tenant_metric_block"]


def jain_index(xs) -> float:
    """Jain's fairness index J = (Σx)² / (n·Σx²) over non-negative shares;
    1.0 when all equal, 1/n when one tenant takes everything. Degenerate
    all-zero input counts as perfectly fair (nobody got anything)."""
    x = np.asarray(xs, dtype=np.float64)
    if x.size == 0:
        return 1.0
    denom = x.size * float((x * x).sum())
    if denom <= 0.0:
        return 1.0
    return float(x.sum()) ** 2 / denom


def tenant_metric_block(waits_by_tenant: Sequence[np.ndarray],
                        names: Sequence[str],
                        slo_targets_s: Sequence[float],
                        ) -> Tuple[Dict[str, float], np.ndarray]:
    """Build the tenant metric dict + the flat ``tenant_waits`` series.

    ``waits_by_tenant[i]`` are tenant i's request waits in seconds (any
    sequence; empty allowed). Returns ``(metrics, tenant_waits)`` where
    ``tenant_waits`` has shape ``(total_requests, 2)`` with columns
    ``(tenant_id, wait_s)`` — shape ``(0, 2)`` when no tenant saw traffic.
    """
    from repro_torch.core.metrics import _pctl

    if not (len(waits_by_tenant) == len(names) == len(slo_targets_s)):
        raise ValueError(f"mismatched tenant block: {len(waits_by_tenant)} "
                         f"wait lists, {len(names)} names, "
                         f"{len(slo_targets_s)} SLO targets")
    metrics: Dict[str, float] = {}
    attainments = []
    rows = []
    for i, (name, slo) in enumerate(zip(names, slo_targets_s)):
        w = np.asarray(waits_by_tenant[i], dtype=np.float64)
        att = float((w <= slo).mean()) if w.size else 1.0
        metrics[f"tenant/{name}/avg_wait_s"] = \
            float(w.mean()) if w.size else 0.0
        metrics[f"tenant/{name}/p99_wait_s"] = _pctl(w, 99)
        metrics[f"tenant/{name}/slo_attainment"] = att
        attainments.append(att)
        if w.size:
            rows.append(np.stack([np.full(w.size, float(i)), w], axis=1))
    metrics["tenant_jain_fairness"] = jain_index(attainments)
    tenant_waits = (np.concatenate(rows, axis=0) if rows
                    else np.zeros((0, 2), dtype=np.float64))
    return metrics, tenant_waits

"""Slotted-time (fluid) cluster simulator on torch tensors — the twin of the
JAX package's ``core/simjax.py``, the scalable engine for CloudCoaster
parameter sweeps.

The discrete-event simulator (engine.py) is exact but serial. This module
recasts the cluster as a fluid model stepped over fixed time slots:

  state: long backlog (server-seconds), short backlog, transient count,
         provisioning pipeline (shift register of pending requests)
  per slot: long servers busy = min(general, backlog-driven demand);
            controller add/drain via the SAME §3.2 implementation the DES
            uses — ``repro_torch.sched.controller.fluid_controller_step``;
            short service capacity = short partition + idle general servers
            (Eagle lets shorts run anywhere not long-occupied).

Placement policies also project into the fluid model: pass the
``FluidPolicyParams`` a ``repro_torch.sched`` short policy exposes via
``fluid_params()`` (burst-guard admission share, spot-aware transient
availability); the defaults reproduce plain Eagle probing.

Grid points are a leading **lane** axis: one step advances every lane one
slot, so ``simulate_fluid`` is the one-lane case and ``sweep`` runs the
whole (replace fraction x threshold x budget) cube as one lane axis,
reshaped to (T, K) or (P, T, K) at the end. The state lives on the device
in f32 — backlogs and transient count of shape (lanes,), the pipeline of
shape (lanes, provision_slots) — and the per-slot series are preallocated
(slots, lanes) tensors, reduced over the slot axis once the loop ends. The
slot loop never reads a value back to the host. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; with no card,
``cuda`` raises.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.jobs import Trace
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sched.controller import fluid_controller_step
from repro_torch.sched.policy import FluidPolicyParams


@dataclass(frozen=True)
class FluidConfig:
    n_general: int = 3920
    n_static_short: int = 40  # (1-p) * N_s
    dt: float = 10.0  # slot seconds
    provision_slots: int = 12  # 120 s at dt=10


def trace_to_rates(trace: Trace, dt: float) -> Tuple[np.ndarray, np.ndarray]:
    """Bin the trace into per-slot arriving work (server-seconds/slot).

    Vectorized with ``np.bincount`` (the Python per-job loop dominated sweep
    setup on google_like traces).  Jobs arriving at or beyond the horizon
    are dropped with a warning — the old behaviour silently folded them all
    into the final slot, spiking its arrival rate.
    """
    n = int(np.ceil(trace.horizon / dt)) + 1
    if not trace.jobs:
        return np.zeros(n), np.zeros(n)
    arrival = np.asarray([j.arrival for j in trace.jobs])
    work = np.asarray([j.work for j in trace.jobs])
    is_long = np.asarray([j.is_long for j in trace.jobs], bool)
    late = arrival >= trace.horizon
    if late.any():
        warnings.warn(
            f"trace_to_rates: dropping {int(late.sum())} job(s) arriving at "
            f"or beyond horizon={trace.horizon:g}s", stacklevel=2)
        arrival, work, is_long = arrival[~late], work[~late], is_long[~late]
    slot = np.minimum((arrival // dt).astype(int), n - 1)
    long_w = np.bincount(slot[is_long], weights=work[is_long], minlength=n)
    short_w = np.bincount(slot[~is_long], weights=work[~is_long], minlength=n)
    return long_w, short_w


def _f32(x, dev: torch.device) -> torch.Tensor:
    """Host values -> an f32 tensor on ``dev``, copied without waiting on the
    device (a pageable source is staged before the call returns)."""
    return torch.from_numpy(np.array(x, np.float32)).to(dev, non_blocking=True)


def _scalar(x: float, dev: torch.device) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=dev)


def _simulate_lanes(long_work, short_work, cfg: FluidConfig, thr, k_max, n_ss,
                    pol: FluidPolicyParams, dev: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """Advance every lane over every slot. ``thr``, ``k_max`` and ``n_ss``
    are (lanes,) f32 tensors on ``dev``; returns per-lane summaries and the
    (slots, lanes) series."""
    lanes = thr.shape[0]
    # divisors and constants as device tensors: a Python-scalar divisor would
    # be applied as a multiply by its reciprocal on the card, not on the CPU
    dt = _scalar(cfg.dt, dev)
    n_gen = _scalar(cfg.n_general, dev)
    floor_total = n_gen + n_ss  # always-on fleet: general + static short
    avail = _scalar(pol.transient_availability, dev)
    share = _scalar(pol.backlog_partition_share, dev)
    arr_l = _f32(long_work, dev).unbind(0)
    arr_s = _f32(short_work, dev).unbind(0)
    n_slots = len(arr_l)
    series = {name: torch.empty((n_slots, lanes), dtype=torch.float32,
                                device=dev)
              for name in ("lr", "n_transient", "short_delay", "long_busy")}
    rows = {name: s.unbind(0) for name, s in series.items()}
    bl_long = torch.zeros(lanes, dtype=torch.float32, device=dev)
    bl_short = torch.zeros_like(bl_long)
    n_tr = torch.zeros_like(bl_long)
    pipe = torch.zeros((lanes, cfg.provision_slots), dtype=torch.float32,
                       device=dev)
    fresh = torch.zeros((lanes, 1), dtype=torch.float32, device=dev)
    for t in range(n_slots):
        bl_long = bl_long + arr_l[t]
        # long servers busy this slot (work-conserving fluid)
        long_busy = torch.minimum(bl_long / dt, n_gen, out=rows["long_busy"][t])
        bl_long = torch.clamp(bl_long - long_busy * dt, min=0.0)
        # transients coming online; the pipeline shifts by one slot
        n_tr = n_tr + pipe[:, 0]
        pipe = torch.cat((pipe[:, 1:], fresh), dim=1)
        total = floor_total + n_tr
        # controller (paper §3.2) — shared adapter from repro_torch.sched
        lr, add, drain = fluid_controller_step(
            long_busy, total, n_tr, pipe,
            threshold=thr, max_transient=k_max, floor_total=floor_total)
        rows["lr"][t].copy_(lr)
        pipe[:, -1] = add
        n_tr = n_tr - drain
        rows["n_transient"][t].copy_(n_tr)
        # short service: short partition + idle general servers
        idle_gen = torch.clamp(n_gen - long_busy, min=0.0)
        if pol.is_identity:
            cap = (n_ss + n_tr + idle_gen) * dt
        else:
            # spot-aware: transients serve at their expected availability;
            # burst guard: standing backlog may consume at most `share` of
            # the protected partition beyond this slot's fresh arrivals
            cap_prot = (n_ss + avail * n_tr) * dt
            cap = (idle_gen * dt
                   + torch.minimum(cap_prot, arr_s[t] + share * cap_prot))
        bl_short = bl_short + arr_s[t]
        served = torch.minimum(bl_short, cap)
        bl_short = bl_short - served
        # Little's-law delay estimate for short work
        rate = torch.clamp(cap / dt, min=1e-6)
        torch.div(bl_short, rate, out=rows["short_delay"][t])
    return {
        "avg_short_delay": series["short_delay"].mean(0),
        "max_short_delay": series["short_delay"].max(0).values,
        "avg_transients": series["n_transient"].mean(0),
        "peak_transients": series["n_transient"].max(0).values,
        "avg_lr": series["lr"].mean(0),
        "series": series,
    }


def simulate_fluid(long_work, short_work, cfg: FluidConfig, *,
                   threshold, max_transient, n_static_short=None,
                   policy: Optional[FluidPolicyParams] = None,
                   device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Fluid CloudCoaster, one run. ``n_static_short`` overrides
    ``cfg.n_static_short`` (n_ss = N_s − round(p·N_s) is how a
    replace-fraction axis enters); ``policy`` is the ``FluidPolicyParams``
    of a ``repro_torch.sched`` short policy (default = Eagle).

    Returns 0-d summaries and ``series`` of per-slot (slots,) tensors, all
    on ``device`` (``cuda`` unless the caller passes ``"cpu"``)."""
    dev = resolve_device(device)
    n_ss = cfg.n_static_short if n_static_short is None else n_static_short
    out = _simulate_lanes(long_work, short_work, cfg, _f32([threshold], dev),
                          _f32([max_transient], dev), _f32([n_ss], dev),
                          policy or FluidPolicyParams(), dev)
    series = {k: v[:, 0] for k, v in out.pop("series").items()}
    return {**{k: v[0] for k, v in out.items()}, "series": series}


def sweep(long_work, short_work, cfg: FluidConfig, thresholds, max_transients,
          policy: Optional[FluidPolicyParams] = None,
          replace_fractions=None, n_short_reserved: Optional[int] = None,
          device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The fluid simulator over a (threshold x budget) grid — or, with
    ``replace_fractions``, over the full (p x threshold x budget) cube — as
    one lane axis.

    ``p`` (the paper's replace fraction) enters as the static-short split:
    n_ss = N_s − round(p·N_s) with ``N_s = n_short_reserved`` (defaults to
    ``cfg.n_static_short`` — pass the scenario's ``n_short_reserved`` so
    p=0 reproduces the all-on-demand partition).  Returns a dict of (T, K)
    tensors, or (P, T, K) when ``replace_fractions`` is given, on
    ``device``.
    """
    dev = resolve_device(device)
    thr = _f32(thresholds, dev).reshape(-1)
    ks = _f32(max_transients, dev).reshape(-1)
    if replace_fractions is None:
        n_ss_axis = _f32([cfg.n_static_short], dev)
    else:
        n_sr = (cfg.n_static_short if n_short_reserved is None
                else n_short_reserved)
        # f32 p * N_s rounded half to even, as jnp.round does
        n_ss_axis = n_sr - torch.round(_f32(replace_fractions, dev).reshape(-1)
                                       * n_sr)
    grid = torch.meshgrid(n_ss_axis, thr, ks, indexing="ij")
    shape = tuple(grid[0].shape)
    if replace_fractions is None:
        shape = shape[1:]
    n_ss, thr_l, k_l = (g.reshape(-1) for g in grid)
    out = _simulate_lanes(long_work, short_work, cfg, thr_l, k_l, n_ss,
                          policy or FluidPolicyParams(), dev)
    out.pop("series")
    return {k: v.reshape(shape) for k, v in out.items()}

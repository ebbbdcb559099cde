"""The long-load-ratio controller (paper §3.2) — the single implementation
behind every layer of the reproduction.

One declarative :class:`ControllerSpec` describes the controller (threshold
L_r^T, transient budget K, provisioning delay, drain preference) and two
adapters execute it:

  * :func:`desired_delta` — the discrete unit-step form consumed by the
    discrete-event simulator (``repro_torch.core.engine``) and the elastic
    runtime (``repro_torch.runtime.serving`` / ``repro_torch.runtime.elastic``);
  * :func:`fluid_controller_step` — the proportional form on torch tensors
    consumed by the slotted fluid simulator (``repro_torch.core.simtorch``),
    where threshold/budget may be per-lane tensors, one lane a grid point.

Semantics (paper §3.2, with removal projected over draining servers so the
drain-lag doesn't trigger a thundering-herd removal):
  while l_r > threshold and budget remains: request one transient
  while l_r < threshold (projected after removal): drain one transient
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

#: drain-preference names -> key functions over (server-like, now) pairs;
#: see :func:`select_drain`.
DRAIN_PREFERENCES = ("least_loaded", "oldest", "youngest")


@dataclass(frozen=True)
class ControllerSpec:
    """Declarative description of the §3.2 transient controller.

    The first two fields match the historical ``ControllerConfig`` layout so
    positional construction keeps working across the codebase.
    """

    threshold: float = 0.95  # L_r^T
    max_transient: int = 0  # K = r * N_s * p
    provisioning_delay: float = 120.0  # seconds (ticks in the serving fleet)
    drain_preference: str = "least_loaded"

    @classmethod
    def from_sim_config(cls, cfg, *, drain_preference: str = "least_loaded"
                        ) -> "ControllerSpec":
        """Derive the controller from a ``SimConfig`` (paper §4 defaults)."""
        return cls(threshold=cfg.threshold, max_transient=cfg.max_transient,
                   provisioning_delay=cfg.provisioning_delay,
                   drain_preference=drain_preference)

    def desired_delta(self, view: "FleetView") -> int:
        return desired_delta(view, self)

    def fluid_step(self, long_busy, total, n_transient, pipe, *, floor_total):
        """Fluid form with this spec's static threshold/budget baked in."""
        return fluid_controller_step(
            long_busy, total, n_transient, pipe,
            threshold=self.threshold, max_transient=self.max_transient,
            floor_total=floor_total)


#: Back-compat alias — the old discrete-only config is a spec with defaults.
ControllerConfig = ControllerSpec


@dataclass(frozen=True)
class FleetView:
    """Controller inputs at a decision point."""

    n_long_busy: int  # servers whose running task is long
    n_online_stable: int  # online servers NOT draining (incl. transients)
    n_draining: int  # online but marked for removal
    n_pending: int  # requested transients not yet online
    n_active_transient: int  # online transients not draining


def desired_delta(view: FleetView, cfg: ControllerSpec) -> int:
    """+k => request k transients; -k => drain k; 0 => hold.

    Adds treat pending servers as already online (no over-request during the
    provisioning delay); removals treat draining servers as already gone.
    """
    add = 0
    while True:
        proj_total = view.n_online_stable + view.n_draining + view.n_pending + add
        budget_used = view.n_active_transient + view.n_pending + add
        if (view.n_long_busy / max(proj_total, 1) > cfg.threshold
                and budget_used < cfg.max_transient):
            add += 1
        else:
            break
    if add:
        return add
    rem = 0
    while (view.n_active_transient - rem > 0
           and view.n_long_busy / max(view.n_online_stable - rem - 1, 1)
           < cfg.threshold):
        rem += 1
    return -rem


def record_rent(recorder, t, delta: int) -> None:
    """Emit one RENT event per transient the §3.2 loop just requested.

    Both discrete engines call this right after :func:`desired_delta`, so
    the rent decision is evented at the controller layer — engine-specific
    code only events what the controller can't see (provision arrival,
    drain completion, revocation). No-op when ``recorder`` is None or the
    controller asked for a drain (``delta <= 0``)."""
    if recorder is None or delta <= 0:
        return
    from repro_torch.obs.events import RENT

    for _ in range(delta):
        recorder.emit(t, RENT)


def select_drain(candidates, *, preference: str = "least_loaded",
                 load_key, online_key):
    """Pick which transient to drain next.

    ``candidates`` are layer-specific handles (server ids in the DES,
    replica records in the serving fleet); ``load_key`` / ``online_key``
    project them to pending load and online time. Preferences:

      least_loaded — fastest to drain (paper default);
      oldest       — longest-online first (spot-aware: bounds the exposure of
                     any single transient to provider reclamation);
      youngest     — newest first (keeps warmed-up servers).
    """
    if preference == "least_loaded":
        return min(candidates, key=load_key)
    if preference == "oldest":
        return min(candidates, key=online_key)
    if preference == "youngest":
        return max(candidates, key=online_key)
    raise ValueError(f"unknown drain preference {preference!r}; "
                     f"expected one of {DRAIN_PREFERENCES}")


def fluid_controller_step(long_busy, total, n_transient, pipe, *,
                          threshold, max_transient, floor_total
                          ) -> Tuple["torch.Tensor", "torch.Tensor", "torch.Tensor"]:
    """Proportional form of the §3.2 unit loop on f32 torch tensors.

    Every input may carry a leading lane axis (``threshold`` /
    ``max_transient`` vary over sweep grids); ``pipe`` is ``(..., P)``, the
    provisioning pipeline along its last axis. Returns ``(lr, add, drain)``
    where ``add`` joins the provisioning pipeline and ``drain`` leaves the
    fleet this slot.

    ``floor_total`` is the always-on fleet size (general + static short): the
    fluid fleet never drains below it, mirroring the discrete controller
    which only ever removes transients.

    The pipeline is summed left to right, the order of the reference's
    reduction, and each clip is ``min(max(x, lo), hi)``: with ``hi < lo``
    (a budget overdrawn by rounding) it returns ``hi``, as ``jnp.clip`` does.
    """
    import torch

    # Python numbers become tensors here; a caller's tensors pass through
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=long_busy.device)
    k_max = torch.as_tensor(max_transient, dtype=torch.float32,
                            device=long_busy.device)
    cols = pipe.unbind(-1)
    in_pipe = cols[0]
    for c in cols[1:]:
        in_pipe = in_pipe + c
    lr = long_busy / total
    want_total = long_busy / thr
    add = torch.minimum(torch.clamp(want_total - (total + in_pipe), min=0.0),
                        k_max - (n_transient + in_pipe))
    add = torch.where(lr > thr, add, 0.0)
    floor_total = torch.as_tensor(floor_total, dtype=torch.float32,
                                  device=long_busy.device)
    drain = torch.minimum(
        torch.clamp(total - torch.maximum(want_total, floor_total), min=0.0),
        n_transient)
    drain = torch.where(lr < thr, drain, 0.0)
    return lr, add, drain

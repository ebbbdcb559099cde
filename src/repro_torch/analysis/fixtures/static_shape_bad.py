"""Seeded static-shape violations: traced sweep params declared as / passed
into ``FleetSpec`` (the self-test pins the traced set to {threshold,
max_transient, max_slots, revoke_prob}). Every ``# BAD`` line must be
flagged; the non-spec class must not."""

from dataclasses import dataclass


@dataclass(frozen=True)
class FleetSpec:
    n_ondemand: int
    threshold: float  # BAD
    max_slots: int = 4  # BAD
    revoke_prob = 0.0  # BAD


@dataclass(frozen=True)
class ControllerKnobs:  # not a spec class: threshold is fine here
    threshold: float = 0.5


def build(sjx):
    ok = FleetSpec(n_ondemand=2)
    bad = sjx.FleetSpec(
        n_ondemand=2,
        max_transient=8,  # BAD
    )
    return ok, bad

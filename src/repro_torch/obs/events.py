"""Typed scheduler event log — one schema across the Python and JAX engines.

The event vocabulary covers the transient lifecycle and the request-motion
paths every CloudCoaster engine shares:

  RENT       controller requests one transient (§3.2 add decision)
  PROVISION  a rented transient comes online (provisioning delay elapsed)
  DRAIN      a draining transient finished its backlog and went offline
  REVOKE     the provider reclaimed a transient (spot revocation)
  HEDGE      a stuck request was duplicated onto the on-demand reserve (§3.3)
  HEDGE_WIN  first completion of a hedged pair (the other copy is cancelled)
  ADMIT      a request entered a decode slot (starts service)
  DISPLACE   a slot-resident request was evicted (pinning or revocation)
  REROUTE    a previously routed request went back through placement
  THROTTLE   an over-credit tenant's request was denied the transient pool
             and redirected to its fair general share (tenancy admission)

The Python engines (``repro_torch.core.engine``, ``repro_torch.runtime.serving``) emit
:class:`SchedEvent` records into an :class:`EventRecorder` at the decision
site, with replica/request ids attached. ``repro_torch.runtime.serving_jax``
cannot emit host objects from inside ``lax.scan``; it records a per-tick
``(T, N_EVENT_TYPES)`` event-count series instead (one column per type, in
:data:`EVENT_TYPES` order) and :func:`events_from_counts` delta-decodes it
into the same log shape post-hoc. Cross-engine comparison therefore
canonicalizes to per-tick counts (:meth:`EventRecorder.counts` /
:func:`diff_event_streams`) — the common denominator both sides can
produce exactly.

Adding an event type: append the name to :data:`EVENT_TYPES` (never
reorder — the column index is the on-disk schema), emit it from the Python
engines, add the matching per-tick count to ``serving_jax._simulate``'s
``ys`` event vector, extend the cross-engine test in tests/test_obs.py,
and regenerate the schema lock with ``python -m repro_torch.analysis.lint
--update-locks`` — the schema-drift lint rule gates CI on the lock, the
``ev_counts`` column arity, and Python-engine emit coverage, so skipping
any of these steps fails the build by name.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

#: event-type names, in the fixed column order of every count array
#: (``serving_jax`` emits its per-tick event vector in exactly this order)
EVENT_TYPES: Tuple[str, ...] = (
    "RENT", "PROVISION", "DRAIN", "REVOKE", "HEDGE", "HEDGE_WIN",
    "ADMIT", "DISPLACE", "REROUTE", "THROTTLE",
)

(RENT, PROVISION, DRAIN, REVOKE, HEDGE, HEDGE_WIN, ADMIT, DISPLACE, REROUTE,
 THROTTLE) = range(len(EVENT_TYPES))

N_EVENT_TYPES = len(EVENT_TYPES)


@dataclass(frozen=True)
class SchedEvent:
    """One scheduler event. ``t`` is engine time (ticks in the serving
    fleets, seconds in the DES); ``replica``/``rid`` are -1 when the
    emitting engine has no id to attach (all JAX-reconstructed events)."""

    t: float
    etype: int
    replica: int = -1
    rid: int = -1
    count: int = 1

    @property
    def name(self) -> str:
        return EVENT_TYPES[self.etype]


class EventRecorder:
    """Append-only event log. Engines hold ``recorder=None`` by default and
    guard every emit with ``if self.recorder is not None`` — recording off
    costs one attribute check per site, no allocation."""

    __slots__ = ("events",)

    def __init__(self) -> None:
        self.events: List[SchedEvent] = []

    def emit(self, t: float, etype: int, *, replica: int = -1,
             rid: int = -1, count: int = 1) -> None:
        self.events.append(SchedEvent(t, etype, replica, rid, count))

    def __len__(self) -> int:
        return sum(e.count for e in self.events)

    def __iter__(self) -> Iterator[SchedEvent]:
        return iter(self.events)

    def type_counts(self) -> Dict[str, int]:
        out = {name: 0 for name in EVENT_TYPES}
        for e in self.events:
            out[e.name] += e.count
        return out

    def counts(self, horizon: int) -> np.ndarray:
        """Per-tick per-type counts, shape ``(horizon, N_EVENT_TYPES)`` —
        the canonical cross-engine comparison form. Event times are floored
        into tick bins; events at/after ``horizon`` are dropped (an engine
        never emits them for a run of ``horizon`` ticks)."""
        out = np.zeros((int(horizon), N_EVENT_TYPES), dtype=np.int64)
        for e in self.events:
            tb = int(e.t)
            if 0 <= tb < out.shape[0]:
                out[tb, e.etype] += e.count
        return out


def events_from_counts(counts: np.ndarray, *, tick_s: float = 1.0
                       ) -> EventRecorder:
    """Reconstruct an event log from a per-tick ``(T, N_EVENT_TYPES)``
    count series (the ``serving_jax`` ``event_counts`` output): one
    aggregated :class:`SchedEvent` per nonzero ``(tick, type)`` cell.
    Replica/request ids are not recoverable from counts and stay -1."""
    counts = np.asarray(counts)
    if counts.ndim != 2 or counts.shape[1] != N_EVENT_TYPES:
        raise ValueError(f"expected (T, {N_EVENT_TYPES}) counts, got shape "
                         f"{counts.shape}")
    rec = EventRecorder()
    ts, es = np.nonzero(counts)
    for t, e in zip(ts.tolist(), es.tolist()):
        rec.emit(float(t) * tick_s, int(e), count=int(counts[t, e]))
    return rec


def _as_counts(log, horizon: Optional[int] = None) -> np.ndarray:
    if isinstance(log, EventRecorder):
        if horizon is None:
            horizon = int(max((e.t for e in log.events), default=0)) + 1
        return log.counts(horizon)
    return np.asarray(log)


def check_transient_conservation(log, *, n_online_end: Optional[int] = None,
                                 n_pending_end: Optional[int] = None,
                                 horizon: Optional[int] = None) -> List[str]:
    """The RENT-pairing property: every RENT eventually pairs with exactly
    one DRAIN or REVOKE, or survives as a still-online / still-pending
    residual at the horizon. Returns violation strings (empty = holds).

    ``log`` is an :class:`EventRecorder` or a ``(T, N_EVENT_TYPES)`` count
    array.
    ``n_online_end`` / ``n_pending_end`` tie the residual to independently
    observed end-state (fleet introspection, ``final_online_transients``);
    omitted, only the internal inequalities are checked."""
    c = _as_counts(log, horizon).sum(axis=0)
    rent, prov = int(c[RENT]), int(c[PROVISION])
    gone = int(c[DRAIN]) + int(c[REVOKE])
    problems = []
    if prov > rent:
        problems.append(f"{prov} PROVISION exceed {rent} RENT")
    if gone > prov:
        problems.append(f"{gone} DRAIN+REVOKE exceed {prov} PROVISION")
    if n_online_end is not None and prov - gone != n_online_end:
        problems.append(f"PROVISION-DRAIN-REVOKE residual {prov - gone} != "
                        f"{n_online_end} transients online at horizon")
    if n_pending_end is not None and rent - prov != n_pending_end:
        problems.append(f"RENT-PROVISION residual {rent - prov} != "
                        f"{n_pending_end} transients still provisioning")
    return problems


def check_replica_lifecycles(events: Iterable[SchedEvent]) -> List[str]:
    """Per-replica pairing over an id-carrying (Python-engine) log: each
    provisioned replica has exactly one PROVISION, at most one of
    DRAIN/REVOKE, and goes offline no earlier than it came online."""
    prov: Dict[int, float] = {}
    ended: Dict[int, str] = {}
    problems = []
    for e in events:
        if e.etype == PROVISION:
            if e.replica in prov:
                problems.append(f"replica {e.replica}: second PROVISION "
                                f"at t={e.t}")
            prov[e.replica] = e.t
        elif e.etype in (DRAIN, REVOKE):
            if e.replica in ended:
                problems.append(f"replica {e.replica}: {e.name} at t={e.t} "
                                f"after {ended[e.replica]}")
            ended[e.replica] = e.name
            t_on = prov.get(e.replica)
            if t_on is None:
                problems.append(f"replica {e.replica}: {e.name} without "
                                f"PROVISION")
            elif e.t < t_on:
                problems.append(f"replica {e.replica}: {e.name} at t={e.t} "
                                f"before PROVISION at t={t_on}")
    return problems


def diff_event_streams(a, b, *, horizon: Optional[int] = None,
                       types: Optional[Sequence[int]] = None,
                       max_report: int = 20) -> List[str]:
    """Cross-engine event-stream diff: compare per-tick per-type counts and
    report mismatched cells as readable strings (empty = identical).

    ``a``/``b`` are :class:`EventRecorder` logs or ``(T, N_EVENT_TYPES)``
    count arrays;
    ``types`` restricts the comparison (e.g. skip REROUTE when a known
    flush-timing deviation is in play — see the serving_jax module
    docstring's deviation inventory)."""
    ca, cb = _as_counts(a, horizon), _as_counts(b, horizon)
    T = max(ca.shape[0], cb.shape[0])

    def pad(c):
        return np.pad(c, ((0, T - c.shape[0]), (0, 0))) \
            if c.shape[0] < T else c

    ca, cb = pad(ca), pad(cb)
    cols = list(types) if types is not None else list(range(N_EVENT_TYPES))
    out = []
    for t, e in zip(*np.nonzero(ca[:, cols] != cb[:, cols])):
        et = cols[int(e)]
        out.append(f"t={int(t)} {EVENT_TYPES[et]}: "
                   f"{int(ca[t, et])} vs {int(cb[t, et])}")
        if len(out) >= max_report:
            out.append("... (truncated)")
            break
    return out

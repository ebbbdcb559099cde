"""Elastic serving fleet — the CloudCoaster runtime mapping at pod level.

Replicas are TPU pod slices serving autoregressive decode. A replica pinned
by a long job (training / batch work) is "busy with a long task"; inference
requests are short tasks. The controller (``repro_torch.sched.ControllerSpec`` —
the same §3.2 implementation the DES and the fluid simulator consume)
watches l_r = pinned / total and rents transient replicas against the
budget K = r * N_s * p; removals drain (finish queued requests, take no new
ones), with the drain victim chosen by the spec's ``drain_preference``.

Request routing goes through the same ``repro_torch.sched.policy`` short-placement
layer the DES uses: on-demand replicas play the general partition (probed
power-of-d, skipping pinned replicas), active transients play the protected
short pool (the probe-failure fallback) — so ``EagleProbing``,
``BurstGuardProbing`` per-class admission and ``SpotAwareProbing``
revocation pricing all drive request placement unchanged.

The fleet advances in ticks (1 tick = 1 decode step). Replicas are
*multi-slot*: every replica owns ``max_slots`` decode slots with
``ContinuousBatcher``-style admit-on-free-slot semantics (the shared
``repro_torch.runtime.batching.SlotState`` bookkeeping), so one tick decodes one
token for every occupied slot — a replica serves up to ``max_slots``
requests concurrently, and a freed slot admits the next queued request on
the following tick. ``max_slots=1`` reproduces the pre-batching fleet
bit-for-bit. ``decode_fn`` can be a real jitted model decode step (one
slot-batched step per replica-tick) — the examples run a reduced model for
true end-to-end serving; tests omit it for speed (identical scheduling
semantics either way). Slot occupancy is reported per tick
(``batch_occupancy``) and as paid-capacity-weighted averages
(``avg_slot_occupancy``, ``transient_slot_occupancy``).

Hedging (paper §3.3 transient-safety rule): a request whose time on a
transient replica exceeds ``hedge_factor x gen_len`` ticks is *duplicated*
onto the on-demand reserve — the original keeps running on the transient —
and the first completion wins; the losing copy is cancelled. Revocations
take a transient replica (and its queue) away instantly; queued requests
are re-routed, except hedged ones whose on-demand copy already carries them.

``build_serving_workload`` maps a ``repro_torch.core.jobs.Trace`` onto the fleet
(short tasks -> ``Request`` streams, the long class -> the ``pinned_fn``
occupancy signal), which is what ``repro_torch.exp.run(..., engine="serving")``
drives.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import events as ev
from repro_torch.runtime.batching import SlotState
from repro_torch.sched.controller import (ControllerSpec, FleetView, record_rent,
                                    select_drain)
from repro_torch.sched.policy import EagleProbing, ShortPlacementPolicy


@dataclass(frozen=True)
class ServingFleetConfig:
    """Resolved serving-fleet configuration (the ``engine="serving"``
    analog of ``SimConfig``; ``Scenario.serving_config`` derives one from
    the scenario's scale + sim kwargs + ``serving_kwargs``).

    ``n_replicas`` is the base fleet the pinning signal is scaled against;
    ``n_reserve`` adds serving-only on-demand replicas that long jobs never
    pin (the static-budget axis of benchmarks/serving_delay.py). Durations
    are seconds; ``tick_s`` converts them to decode ticks.
    """

    n_replicas: int = 80
    n_reserve: int = 0
    max_slots: int = 1  # decode slots per replica (continuous batching)
    max_transient: int = 0  # K = r * N_s * p
    threshold: float = 0.75  # L_r^T over the pod fleet
    provisioning_delay: float = 60.0  # seconds
    hedge_factor: float = 4.0
    revocation_mttf: float = 0.0  # seconds; 0 = no revocations
    tick_s: float = 1.0  # seconds of trace time per decode tick
    pin_scale: float = 1.0  # scales the long-occupancy pinning signal
    max_requests: int = 20000  # cap on the request stream length
    probe_d: int = 2
    probe_retries: int = 3
    n_general_ref: int = 0  # trace general-partition size (pinning scale)

    def ticks(self, seconds: float) -> int:
        return max(int(round(seconds / self.tick_s)), 1)


@dataclass
class Request:
    rid: int
    arrival: int
    gen_len: int
    start: Optional[int] = None
    finish: Optional[int] = None
    hedged: bool = False
    job_id: int = 0
    tenant_id: int = 0  # owning tenant (multi-tenant traces; 0 otherwise)
    #: set on hedge copies -> the original request (wait/finish bookkeeping
    #: lives on the original; first completion wins)
    primary: Optional["Request"] = None
    #: tick this request last joined a replica queue (None = at arrival);
    #: the §3.3 hedge clock measures time *on the transient*, not age
    routed_at: Optional[int] = None

    @property
    def wait(self) -> Optional[int]:
        return None if self.start is None else self.start - self.arrival


@dataclass
class _SlotDecode:
    """One slot-resident decode: the request plus its remaining tokens."""

    req: Request
    tokens_left: int
    admit_t: int = 0  # tick the request entered this slot (trace spans)


@dataclass
class _Replica:
    rid: int
    kind: str  # ondemand | transient
    max_slots: int = 1  # concurrent decode slots (continuous batching)
    queue: deque = field(default_factory=deque)
    pinned: bool = False  # long job occupies this replica
    draining: bool = False
    online_at: int = 0
    offline_at: Optional[int] = None
    #: cached queued + slot-resident decode ticks — the policy view's
    #: pending_work must be O(1), not O(queue), per probe (invariant kept by
    #: enqueue / the fleet's advance/displace/revoke paths)
    pending_ticks: int = 0
    slots: SlotState = field(init=False, repr=False)

    def __post_init__(self):
        self.slots = SlotState(self.max_slots)

    @property
    def load(self) -> int:
        return len(self.queue) + self.slots.n_active

    @property
    def active(self) -> Optional[Request]:
        """First slot-resident request (the single-slot view the
        pre-batching fleet exposed; kept for tests/introspection)."""
        occ = self.slots.occupants()
        return occ[0].req if occ else None

    @property
    def tokens_left(self) -> int:
        """Remaining decode ticks across every occupied slot."""
        return sum(d.tokens_left for d in self.slots.occupants())

    def enqueue(self, req: Request, t: Optional[int] = None) -> None:
        if t is not None:
            req.routed_at = t
        self.queue.append(req)
        self.pending_ticks += req.gen_len


# ------------------------------------------------- sched-policy cluster view

class _ReplicaView:
    """Duck-typed ``Server`` stand-in so ``repro_torch.sched.policy`` objects read
    replica state directly (pending decode ticks, pinning, slot headroom,
    queue classes). Slot-aware extensions over the DES ``Server`` protocol:
    ``n_slots`` / ``free_slots`` (continuous-batching headroom) and
    ``running_tasks`` (every slot-resident request, not a one-task proxy) —
    see ``repro_torch.sched.policy.running_entries``."""

    __slots__ = ("_r",)

    def __init__(self, rep: _Replica):
        self._r = rep

    #: stands in for the unknown remaining time of a pinning long job, the
    #: way a DES server's pending_work includes its long task: the
    #: least-loaded fallback must prefer any unpinned replica over a pinned
    #: one (a request queued behind a pin can strand indefinitely)
    _PIN_PENALTY = 1e12

    @property
    def pending_work(self) -> float:
        # effective drain ticks: a replica decoding max_slots concurrent
        # requests clears its backlog up to max_slots times faster, so the
        # probes compare real headroom, not a replica-count proxy
        # (max_slots=1 reduces to the raw tick count bit-for-bit)
        r = self._r
        return r.pending_ticks / r.max_slots + (self._PIN_PENALTY if r.pinned
                                                else 0.0)

    @property
    def long_occupied(self) -> bool:
        return self._r.pinned

    @property
    def kind(self) -> str:
        return "transient" if self._r.kind == "transient" else "general"

    @property
    def n_slots(self) -> int:
        return self._r.max_slots

    @property
    def free_slots(self) -> int:
        return self._r.slots.n_free

    @property
    def running(self):
        a = self._r.active
        return None if a is None else (float(a.gen_len), float(a.arrival),
                                       False, a.job_id)

    @property
    def running_tasks(self):
        """Task tuples for every slot-resident request (BurstGuard's
        per-class backlog share must count all of them)."""
        return tuple((float(d.req.gen_len), float(d.req.arrival), False,
                      d.req.job_id) for d in self._r.slots.occupants())

    @property
    def queue(self):
        # lazy: BurstGuard's backlog scan breaks at scan_cap entries, so
        # materializing the whole deque would defeat its O(cap) bound
        return ((float(q.gen_len), float(q.arrival), False, q.job_id)
                for q in self._r.queue)


@dataclass
class _ViewConfig:
    probe_d: int = 2
    probe_retries: int = 3
    revocation_mttf: float = 0.0  # ticks (SpotAwareProbing's rework price)


class _ClusterView:
    """The ``PlacementPolicy.bind`` protocol over the fleet: ``general_ids``
    are online on-demand replicas (long-pinnable), ``short_pool()`` is the
    active-transient protected pool."""

    def __init__(self, fleet: "ElasticServingFleet", cfg: _ViewConfig,
                 rng: np.random.Generator):
        self._fleet = fleet
        self.cfg = cfg
        self.rng = rng
        self.servers: Dict[int, _ReplicaView] = {}

    def register(self, rep: _Replica) -> None:
        self.servers[rep.rid] = _ReplicaView(rep)

    @property
    def general_ids(self) -> List[int]:
        return [r.rid for r in self._fleet.replicas
                if r.kind == "ondemand" and r.offline_at is None]

    def short_pool(self) -> List[int]:
        return [r.rid for r in self._fleet._transients()]


class ElasticServingFleet:
    def __init__(self, n_ondemand: int, *, threshold: float = 0.75,
                 max_transient: int = 0, provisioning_delay: int = 60,
                 hedge_factor: float = 4.0, max_slots: int = 1,
                 decode_fn: Optional[Callable] = None,
                 revocation_mttf_ticks: float = 0.0, seed: int = 0,
                 spec: Optional[ControllerSpec] = None,
                 short_policy: Optional[ShortPlacementPolicy] = None,
                 probe_d: int = 2, probe_retries: int = 3,
                 recorder=None, tracer=None, tenancy=None):
        self.spec = spec or ControllerSpec(threshold, max_transient,
                                           provisioning_delay)
        #: optional obs.EventRecorder / obs.Tracer — None keeps every
        #: emission site a single attribute check (zero-cost when off)
        self.recorder = recorder
        self.tracer = tracer
        #: optional repro_torch.tenancy.TenancyState — None keeps every tenant
        #: hook (per-tenant waits, SLO-debt drain/hedge victims) inert and
        #: the single-tenant paths bit-identical
        self.tenancy = tenancy
        self.provisioning_delay = int(self.spec.provisioning_delay)
        self.hedge_factor = hedge_factor
        self.max_slots = int(max_slots)
        self.decode_fn = decode_fn
        self.rng = np.random.default_rng(seed)
        self.revocation_mttf = revocation_mttf_ticks
        self.replicas: List[_Replica] = [
            _Replica(i, "ondemand", self.max_slots)
            for i in range(n_ondemand)]
        self.pending_online: List[int] = []  # ticks at which transients arrive
        self.lifetimes: List[int] = []
        self.n_revocations = 0
        self.n_hedges = 0
        self.n_hedge_cancelled = 0
        self._next_rid = n_ondemand
        self._active_area = 0.0
        self._ticks = 0
        self.peak_active = 0
        self.transient_counts: List[int] = []  # per-tick online transients
        #: per-tick decoded-slots / paid-slot-capacity (continuous batching)
        self.batch_occupancy: List[float] = []
        self._busy_slot_area = 0  # slot-ticks that decoded a token
        self._paid_slot_area = 0  # slot-ticks of online unpinned capacity
        self._tr_busy_slot_area = 0  # same, transients only
        self._tr_paid_slot_area = 0
        self._by_rid: Dict[int, _Replica] = {r.rid: r for r in self.replicas}
        # routing rng is independent of the revocation stream so the same
        # seed yields the same placement regardless of MTTF settings
        self._view = _ClusterView(
            self, _ViewConfig(probe_d, probe_retries, revocation_mttf_ticks),
            np.random.default_rng([seed, 1]))
        for r in self.replicas:
            self._view.register(r)
        self.short_policy = (short_policy or EagleProbing()).bind(self._view)
        # credit-bearing policies (TenantGuard) expose a bucket clock and a
        # throttle counter; cache the hooks so routing stays one attribute
        # check per request for every other policy
        self._policy_advance = getattr(self.short_policy, "advance", None)
        self._policy_throttles = hasattr(self.short_policy, "n_throttled")
        if self.tracer is not None:
            self.tracer.process_name(0, "fleet")
            for r in self.replicas:
                self.tracer.thread_name(0, r.rid, f"ondemand-{r.rid}")

    @classmethod
    def from_config(cls, cfg: ServingFleetConfig, *,
                    short_policy: Optional[ShortPlacementPolicy] = None,
                    decode_fn: Optional[Callable] = None, seed: int = 0,
                    drain_preference: str = "least_loaded",
                    recorder=None, tracer=None, tenancy=None
                    ) -> "ElasticServingFleet":
        spec = ControllerSpec(cfg.threshold, cfg.max_transient,
                              cfg.ticks(cfg.provisioning_delay),
                              drain_preference)
        mttf = cfg.revocation_mttf / cfg.tick_s if cfg.revocation_mttf else 0.0
        return cls(cfg.n_replicas + cfg.n_reserve,
                   hedge_factor=cfg.hedge_factor, max_slots=cfg.max_slots,
                   decode_fn=decode_fn,
                   revocation_mttf_ticks=mttf, seed=seed, spec=spec,
                   short_policy=short_policy, probe_d=cfg.probe_d,
                   probe_retries=cfg.probe_retries,
                   recorder=recorder, tracer=tracer, tenancy=tenancy)

    # ------------------------------------------------------------- internals

    def _stable(self) -> List[_Replica]:
        return [r for r in self.replicas
                if r.offline_at is None and not r.draining]

    def _transients(self) -> List[_Replica]:
        return [r for r in self._stable() if r.kind == "transient"]

    def _online_transients(self) -> List[_Replica]:
        """All online transients, including draining ones (they still serve
        and are still paid for — the capacity-area metric must count them)."""
        return [r for r in self.replicas
                if r.kind == "transient" and r.offline_at is None]

    @staticmethod
    def _primary_of(req: Request) -> Request:
        return req.primary if req.primary is not None else req

    def _finished(self, req: Request) -> bool:
        return self._primary_of(req).finish is not None

    def _route(self, req: Request, t: int):
        pol = self.short_policy
        if self._policy_advance is not None:
            self._policy_advance(t)  # refill burst-credit buckets to now
        before = pol.n_throttled if self._policy_throttles else 0
        sid = pol.select(float(req.gen_len), req.job_id)
        if (self._policy_throttles and pol.n_throttled > before
                and self.recorder is not None):
            self.recorder.emit(t, ev.THROTTLE, replica=sid, rid=req.rid)
        self._by_rid[sid].enqueue(req, t)

    def _bring_online(self, t: int) -> _Replica:
        nr = _Replica(self._next_rid, "transient", self.max_slots,
                      online_at=t)
        self._next_rid += 1
        self.replicas.append(nr)
        self._by_rid[nr.rid] = nr
        self._view.register(nr)
        if self.recorder is not None:
            self.recorder.emit(t, ev.PROVISION, replica=nr.rid)
        if self.tracer is not None:
            self.tracer.thread_name(0, nr.rid, f"transient-{nr.rid}")
            self.tracer.async_begin("transient", t, aid=nr.rid,
                                    cat="transient", tid=nr.rid)
        return nr

    def _apply_pinning(self, want: int, t: int):
        """Pin the first ``want`` on-demand replicas (long-job occupancy).

        ``want`` is clamped to the on-demand count — transients are never
        pinned. A replica transitioning to pinned hands its queue back to
        the router and requeues its slot-resident requests (progress
        restarts elsewhere): the long job takes the replica whole."""
        ond = [r for r in self.replicas
               if r.kind == "ondemand" and r.offline_at is None]
        want = min(want, len(ond))
        newly: List[_Replica] = []
        for i, r in enumerate(ond):
            if i < want and not r.pinned:
                newly.append(r)
            r.pinned = i < want
        for r in newly:
            residents: List[Request] = []
            for slot, d in r.slots.items():
                r.slots.release(slot)
                req = d.req
                if req.primary is None and not req.hedged:
                    req.start = None  # no live copy elsewhere: full restart
                residents.append(req)
            displaced = residents + list(r.queue)
            r.queue.clear()
            r.pending_ticks = 0
            for i, req in enumerate(displaced):
                if not self._finished(req):
                    if self.recorder is not None:
                        if i < len(residents):
                            self.recorder.emit(t, ev.DISPLACE,
                                               replica=r.rid, rid=req.rid)
                        self.recorder.emit(t, ev.REROUTE, replica=r.rid,
                                           rid=req.rid)
                    self._route(req, t)

    def _controller_tick(self, t: int):
        stable = self._stable()
        pinned = sum(1 for r in stable if r.pinned)
        view = FleetView(
            n_long_busy=pinned,
            n_online_stable=len(stable),
            n_draining=sum(1 for r in self.replicas
                           if r.draining and r.offline_at is None),
            n_pending=len(self.pending_online),
            n_active_transient=len(self._transients()),
        )
        delta = self.spec.desired_delta(view)
        record_rent(self.recorder, t, delta)
        for _ in range(max(delta, 0)):
            self.pending_online.append(t + self.provisioning_delay)
        # SLO-debt-aware victim selection (tenancy active): among the
        # least-loaded candidates, drain the replica whose residents have
        # the *most* SLO headroom — its tenants can afford the drain lag,
        # tenants already in debt keep their capacity
        if self.tenancy is not None:
            load_key = lambda r: (-self._replica_headroom(r), r.load)  # noqa: E731
        else:
            load_key = lambda r: r.load  # noqa: E731
        for _ in range(max(-delta, 0)):
            cands = self._transients()
            if not cands:  # guard: never drain more than remain
                break
            tr = select_drain(cands,
                              preference=self.spec.drain_preference,
                              load_key=load_key,
                              online_key=lambda r: r.online_at)
            tr.draining = True

    def _replica_headroom(self, r: _Replica) -> float:
        """Least SLO headroom across the replica's residents and queue —
        the replica is only as safe to victimize as its worst-off tenant.
        An idle replica is maximally safe."""
        ten = self.tenancy
        h = math.inf
        for _, d in r.slots.items():
            h = min(h, ten.headroom(self._primary_of(d.req).tenant_id))
        for q in r.queue:
            h = min(h, ten.headroom(self._primary_of(q).tenant_id))
        return h

    def _advance_replica(self, r: _Replica, t: int) -> int:
        """One decode tick for one replica: free slots whose hedged pair
        already won, admit queued requests into free slots, decode one token
        for every occupied slot. Returns the number of slots that decoded
        (the occupancy accounting's busy-slot count)."""
        if r.pinned:
            return 0
        for slot, d in r.slots.items():
            if self._finished(d.req):
                # the other copy of a hedged pair already won: cancel this one
                self.n_hedge_cancelled += 1
                r.pending_ticks -= d.tokens_left
                r.slots.release(slot)
        while r.queue and r.slots.n_free:
            req = r.queue.popleft()
            if self._finished(req):  # cancelled duplicate, never started
                self.n_hedge_cancelled += 1
                r.pending_ticks -= req.gen_len
                continue
            prim = self._primary_of(req)
            if prim.start is None:
                prim.start = t
                if self.tenancy is not None:
                    self.tenancy.record_wait(prim.tenant_id, t - prim.arrival)
            # pending_ticks already counts the admitted request
            r.slots.admit(_SlotDecode(req, req.gen_len, t))
            if self.recorder is not None:
                self.recorder.emit(t, ev.ADMIT, replica=r.rid, rid=req.rid)
        decoding = r.slots.items()
        if decoding:
            if self.decode_fn is not None:
                self.decode_fn(r.rid)  # one slot-batched step per replica
            for slot, d in decoding:
                d.tokens_left -= 1
                r.pending_ticks -= 1
                if d.tokens_left <= 0:
                    prim = self._primary_of(d.req)
                    if prim.finish is None:  # first completion wins
                        prim.finish = t + 1
                        if prim.hedged and self.recorder is not None:
                            self.recorder.emit(t, ev.HEDGE_WIN,
                                               replica=r.rid, rid=prim.rid)
                    if self.tracer is not None:
                        # tenant as the slice category: Perfetto can then
                        # filter/color request slices per tenant
                        prim0 = self._primary_of(d.req)
                        cat = (self.tenancy.names[prim0.tenant_id
                                                  % self.tenancy.n_tenants]
                               if self.tenancy is not None else None)
                        self.tracer.complete(
                            f"req {d.req.rid}", d.admit_t, t + 1 - d.admit_t,
                            tid=r.rid, cat=cat,
                            args={"gen_len": d.req.gen_len,
                                  "tenant": prim0.tenant_id})
                    r.slots.release(slot)
        if r.draining and not r.slots.n_active and not r.queue:
            r.offline_at = t
            self.lifetimes.append(t - r.online_at)
            if self.recorder is not None:
                self.recorder.emit(t, ev.DRAIN, replica=r.rid)
            if self.tracer is not None:
                self.tracer.async_end("transient", t, aid=r.rid,
                                      cat="transient", tid=r.rid,
                                      args={"end": "drain"})
        return len(decoding)

    def _maybe_hedge(self, t: int):
        reserve = [r for r in self._stable()
                   if r.kind == "ondemand" and not r.pinned]
        if not reserve:
            return
        due: List[Tuple[_Replica, Request]] = []
        for r in self._transients():
            cands = list(r.queue) + [d.req for _, d in r.slots.items()]
            for req in cands:
                if (req.hedged or req.primary is not None
                        or self._finished(req)):
                    continue
                on_transient = t - (req.routed_at if req.routed_at is not None
                                    else req.arrival)
                if on_transient > self.hedge_factor * req.gen_len:
                    due.append((r, req))
        if self.tenancy is not None and len(due) > 1:
            # SLO-debt-aware hedge order: the tenant deepest in debt gets
            # the emptiest reserve replica first (stable sort — scan order
            # breaks ties, so the single-tenant order is preserved)
            due.sort(key=lambda pair: self.tenancy.headroom(
                pair[1].tenant_id))
        for r, req in due:
            # §3.3: duplicate onto the on-demand reserve, first
            # completion wins — the original keeps its place here
            req.hedged = True
            self.n_hedges += 1
            copy = Request(req.rid, req.arrival, req.gen_len,
                           hedged=True, job_id=req.job_id,
                           tenant_id=req.tenant_id, primary=req)
            target = min(reserve, key=lambda x: x.load)
            target.enqueue(copy, t)
            if self.recorder is not None:
                self.recorder.emit(t, ev.HEDGE, replica=target.rid,
                                   rid=req.rid)
            if self.tracer is not None:
                # flow arrow from the stuck primary's transient
                # lane to the on-demand reserve lane it hedged onto
                self.tracer.flow_start("hedge", t,
                                       fid=self.n_hedges, tid=r.rid)
                self.tracer.flow_end("hedge", t, fid=self.n_hedges,
                                     tid=target.rid)

    def _maybe_revoke(self, t: int):
        if self.revocation_mttf <= 0:
            return
        for r in list(self._transients()):
            if self.rng.random() < 1.0 / self.revocation_mttf:
                self.n_revocations += 1
                r.offline_at = t
                self.lifetimes.append(t - r.online_at)
                if self.recorder is not None:
                    self.recorder.emit(t, ev.REVOKE, replica=r.rid)
                if self.tracer is not None:
                    self.tracer.async_end("transient", t, aid=r.rid,
                                          cat="transient", tid=r.rid,
                                          args={"end": "revoke"})
                n_q = len(r.queue)
                requeue = list(r.queue) + [d.req for _, d in r.slots.items()]
                r.queue.clear()
                r.slots.clear()
                r.pending_ticks = 0
                for i, req in enumerate(requeue):
                    if self._finished(req):
                        continue
                    if req.hedged and req.primary is None:
                        continue  # the on-demand copy carries it (§3.3)
                    if req.primary is None:
                        req.start = None  # restarts from scratch elsewhere
                    if self.recorder is not None:
                        if i >= n_q:  # slot resident, not a queued entry
                            self.recorder.emit(t, ev.DISPLACE,
                                               replica=r.rid, rid=req.rid)
                        self.recorder.emit(t, ev.REROUTE, replica=r.rid,
                                           rid=req.rid)
                    self._route(req, t)

    # ------------------------------------------------------------------ run

    def _tick(self, t: int, new_requests=(), pinned: Optional[int] = None):
        """One decode tick; ``run`` drives this, tests may drive it directly
        (``pinned`` is the long-occupancy target for this tick)."""
        if pinned is not None:
            self._apply_pinning(pinned, t)
        for due in [x for x in self.pending_online if x <= t]:
            self.pending_online.remove(due)
            self._bring_online(t)
        for req in new_requests:
            self._route(req, t)
        self._controller_tick(t)
        self._maybe_revoke(t)
        self._maybe_hedge(t)
        # paid slot capacity is counted in the same pass that advances each
        # replica: a draining replica that goes offline *inside* its advance
        # still served (and was paid for) this tick; pinned replicas cannot
        # decode, so their slots are long-job capacity, not serving capacity
        busy = cap = tr_busy = tr_cap = 0
        for r in self.replicas:
            if r.offline_at is not None:
                continue
            decoded = self._advance_replica(r, t)
            busy += decoded
            if not r.pinned:
                cap += r.max_slots
            if r.kind == "transient":
                tr_busy += decoded
                tr_cap += r.max_slots
        self.batch_occupancy.append(busy / cap if cap else 0.0)
        self._busy_slot_area += busy
        self._paid_slot_area += cap
        self._tr_busy_slot_area += tr_busy
        self._tr_paid_slot_area += tr_cap
        online = len(self._online_transients())
        self._active_area += online
        self.peak_active = max(self.peak_active, online)
        self.transient_counts.append(online)
        if self.tracer is not None:
            self.tracer.counter("queue_depth", t, sum(
                len(r.queue) for r in self.replicas
                if r.offline_at is None))
            self.tracer.counter("online_transients", t, online)
        self._ticks += 1

    def run(self, requests: List[Request], pinned_fn: Callable[[int], int],
            max_ticks: int):
        """``pinned_fn(t)`` -> number of on-demand replicas pinned by long
        jobs at tick t (the training-fleet occupancy signal)."""
        by_arrival: Dict[int, List[Request]] = {}
        for q in requests:
            by_arrival.setdefault(q.arrival, []).append(q)
        for t in range(max_ticks):
            self._tick(t, by_arrival.get(t, ()), pinned=pinned_fn(t))
        return self.summary(requests)

    def summary(self, requests: List[Request]) -> Dict[str, float]:
        from repro_torch.core.metrics import _pctl

        waits = [q.wait for q in requests if q.wait is not None]
        done = [q for q in requests if q.finish is not None]
        # zero started requests -> finite zeros (the shared _pctl
        # empty-input convention), never inf: downstream schema checks
        # reject non-finite metrics, and a stalled run should read as
        # "nothing served", not as an unrepresentable wait
        return {
            "n_requests": len(requests),
            "n_done": len(done),
            "avg_wait": float(np.mean(waits)) if waits else 0.0,
            "p99_wait": _pctl(np.asarray(waits, float), 99),
            "max_wait": float(np.max(waits)) if waits else 0.0,
            "avg_active_transients": self._active_area / max(self._ticks, 1),
            "peak_active_transients": self.peak_active,
            "n_transients_used": len([r for r in self.replicas
                                      if r.kind == "transient"]),
            "avg_lifetime_ticks": float(np.mean(self.lifetimes)) if self.lifetimes else 0.0,
            "n_revocations": self.n_revocations,
            "n_hedges": self.n_hedges,
            "n_hedge_cancelled": self.n_hedge_cancelled,
            # paid-capacity-weighted slot occupancy (continuous batching):
            # decoded slot-ticks over online unpinned slot-ticks — what the
            # rented capacity actually did, fleet-wide and transients-only
            "avg_slot_occupancy": self._busy_slot_area
            / max(self._paid_slot_area, 1),
            "transient_slot_occupancy": self._tr_busy_slot_area
            / max(self._tr_paid_slot_area, 1),
        }


# ------------------------------------------------------- trace -> workload

def build_serving_workload(trace, cfg: ServingFleetConfig
                           ) -> Tuple[List[Request], Callable[[int], int],
                                      int, Dict]:
    """Map a ``repro_torch.core.jobs.Trace`` onto the serving fleet.

    Short-class tasks become decode ``Request``s (one per task; ``gen_len``
    is the task duration in ticks) and the long class becomes the
    ``pinned_fn`` occupancy signal: per-tick long-task concurrency, scaled
    from the trace's general partition onto the fleet
    (``conc * n_replicas / n_general * pin_scale``, clamped to the base
    fleet — reserve replicas are serving-only).

    Returns ``(requests, pinned_fn, max_ticks, meta)``; ``max_ticks`` adds a
    25% drain tail past the last arrival. The request stream is capped at
    ``cfg.max_requests`` earliest arrivals (count reported in ``meta``).
    """
    tick_s = cfg.tick_s
    horizon_ticks = max(int(math.ceil(trace.horizon / tick_s)), 1)
    requests: List[Request] = []
    long_starts: List[float] = []
    long_ends: List[float] = []
    rid = 0
    for job in trace.jobs:
        if job.is_long:
            for d in job.durations:
                long_starts.append(job.arrival)
                long_ends.append(job.arrival + float(d))
        else:
            a = min(int(job.arrival / tick_s), horizon_ticks - 1)
            for d in job.durations:
                requests.append(Request(
                    rid, a, gen_len=max(int(round(d / tick_s)), 1),
                    job_id=job.job_id,
                    tenant_id=getattr(job, "tenant_id", 0)))
                rid += 1
    requests.sort(key=lambda q: (q.arrival, q.rid))
    n_dropped = max(len(requests) - cfg.max_requests, 0)
    if n_dropped:
        requests = requests[:cfg.max_requests]

    diff = np.zeros(horizon_ticks + 1)
    if long_starts:
        s = np.minimum((np.asarray(long_starts) / tick_s).astype(int),
                       horizon_ticks)
        e = np.minimum(np.ceil(np.asarray(long_ends) / tick_s).astype(int),
                       horizon_ticks)
        np.add.at(diff, s, 1.0)
        np.add.at(diff, e, -1.0)
    conc = np.cumsum(diff)[:horizon_ticks]
    n_general = cfg.n_general_ref or int(trace.meta.get("n_servers", 0)) \
        or cfg.n_replicas
    pinned = np.clip(
        np.rint(conc * (cfg.n_replicas / n_general) * cfg.pin_scale),
        0, cfg.n_replicas).astype(int)

    def pinned_fn(t: int) -> int:
        return int(pinned[t]) if t < pinned.size else 0

    last_arrival = requests[-1].arrival if requests else 0
    max_ticks = int(min(horizon_ticks, last_arrival + 1) * 1.25) + 1
    meta = {
        "horizon_ticks": horizon_ticks,
        "max_ticks": max_ticks,
        "n_requests": len(requests),
        "n_requests_dropped": n_dropped,
        "n_long_tasks": len(long_starts),
        "avg_pinned": float(pinned.mean()) if pinned.size else 0.0,
        "peak_pinned": int(pinned.max()) if pinned.size else 0,
    }
    return requests, pinned_fn, max_ticks, {"pinned_per_tick": pinned,
                                            **meta}

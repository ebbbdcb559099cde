"""Discrete-event simulator for Eagle-style hybrid scheduling with
CloudCoaster's transient manager.

The engine is a thin event loop: placement, and the §3.2 transient
controller are delegated to injected policy objects from ``repro_torch.sched``
(``LeastLoadedCentral`` + ``EagleProbing`` + ``ControllerSpec`` by default
— the paper's configuration). The engine owns only event dispatch,
enqueue/finish bookkeeping, and metric accumulation.

Cluster model (following the Hawk/Eagle simulators):
  * each server runs one task at a time with a FIFO queue;
  * long jobs are placed by the centralized long policy (least-loaded
    general server by default);
  * short tasks are placed by the decentralized short policy (power-of-d
    probing with Eagle's succinct-state long-avoidance by default; see
    ``repro_torch.sched.policy`` for the burst-guard and spot-aware variants);
  * CloudCoaster (replace_fraction > 0): on every long-task start/finish the
    long-load ratio l_r = N_long_busy / N_total is recomputed and the
    controller requests/drains transients against the budget K = r*N_s*p.

Revocations: transient lifetimes in the paper's regime stay far below spot
MTTF so the paper simulates none; set ``revocation_mttf`` to exercise the
revocation path (queued tasks rescheduled through the normal short path;
counted in the result).

Determinism: the same ``(trace, SimConfig, seed)`` with the same policies
yields a byte-identical ``SimResult`` — the policies draw from the engine's
single RNG in a fixed order.
"""

from __future__ import annotations

import heapq
from typing import List, Optional

import numpy as np

from repro_torch.core.cluster import Server, SimConfig
from repro_torch.core.jobs import Trace
from repro_torch.core.metrics import SimResult
from repro_torch.obs import events as ev
from repro_torch.sched.controller import (ControllerSpec, FleetView, record_rent,
                                    select_drain)
from repro_torch.sched.policy import (EagleProbing, LeastLoadedCentral,
                                PlacementPolicy, ShortPlacementPolicy)

_ARRIVAL, _FINISH, _ONLINE, _REVOKE = 0, 1, 2, 3


class _Sim:
    def __init__(self, trace: Trace, cfg: SimConfig, *,
                 long_policy: Optional[PlacementPolicy] = None,
                 short_policy: Optional[ShortPlacementPolicy] = None,
                 controller: Optional[ControllerSpec] = None,
                 recorder=None):
        self.trace = trace
        self.cfg = cfg
        #: optional obs.EventRecorder; None keeps emission sites one check
        self.recorder = recorder
        self.rng = np.random.default_rng(cfg.seed)
        self.now = 0.0
        self.events: List = []
        self._seq = 0

        self.servers: List[Server] = []
        # heterogeneous speeds: n_slow_general slow servers spread evenly
        # across the general partition (deterministic Bresenham pattern so
        # the same cfg always yields the same speed map)
        n_slow, n_gen = cfg.n_slow_general, cfg.n_general
        for i in range(cfg.n_general):
            slow = n_slow and ((i + 1) * n_slow) // n_gen > (i * n_slow) // n_gen
            self.servers.append(Server(
                i, "general", speed=cfg.hetero_slow_speed if slow else 1.0))
        for i in range(cfg.n_static_short):
            self.servers.append(Server(cfg.n_general + i, "short"))
        self.general_ids = list(range(cfg.n_general))
        self.static_short_ids = list(
            range(cfg.n_general, cfg.n_general + cfg.n_static_short))
        self.active_transients: List[int] = []  # online, not draining
        self.n_pending_transient = 0
        self.n_transients_created = 0

        # scheduling policies (repro_torch.sched) — bound to this cluster view
        self.long_policy = (long_policy or LeastLoadedCentral()).bind(self)
        self.short_policy = (short_policy or EagleProbing()).bind(self)
        self.controller = controller or ControllerSpec.from_sim_config(cfg)
        # tenancy hooks: token-bucket clock + throttle counter on the
        # policy (TenantGuardProbing); cached so other policies pay one
        # attribute check per construction, not per placement
        self._policy_advance = getattr(self.short_policy, "advance", None)
        self._policy_throttles = hasattr(self.short_policy, "n_throttled")

        # stats
        self.short_waits: List[float] = []
        self.long_waits: List[float] = []
        # per-tenant short waits when the trace is multi-tenant (the
        # builder encodes job_id % n_tenants == tenant_id, so no side
        # table); empty meta keeps single-tenant runs on the fast path
        meta = trace.meta or {}
        self.n_tenants = len(meta.get("tenants", ()))
        self.tenant_short_waits: List[List[float]] = [
            [] for _ in range(self.n_tenants)]
        self.lifetimes: List[float] = []
        self.n_long_busy = 0  # servers whose *running* task is long
        self.lr_samples: List = []
        self._tint_last_t = 0.0
        self._tint_area = 0.0
        self.peak_active = 0
        self.n_revocations = 0
        self.n_rescheduled = 0
        self.n_restarted = 0  # rescheduled tasks that had already started
        self.n_completed = 0

    # ------------------------------------------------------------ event glue

    def push(self, t: float, kind: int, payload=None):
        self._seq += 1
        heapq.heappush(self.events, (t, self._seq, kind, payload))

    # ------------------------------------------------------------- bookkeeping

    @property
    def n_online(self) -> int:
        return (self.cfg.n_general + self.cfg.n_static_short
                + len(self.active_transients) + self._n_draining)

    def lr(self) -> float:
        n = self.n_online
        return self.n_long_busy / n if n else 0.0

    def short_pool(self) -> List[int]:
        """Short-only partition: static on-demand + active transients."""
        return self.static_short_ids + self.active_transients

    def _tint_touch(self):
        dt = self.now - self._tint_last_t
        if dt > 0:
            self._tint_area += dt * len(self.active_transients)
            self._tint_last_t = self.now

    # --------------------------------------------------------------- serving

    def _start_next(self, s: Server):
        """If idle and queue nonempty, start the head task."""
        if s.running is not None or not s.queue:
            if (s.draining and s.running is None and not s.queue
                    and s.shutdown_t is None):
                self._shutdown(s)
            return
        dur, submit_t, is_long, job_id = s.queue.popleft()
        wait = self.now - submit_t
        if is_long:
            self.long_waits.append(wait)
        else:
            self.short_waits.append(wait)
            if self.n_tenants:
                self.tenant_short_waits[job_id % self.n_tenants].append(wait)
        s.running = (dur, self.now, is_long, job_id)
        s.run_gen += 1
        if self.recorder is not None:
            self.recorder.emit(self.now, ev.ADMIT, replica=s.sid,
                               rid=job_id)
        if is_long:
            self.n_long_busy += 1
            self._manager_tick()
        # dur is nominal work; service time stretches on slow servers
        self.push(self.now + dur / s.speed, _FINISH, (s.sid, s.run_gen))

    def _finish(self, sid: int, gen: int):
        s = self.servers[sid]
        if s.running is None or gen != s.run_gen:
            # stale event: the run this finish was scheduled for was revoked
            # (and possibly rescheduled) — the generation counter makes this
            # exact even for equal-duration tasks restarted at the same time
            return
        dur, start_t, is_long, job_id = s.running
        s.running = None
        s.pending_work -= dur
        self.n_completed += 1
        if is_long:
            s.n_long -= 1
            self.n_long_busy -= 1
        if s.kind == "general":
            self.long_policy.task_finished(sid)
        self._start_next(s)
        if is_long:
            self._manager_tick()

    def _enqueue(self, sid: int, dur: float, is_long: bool, job_id: int):
        s = self.servers[sid]
        s.queue.append((dur, self.now, is_long, job_id))
        s.pending_work += dur
        if is_long:
            s.n_long += 1
        self._start_next(s)

    # ------------------------------------------------------------- placement

    def _place_long(self, dur: float, job_id: int):
        sid = self.long_policy.select(dur, job_id)
        self._enqueue(sid, dur, True, job_id)
        self.long_policy.placed(sid)

    def _place_short(self, dur: float, job_id: int):
        if self._policy_advance is not None:
            self._policy_advance(self.now)
        if self._policy_throttles:
            before = self.short_policy.n_throttled
            sid = self.short_policy.select(dur, job_id)
            if self.short_policy.n_throttled > before \
                    and self.recorder is not None:
                self.recorder.emit(self.now, ev.THROTTLE, replica=sid,
                                   rid=job_id)
        else:
            sid = self.short_policy.select(dur, job_id)
        self._enqueue(sid, dur, False, job_id)

    # ------------------------------------------------------ transient manager

    @property
    def _n_draining(self) -> int:
        return self._draining_count

    def _manager_tick(self):
        cfg = self.cfg
        if cfg.n_replaced == 0:
            self._sample_lr()
            return
        view = FleetView(
            n_long_busy=self.n_long_busy,
            n_online_stable=self.n_online - self._n_draining,
            n_draining=self._n_draining,
            n_pending=self.n_pending_transient,
            n_active_transient=len(self.active_transients),
        )
        delta = self.controller.desired_delta(view)
        record_rent(self.recorder, self.now, delta)
        for _ in range(max(delta, 0)):
            self.n_pending_transient += 1
            self.push(self.now + self.controller.provisioning_delay,
                      _ONLINE, None)
        for _ in range(max(-delta, 0)):
            sid = select_drain(
                self.active_transients,
                preference=self.controller.drain_preference,
                load_key=lambda i: self.servers[i].pending_work,
                online_key=lambda i: self.servers[i].online_t)
            self.active_transients.remove(sid)
            self._tint_touch()
            s = self.servers[sid]
            s.draining = True
            self._draining_count += 1
            if s.idle:
                self._shutdown(s)
        self._sample_lr()

    def _server_online(self):
        cfg = self.cfg
        self.n_pending_transient -= 1
        sid = len(self.servers)
        s = Server(sid, "transient", online_t=self.now)
        self.servers.append(s)
        self.n_transients_created += 1
        self._tint_touch()
        self.active_transients.append(sid)
        self.peak_active = max(self.peak_active, len(self.active_transients))
        if self.recorder is not None:
            self.recorder.emit(self.now, ev.PROVISION, replica=sid)
        if cfg.revocation_mttf > 0:
            life = self.rng.exponential(cfg.revocation_mttf)
            self.push(self.now + life, _REVOKE, sid)
        self._sample_lr()

    def _shutdown(self, s: Server):
        s.shutdown_t = self.now
        s.draining = False
        self._draining_count -= 1
        self.lifetimes.append(self.now - s.online_t)
        if self.recorder is not None:
            self.recorder.emit(self.now, ev.DRAIN, replica=s.sid)

    def _revoke(self, sid: int):
        s = self.servers[sid]
        if s.shutdown_t is not None:
            return
        self.n_revocations += 1
        if self.recorder is not None:
            self.recorder.emit(self.now, ev.REVOKE, replica=sid)
        if sid in self.active_transients:
            self.active_transients.remove(sid)
            self._tint_touch()
        elif s.draining:
            self._draining_count -= 1
            s.draining = False
        # reschedule queued + running short tasks through the normal path
        requeue = list(s.queue)
        s.queue.clear()
        if s.running is not None:
            dur, start_t, is_long, job_id = s.running
            requeue.append((dur, start_t, is_long, job_id))
            s.running = None
            self.n_restarted += 1
            if self.recorder is not None:
                self.recorder.emit(self.now, ev.DISPLACE, replica=sid,
                                   rid=job_id)
        s.pending_work = 0.0
        s.n_long = 0
        s.shutdown_t = self.now
        self.lifetimes.append(self.now - s.online_t)
        for dur, _, is_long, job_id in requeue:
            self.n_rescheduled += 1
            if self.recorder is not None:
                self.recorder.emit(self.now, ev.REROUTE, replica=sid,
                                   rid=job_id)
            self._place_short(dur, job_id)

    def _sample_lr(self):
        if (not self.lr_samples
                or self.now - self.lr_samples[-1][0] >= 30.0):
            self.lr_samples.append((self.now, self.lr()))

    # ------------------------------------------------------------------ main

    def run(self) -> SimResult:
        self._draining_count = 0
        for job in self.trace.jobs:
            self.push(job.arrival, _ARRIVAL, job)
        while self.events:
            t, _, kind, payload = heapq.heappop(self.events)
            self.now = t
            if kind == _ARRIVAL:
                job = payload
                if job.is_long:
                    for dur in job.durations:
                        self._place_long(float(dur), job.job_id)
                else:
                    for dur in job.durations:
                        self._place_short(float(dur), job.job_id)
            elif kind == _FINISH:
                self._finish(*payload)
            elif kind == _ONLINE:
                self._server_online()
            elif kind == _REVOKE:
                self._revoke(payload)
        self._tint_touch()
        horizon = max(self.now, 1e-9)
        return SimResult(
            config=self.cfg,
            short_waits=np.asarray(self.short_waits),
            long_waits=np.asarray(self.long_waits),
            transient_lifetimes=np.asarray(self.lifetimes),
            avg_active_transients=self._tint_area / horizon,
            peak_active_transients=self.peak_active,
            lr_samples=np.asarray(self.lr_samples),
            n_revocations=self.n_revocations,
            n_rescheduled=self.n_rescheduled,
            extras={
                "n_transients_created": self.n_transients_created,
                "n_completed": self.n_completed,
                "n_restarted": self.n_restarted,
                "sim_end": self.now,
                "short_policy": self.short_policy.name,
                "long_policy": self.long_policy.name,
                **({"tenant_short_waits": [
                        np.asarray(w) for w in self.tenant_short_waits],
                    "tenants": list(self.trace.meta["tenants"]),
                    "tenant_slo_s": [
                        float(s)
                        for s in self.trace.meta.get(
                            "tenant_slo_s", [120.0] * self.n_tenants)]}
                   if self.n_tenants else {}),
                **({"n_throttled": self.short_policy.n_throttled}
                   if self._policy_throttles else {}),
            },
        )


def simulate(trace: Trace, cfg: SimConfig, *,
             long_policy: Optional[PlacementPolicy] = None,
             short_policy: Optional[ShortPlacementPolicy] = None,
             controller: Optional[ControllerSpec] = None,
             recorder=None) -> SimResult:
    """Run the DES. Policies default to the paper's configuration
    (centralized least-loaded longs, Eagle probing shorts, §3.2 controller
    derived from ``cfg``); pass ``repro_torch.sched`` objects to swap any of
    them. ``recorder`` (an ``repro_torch.obs.EventRecorder``) captures the typed
    scheduler event stream (times in seconds, ``replica`` = server id)."""
    return _Sim(trace, cfg, long_policy=long_policy,
                short_policy=short_policy, controller=controller,
                recorder=recorder).run()

"""The port's elastic serving fleet held against the JAX package's, on the
CPU: ``repro_torch.runtime.serving`` (a copy of the reference module), the
``serving`` engine of ``repro_torch.exp``, the fleet modes of
``repro_torch.launch.serve`` and ``repro_torch.launch.sim``, and the
``repro_torch.examples.serve_bursty`` twin with a model behind its
``decode_fn`` hook.

The fleet runs on the host in numpy in both packages and draws its routing
and revocations from ``np.random.default_rng``, so a faithful copy is byte
for byte the reference: on every ``serve_*`` preset at quick scale the
metrics (as JSON), series and per-tick event counts are equal; on the
deterministic cases of tests/test_obs.py, and on two presets, the full
event streams (ids included) are; the slot-level scripts of
tests/test_serving_slots.py leave both fleets in equal states. The example
twin decodes with the gemma2-2b smoke model on the CPU through a trace cut
to 10 minutes. Torch runs on one thread here, as in tests/test_torch_mamba.py.
"""

import json
import sys
from dataclasses import astuple, fields

import numpy as np
import pytest
import torch

import repro.exp as rx
import repro.launch.serve as rserve
import repro.launch.sim as rsim
import repro.obs as robs
import repro.runtime.serving as rserving
import repro.sched as rsched
import repro.sched.policy as rpolicy
from repro.runtime.batching import SlotState as RefSlotState

import repro_torch.exp as tx
import repro_torch.launch.serve as tserve
import repro_torch.launch.sim as tsim
import repro_torch.obs as tobs
import repro_torch.runtime.serving as tserving
import repro_torch.sched as tsched
import repro_torch.sched.policy as tpolicy
from repro_torch.examples import serve_bursty
from repro_torch.kernels import PLAIN_CALLS, reset_counts
from repro_torch.runtime.batching import SlotState

SERVE_PRESETS = [n for n in rsched.scenario_names() if n.startswith("serve_")]

#: test-sized serving kwargs (tests/test_serving_slots.py's)
SMALL_KW = dict(quick=True, seed=7, sim_seed=3,
                trace_overrides=dict(n_servers=150, n_short=8,
                                     horizon=2 * 3600.0))

#: the example twin's trace cut: 600 s of serve_yahoo's quick trace
EXAMPLE_HORIZON_S = 600.0


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Run this module's torch ops on one thread: the example's smoke model
    runs hundreds of small eager decode steps, and torch's intra-op pool
    stalls on them when other test processes hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _metrics_json(rr):
    return json.dumps(rr.metrics, indent=1, default=float)


def _assert_runs_equal(port, ref):
    assert _metrics_json(port) == _metrics_json(ref)
    assert sorted(port.series) == sorted(ref.series)
    for k in ref.series:
        assert np.array_equal(port.series[k], ref.series[k]), k
    assert port.config == ref.config and port.meta == ref.meta


# ------------------------------------------------------- presets, exp.run

@pytest.mark.parametrize("name", SERVE_PRESETS)
def test_serving_preset_byte_identical_to_reference(name):
    assert len(SERVE_PRESETS) == 7
    kw = dict(quick=True, seed=42, sim_seed=42, record_events=True)
    port = tx.run(name, "serving", **kw)
    ref = rx.run(name, "serving", **kw)
    _assert_runs_equal(port, ref)
    assert port.engine == "serving" and "event_counts" in port.series
    assert port.series["event_counts"].sum() > 0
    assert tx.validate_run_result(port) == []


def _fleet_events(pkg, name):
    """The fleet of ``exp.run(name, "serving", quick=True)`` built by hand
    from ``pkg``'s modules, with an EventRecorder: its full event list."""
    serving, sched, obs = pkg
    sc = sched.get_scenario(name)
    trace = sc.trace(quick=True, seed=42)
    cfg = sc.serving_config(quick=True)
    reqs, pinned_fn, max_ticks, _ = serving.build_serving_workload(trace, cfg)
    rec = obs.EventRecorder()
    fleet = serving.ElasticServingFleet.from_config(
        cfg, short_policy=sc.policies()[1], seed=42,
        drain_preference=sc.drain_preference, recorder=rec)
    summary = fleet.run(reqs, pinned_fn, max_ticks)
    return [astuple(e) for e in rec.events], summary


@pytest.mark.parametrize("name", ["serve_spot", "serve_tenant_trio"])
def test_full_event_stream_equals_reference(name):
    """Revocations and hedges (serve_spot), throttles and SLO-debt victim
    choice (serve_tenant_trio): every event with its replica and request."""
    port, port_sum = _fleet_events((tserving, tsched, tobs), name)
    ref, ref_sum = _fleet_events((rserving, rsched, robs), name)
    assert len(port) == len(ref) > 0
    assert port == ref
    assert port_sum == ref_sum


# ------------------------------------- deterministic cases of test_obs.py

def _det_cases(m):
    """tests/test_obs.py's ``_DET_CASES``, built from module ``m``."""
    cfg, req = m.ServingFleetConfig, m.Request
    six = [(0, 0, 3), (1, 2, 4), (2, 6, 2), (3, 8, 3), (4, 12, 2), (5, 21, 1)]
    return [
        (cfg(n_replicas=1, max_transient=0, threshold=0.5,
             provisioning_delay=3.0, tick_s=1.0),
         [req(0, 0, 3), req(1, 0, 2), req(2, 4, 1)], np.zeros(30, int), 30),
        (cfg(n_replicas=1, max_transient=1, threshold=0.5,
             provisioning_delay=3.0, tick_s=1.0),
         [req(*a) for a in six], None, 40),
        (cfg(n_replicas=1, max_transient=1, max_slots=2, threshold=0.5,
             provisioning_delay=3.0),
         [req(*a) for a in six], None, 40),
    ]


def _det_run(m, obs, case):
    cfg, reqs, pin, T = _det_cases(m)[case]
    if pin is None:
        pin = np.zeros(T, int)
        pin[5:20] = 1
    rec = obs.EventRecorder()
    fleet = m.ElasticServingFleet.from_config(cfg, seed=0, recorder=rec)
    fleet.run(reqs, lambda t: int(pin[t]) if t < len(pin) else 0, T)
    return fleet, rec, reqs, T


@pytest.mark.parametrize("case", range(3))
def test_deterministic_case_event_streams_equal_reference(case):
    fleet, rec, reqs, T = _det_run(tserving, tobs, case)
    ref_fleet, ref_rec, ref_reqs, _ = _det_run(rserving, robs, case)
    assert [astuple(e) for e in rec.events] == [astuple(e) for e in ref_rec.events]
    assert np.array_equal(rec.counts(T), ref_rec.counts(T))
    assert tobs.diff_event_streams(rec.counts(T), ref_rec.counts(T)) == []
    assert [(q.start, q.finish) for q in reqs] == \
        [(q.start, q.finish) for q in ref_reqs]
    assert fleet.summary(reqs) == ref_fleet.summary(ref_reqs)
    n_online = sum(1 for r in fleet.replicas
                   if r.kind == "transient" and r.offline_at is None)
    assert tobs.check_transient_conservation(
        rec, n_online_end=n_online, n_pending_end=len(fleet.pending_online),
        horizon=T) == []
    assert tobs.check_replica_lifecycles(rec) == []


# --------------------------------------- slot semantics, test_serving_slots

def _slot_state_admit(S):
    s, out = S(3), []
    out += [s.admit("a"), s.admit("b"), s.n_active, s.n_free, s.release(0),
            s.admit("c"), s.admit("d")]
    try:
        s.admit("e")
    except RuntimeError as e:
        out.append(str(e))
    out += [s.items(), s.occupancy]
    s.clear()
    return dict(trace=out, after_clear=(s.n_active, s.free_slot()))


def _slot_state_guards(S):
    s, out = S(2), []
    s.place(1, "x")
    for fn in (lambda: s.place(1, "y"), lambda: s.release(0), lambda: S(0)):
        try:
            fn()
        except (RuntimeError, ValueError) as e:
            out.append((type(e).__name__, str(e)))
    return dict(errors=out, free=s.free_slot())


def _freed_slot_admits_next_tick(m, _):
    fleet = m.ElasticServingFleet(1, max_transient=0, max_slots=2)
    reqs = [m.Request(0, 0, gen_len=1), m.Request(1, 0, gen_len=3),
            m.Request(2, 0, gen_len=2)]
    fleet._tick(0, reqs, pinned=0)
    at0 = [(q.start, q.finish) for q in reqs]
    fleet._tick(1, (), pinned=0)
    at1 = reqs[2].start
    for t in range(2, 6):
        fleet._tick(t, (), pinned=0)
    r = fleet.replicas[0]
    return dict(at0=at0, at1=at1, end=[(q.start, q.finish) for q in reqs],
                replica=(r.slots.n_active, len(r.queue), r.pending_ticks))


def _tick_decodes_every_slot(m, _):
    fleet = m.ElasticServingFleet(1, max_transient=0, max_slots=4)
    reqs = [m.Request(i, 0, gen_len=5) for i in range(4)]
    for t in range(6):
        fleet._tick(t, reqs if t == 0 else (), pinned=0)
    return dict(finish=[q.finish for q in reqs])


def _hedge_in_transient_slot(m, _):
    fleet = m.ElasticServingFleet(1, threshold=0.0, max_transient=0,
                                  hedge_factor=0.5, max_slots=2)
    tr = fleet._bring_online(0)
    req = m.Request(0, 0, gen_len=10)
    resident = None
    for t in range(30):
        fleet._tick(t, [req] if t == 0 else (), pinned=1 if t < 3 else 0)
        if t == 1:
            resident = any(d.req is req for _, d in tr.slots.items())
    ond = fleet.replicas[0]
    return dict(resident=resident, hedged=req.hedged, n_hedges=fleet.n_hedges,
                start=req.start, finish=req.finish,
                cancelled=fleet.n_hedge_cancelled,
                ondemand=(ond.slots.n_active, len(ond.queue)),
                n_done=fleet.summary([req])["n_done"])


def _drain_slot_residents(m, _):
    fleet = m.ElasticServingFleet(2, threshold=0.95, max_transient=4,
                                  provisioning_delay=1, max_slots=2)
    reqs = [m.Request(i, 0, gen_len=4) for i in range(40)]
    out = fleet.run(reqs, lambda t: 2 if t < 50 else 0, 500)
    drained = [(len(r.queue), r.slots.n_active) for r in fleet.replicas
               if r.kind == "transient" and r.offline_at is not None]
    return dict(summary=out, drained_empty=all(d == (0, 0) for d in drained),
                n_drained=len(drained),
                finishes=[q.finish for q in reqs])


def _revocation_requeues_residents(m, _):
    rng = np.random.default_rng(1)
    fleet = m.ElasticServingFleet(4, threshold=0.5, max_transient=8,
                                  provisioning_delay=5, max_slots=3,
                                  revocation_mttf_ticks=100, seed=1)
    reqs = [m.Request(i, int(rng.uniform(0, 800)), gen_len=6)
            for i in range(300)]
    out = fleet.run(reqs, lambda t: 3, 3000)
    return dict(summary=out, revoked=out["n_revocations"] > 0,
                waits=[q.wait for q in reqs])


def _occupancy_paid_capacity(m, _):
    fleet = m.ElasticServingFleet(1, max_transient=0, max_slots=4)
    tr = fleet._bring_online(0)
    tr.enqueue(m.Request(0, 0, gen_len=3))
    tr.enqueue(m.Request(1, 0, gen_len=3))
    for t in range(4):
        fleet._tick(t, (), pinned=1)
    s = fleet.summary([])
    return dict(occ=fleet.batch_occupancy, avg=s["avg_slot_occupancy"],
                tr=s["transient_slot_occupancy"])


def _pinned_not_paid(m, _):
    fleet = m.ElasticServingFleet(2, max_transient=0, max_slots=2)
    fleet._tick(0, [m.Request(0, 0, gen_len=2)], pinned=1)
    fleet._tick(1, (), pinned=0)
    return dict(occ=fleet.batch_occupancy)


def _view_pending_work(m, _):
    fleet = m.ElasticServingFleet(1, max_transient=0, max_slots=4)
    r = fleet.replicas[0]
    view = fleet._view.servers[r.rid]
    r.enqueue(m.Request(0, 0, gen_len=6))
    r.enqueue(m.Request(1, 0, gen_len=6))
    before = (view.pending_work, view.n_slots, view.free_slots)
    fleet._tick(0, (), pinned=0)
    return dict(before=before, free_after=view.free_slots,
                running_tasks=view.running_tasks, running=view.running)


def _running_entries(m, policy):
    class _SingleTask:
        running = (5.0, 0.0, False, 7)

    class _Idle:
        running = None

    fleet = m.ElasticServingFleet(1, max_transient=0, max_slots=3)
    view = fleet._view.servers[0]
    fleet._tick(0, [m.Request(0, 0, gen_len=4), m.Request(1, 0, gen_len=4)],
                pinned=0)
    return dict(single=policy.running_entries(_SingleTask()),
                idle=policy.running_entries(_Idle()),
                fleet=policy.running_entries(view), free=view.free_slots)


#: script -> what the reference's test asserts of it (checked on the port)
SLOT_SCRIPTS = {
    "freed_slot_admits_next_tick": (_freed_slot_admits_next_tick, dict(
        at0=[(0, 1), (0, None), (None, None)], at1=1,
        end=[(0, 1), (0, 3), (1, 3)], replica=(0, 0, 0))),
    "tick_decodes_every_occupied_slot": (_tick_decodes_every_slot, dict(
        finish=[5, 5, 5, 5])),
    "hedge_cancels_copy_when_primary_in_transient_slot": (
        _hedge_in_transient_slot, dict(
            resident=True, hedged=True, n_hedges=1, start=0, finish=10,
            cancelled=1, ondemand=(0, 0), n_done=1)),
    "drain_completes_slot_resident_requests": (_drain_slot_residents, dict(
        drained_empty=True)),
    "revocation_requeues_all_slot_residents": (
        _revocation_requeues_residents, dict(revoked=True)),
    "occupancy_weighted_paid_capacity": (_occupancy_paid_capacity, dict(
        occ=[0.5, 0.5, 0.5, 0.0], avg=6 / 16, tr=6 / 16)),
    "pinned_replica_is_not_paid_serving_capacity": (_pinned_not_paid, dict(
        occ=[0.5, 0.25])),
    "view_pending_work_is_slot_normalized": (_view_pending_work, dict(
        before=(3.0, 4, 4), free_after=2)),
    "running_entries_duck_typing": (_running_entries, dict(
        single=((5.0, 0.0, False, 7),), idle=(), free=1)),
}


@pytest.mark.parametrize("script", sorted(SLOT_SCRIPTS))
def test_slot_semantics_equal_reference(script):
    fn, want = SLOT_SCRIPTS[script]
    port, ref = fn(tserving, tpolicy), fn(rserving, rpolicy)
    assert port == ref
    for k, v in want.items():
        assert port[k] == v, k
    if script == "drain_completes_slot_resident_requests":
        assert port["summary"]["n_done"] == 40 and port["n_drained"] > 0
    if script == "revocation_requeues_all_slot_residents":
        assert port["summary"]["n_done"] == 300
    if script == "view_pending_work_is_slot_normalized":
        assert len(port["running_tasks"]) == 2 and port["running"] is not None
    if script == "running_entries_duck_typing":
        assert len(port["fleet"]) == 2


@pytest.mark.parametrize("fn", [_slot_state_admit, _slot_state_guards],
                         ids=["admit_on_lowest_free_slot", "place_and_release_guards"])
def test_slot_state_equals_reference(fn):
    port, ref = fn(SlotState), fn(RefSlotState)
    assert port == ref
    if fn is _slot_state_admit:
        assert port["trace"][:7] == [0, 1, 2, 1, "a", 0, 2]
        assert port["trace"][-2:] == [[(0, "c"), (1, "b"), (2, "d")], 1.0]
        assert port["after_clear"] == (0, 0)
    else:
        assert [e[0] for e in port["errors"]] == ["RuntimeError", "RuntimeError",
                                                  "ValueError"]


# ---------------------------------------------------- experiment surface

def test_serving_only_override_rejected_on_des_like_reference():
    for exp in (tx, rx):
        with pytest.raises(ValueError, match="engine='serving'"):
            exp.run("eagle", "des", quick=True, sim_overrides={"max_slots": 2})


def test_max_slots_sweep_equals_reference_and_goes_pointwise(monkeypatch):
    from repro_torch.exp import runner

    calls = []
    pointwise = runner._sweep_pointwise
    monkeypatch.setattr(runner, "_sweep_pointwise",
                        lambda *a, **k: calls.append(a[2]) or pointwise(*a, **k))
    grid = {"max_slots": [1, 2, 4]}
    port = tx.sweep("serve_batched_yahoo", grid, engine="serving", quick=True)
    ref = rx.sweep("serve_batched_yahoo", grid, engine="serving", quick=True)
    assert calls == ["serving"]
    assert port.shape == ref.shape == (3,) and port.engine == "serving"
    assert sorted(port.metrics) == sorted(ref.metrics)
    for k in ref.metrics:
        assert np.array_equal(port.metrics[k], ref.metrics[k], equal_nan=True), k
    assert port.best("short_avg_wait_s") == ref.best("short_avg_wait_s")
    w = [port.at(max_slots=s)["short_avg_wait_s"] for s in (1, 2, 4)]
    assert w[2] <= w[1] <= w[0]  # batching can only shorten queueing delay
    one = tx.run("serve_batched_yahoo", "serving", quick=True,
                 sim_overrides={"max_slots": 2})
    assert w[1] == one.metrics["short_avg_wait_s"]


def _as(cls, rr):
    """The same record as the other package's RunResult class."""
    return cls(**{f.name: getattr(rr, f.name) for f in fields(rr)})


@pytest.mark.parametrize("suffix", ["json", "npz"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_serving_runresult_cross_loads(tmp_path, writer, suffix):
    kw = dict(SMALL_KW, record_events=True)
    if writer == "port":
        rr = tx.run("serve_spot", "serving", **kw)
        back, rr = rx.RunResult.load(rr.save(tmp_path / f"a.{suffix}")), \
            _as(rx.RunResult, rr)
    else:
        rr = rx.run("serve_spot", "serving", **kw)
        back, rr = tx.RunResult.load(rr.save(tmp_path / f"a.{suffix}")), \
            _as(tx.RunResult, rr)
    assert back.equals(rr)
    assert back.to_json() == rr.to_json()
    assert "event_counts" in back.series


def test_tenant_trio_per_tenant_metrics_equal_reference_and_scale_once():
    """Per-tenant metrics equal the reference's at 2 s ticks, where the
    adapter rescales the TenantGuard buckets to ticks: twice in one process
    gives the same numbers, so the rescale happens once per run, on the
    run's own policy."""
    kw = dict(SMALL_KW, sim_overrides={"tick_s": 2.0})
    port = [tx.run("serve_tenant_trio", "serving", **kw) for _ in range(2)]
    ref = rx.run("serve_tenant_trio", "serving", **kw)
    assert port[0].config["tick_s"] == 2.0
    tenant = sorted(k for k in ref.metrics if k.startswith("tenant"))
    assert len(tenant) >= 10 and "n_throttled" in ref.metrics
    for rr in port:
        _assert_runs_equal(rr, ref)
    assert ref.metrics["n_throttled"] > 0


# --------------------------------------------------------------- launchers

def test_launch_serve_scenario_writes_reference_metrics(tmp_path, monkeypatch):
    argv = ["--scenario", "serve_yahoo", "--quick"]
    tserve.main(argv + ["--out", str(tmp_path / "port.json")])
    monkeypatch.setattr(sys, "argv", ["serve"] + argv
                        + ["--out", str(tmp_path / "ref.json")])
    rserve.main()
    port = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "ref.json").read_text())
    assert port["engine"] == ref["engine"] == "serving"
    assert json.dumps(port["metrics"]) == json.dumps(ref["metrics"])
    assert port["metrics"]["n_requests"] == 871


def test_launch_sim_serving_trace_equals_reference(tmp_path, monkeypatch):
    argv = ["--scenario", "serve_yahoo", "--quick", "--engine", "serving"]
    out = {w: (tmp_path / f"{w}.json", tmp_path / f"{w}.trace.json")
           for w in ("port", "ref")}
    tsim.main(argv + ["--out", str(out["port"][0]), "--trace-out",
                      str(out["port"][1])])
    monkeypatch.setattr(sys, "argv", ["sim"] + argv + [
        "--out", str(out["ref"][0]), "--trace-out", str(out["ref"][1])])
    rsim.main()
    port, ref = (json.loads(out[w][0].read_text()) for w in ("port", "ref"))
    assert json.dumps(port["metrics"]) == json.dumps(ref["metrics"])
    assert port["series"]["event_counts"] == ref["series"]["event_counts"]
    check = dict(require_counters=("queue_depth", "online_transients"),
                 require_async_cats=("transient",))
    assert tobs.validate_trace_file(str(out["port"][1]), **check) == []
    assert robs.validate_trace_file(str(out["port"][1]), **check) == []
    assert out["port"][1].read_text() == out["ref"][1].read_text()


# ----------------------------------------------------------- example twin

def _example(*args):
    return serve_bursty.main(["--horizon-s", str(EXAMPLE_HORIZON_S), *args])


def test_example_twin_paged_equals_dense_and_fleet_equals_no_model(tmp_path):
    bare = _example("--no-model")
    ref = rx.run("serve_yahoo", "serving", quick=True, seed=0, sim_seed=0,
                 trace_overrides={"horizon": EXAMPLE_HORIZON_S},
                 record_events=True)
    _assert_runs_equal(bare["elastic"], ref)
    tokens = {}
    for kv in ("dense", "paged"):
        reset_counts()
        trace = tmp_path / f"{kv}.trace.json"
        got = _example("--smoke", "--device", "cpu", "--kv", kv,
                       "--trace-out", str(trace))
        stats = got["decoder"]
        b = stats["batcher"]
        n_attn = sum(s.mixer == "attn" for s in b.model.layer_specs)
        # one batcher step per hook call, and each decodes every layer
        assert stats["calls"] == b.step_count > 100
        op = "paged_decode_attention" if kv == "paged" else "decode_attention"
        assert PLAIN_CALLS[op] == b.step_count * n_attn
        assert PLAIN_CALLS["flash_attention"] == len(stats["requests"]) * n_attn
        assert stats["n"] == sum(len(r.tokens) - 1 for r in stats["requests"])
        # the model changes nothing the scheduler decides
        for run in ("static", "elastic"):
            _assert_runs_equal(got[run], bare[run])
        assert tobs.validate_trace_file(str(trace),
                                        require_counters=("queue_depth",)) == []
        tokens[kv] = [r.tokens for r in stats["requests"]]
    assert tokens["paged"] == tokens["dense"]


def test_example_twin_raises_without_a_card(monkeypatch):
    """The model defaults to cuda: without a card the example raises unless
    it is given ``--device cpu`` or ``--no-model``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example()

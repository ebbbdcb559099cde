"""The port's scheduler (``repro_torch``'s DES, policies, controller,
scenarios, workload synthesis and experiment API) held against the JAX
package's, on the CPU.

Most of these modules are copies: each must equal its reference file but
for the import prefix (``sched/scenarios.py`` also for the fluid engine it
imports). The DES is numpy on the host in both packages, so
on every preset at a small scale (150 servers, 2 h, as tests/test_exp.py)
its metrics must be byte-identical as JSON and its series and event streams
equal. The fluid controller's torch form must equal the JAX form bit for
bit, inverted clip bounds included. Traces and results saved by one package
load in the other.
"""

import hashlib
import json
import os
import pathlib
import re
import subprocess
import sys
from dataclasses import astuple, fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.exp as rx
import repro.launch.sim as rsim
import repro.sched as rsched
import repro.workload as rwork
from repro.obs import EventRecorder as RefRecorder
from repro.sched.controller import fluid_controller_step as ref_controller_step

import repro_torch.exp as tx
import repro_torch.launch.sim as tsim
import repro_torch.sched as tsched
import repro_torch.traces as ttraces
import repro_torch.workload as twork
from repro_torch.obs import EventRecorder
from repro_torch.sched.controller import fluid_controller_step

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

#: test-sized cluster (tests/test_exp.py's) so DES runs stay fast
SMALL = dict(n_servers=150, n_short=8)
SMALL_SIM = dict(n_servers=150, n_short_reserved=8)
SMALL_KW = dict(quick=True, trace_overrides=dict(SMALL, horizon=2 * 3600.0),
                sim_overrides=SMALL_SIM)

#: modules the port carries as copies: equal to the reference file but for
#: the import prefix
COPIES = (
    "core/__init__.py", "core/cluster.py", "core/controller.py",
    "core/engine.py", "core/jobs.py", "core/metrics.py",
    "obs/events.py", "obs/metrics.py",
    "sched/__init__.py", "sched/policy.py",
    "tenancy/__init__.py", "tenancy/admission.py", "tenancy/metrics.py",
    "tenancy/spec.py",
    "workload/builders.py", "workload/io.py", "workload/jobmix.py",
    "workload/stats.py",
    "traces/__init__.py", "traces/synthetic.py",
    "configs/cloudcoaster.py",
    "exp/__init__.py",
    "runtime/serving.py",
)

#: copies with edits beyond the prefix: (reference text, port text) pairs,
#: each found exactly once
EDITED_COPIES = {
    "sched/scenarios.py": (
        ("JAX fluid simulator", "torch fluid simulator"),
        ("repro_torch.core.simjax import", "repro_torch.core.simtorch import"),
    ),
    # the port's program engine is gated as the reference's serving_jax is
    # (the registry-parity rule of repro_torch.analysis flags it otherwise)
    "exp/results.py": (
        ('''    "serving_jax": ("short_waits", "active_transients", "batch_occupancy",
                    "event_counts"),
''', '''    "serving_jax": ("short_waits", "active_transients", "batch_occupancy",
                    "event_counts"),
    "serving_torch": ("short_waits", "active_transients", "batch_occupancy",
                      "event_counts"),
'''),
        ('if rr.engine in ("des", "serving", "serving_jax") and rr.sim_seed is None:',
         'if rr.engine in ("des", "serving", "serving_jax", "serving_torch") \\\n'
         '            and rr.sim_seed is None:'),
        ('    if rr.engine == "serving_jax":\n',
         '    if rr.engine in ("serving_jax", "serving_torch"):\n'),
    ),
    # the port's tracer also records host-clock spans on the served path
    # (runtime/batching.py, models/decoder.py)
    "obs/trace.py": (
        ('''Zero-cost-when-disabled contract: engines hold ``tracer=None`` by default
and guard each call site; a constructed ``Tracer(enabled=False)`` is also
safe to call — every method returns before allocating anything (bounded by
tests/test_obs.py's tracemalloc check).

Times are engine ticks; ``tick_s`` scales them into the microsecond ``ts``
the format requires.
''',
         '''The served path (``runtime/batching.py``'s ``ContinuousBatcher``, and
``models/decoder.py``'s ``DecoderLM``) records host-clock spans with
:meth:`Tracer.span`: a context manager that writes one ``X`` event from
``time.perf_counter()`` at entry to its value at exit. Each span carries
its own ``id`` and its enclosing span's ``parent`` in ``args`` (``None``
at the top), and a span that belongs to a request carries its ``rid``, so
the spans of one request share it. Events stay in memory until
:meth:`Tracer.to_dict` or :meth:`Tracer.export`.

Zero-cost-when-disabled contract: engines hold ``tracer=None`` by default
and guard each call site; a ``with`` site takes the guarded form
``with (tracer.span(...) if tracer is not None else NO_SPAN):``, one check
and no allocation while tracing is off. A constructed
``Tracer(enabled=False)`` is also safe to call — every method returns
before allocating anything (bounded by the tracemalloc check of
tests/test_torch_batching_trace.py).

Times are seconds scaled by ``tick_s`` into the microsecond ``ts`` the
format requires: the fleet's engine ticks (``tick_s`` the tick's length),
or the host clock's seconds (``tick_s=1.0``, the default) for spans.
'''),
        ('''import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Tracer", "trace_from_run_result", "validate_trace_events",
           "validate_trace_file"]


class Tracer:
    """Trace-event collector. ``tick_s`` converts engine ticks to seconds
    (ts is emitted in microseconds, per the trace-event spec)."""

    __slots__ = ("enabled", "events", "_scale")

    def __init__(self, *, tick_s: float = 1.0, enabled: bool = True) -> None:
        self.enabled = enabled
        self.events: List[dict] = []
        self._scale = float(tick_s) * 1e6
''',
         '''import json
import time
from contextlib import nullcontext
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["NO_SPAN", "Tracer", "trace_from_run_result",
           "validate_trace_events", "validate_trace_file"]

NO_SPAN = nullcontext()
"""The one context a guarded ``with`` site enters while its tracer is
None (or disabled): shared, so tracing off allocates nothing."""


class _Span:
    __slots__ = ("tracer", "name", "args", "t0")

    def __init__(self, tracer: Tracer, name: str, args: dict) -> None:
        self.tracer, self.name, self.args = tracer, name, args

    def __enter__(self) -> None:
        tr = self.tracer
        tr._last_id += 1
        self.args["id"] = tr._last_id
        self.args["parent"] = tr._open[-1]["id"] if tr._open else None
        tr._open.append(self.args)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        tr = self.tracer
        tr._open.pop()
        tr.complete(self.name, self.t0, t1 - self.t0, args=self.args)


class Tracer:
    """Trace-event collector. ``tick_s`` converts engine ticks to seconds
    (ts is emitted in microseconds, per the trace-event spec); host-clock
    spans want ``tick_s=1.0``."""

    __slots__ = ("enabled", "events", "_scale", "_open", "_last_id")

    def __init__(self, *, tick_s: float = 1.0, enabled: bool = True) -> None:
        self.enabled = enabled
        self.events: List[dict] = []
        self._scale = float(tick_s) * 1e6
        self._open: List[dict] = []  # the args of each span entered, not left
        self._last_id = 0
'''),
        ('''    # -- flows (hedge arrows) ''',
         '''    # -- host-clock spans -------------------------------------------------
    def span(self, name: str, **args):
        """Context manager: one ``X`` event named ``name`` from
        ``time.perf_counter()`` at entry to exit, ``args`` plus its ``id``
        (from 1) and the ``id`` of the span open around it (``parent``)."""
        if not self.enabled:
            return NO_SPAN
        return _Span(self, name, args)

    def annotate(self, **args) -> None:
        """Add ``args`` to the innermost open span (counts known only at
        its end)."""
        if not self.enabled or not self._open:
            return
        self._open[-1].update(args)

    # -- flows (hedge arrows) '''),
    ),
    "obs/__init__.py": (
        ('''trace-event JSON export (open in Perfetto: ui.perfetto.dev)
''',
         '''trace-event JSON export (open in Perfetto: ui.perfetto.dev):
               the fleet's engine ticks, and host-clock spans
               (``Tracer.span``) inside the served path's batcher and
               model step
'''),
    ),
}

#: the reference's sha256 pins of the shim's traces (tests/test_workload.py)
SHIM_HASHES = {
    ("yahoo_like", "paper"):
        "6da88dad442fe03196614de0d2153293064a9dfa922ea163bd56a3faf57f3cc9",
    ("google_like", "paper"):
        "11cf7750ed78e21806242acc44cfd84f1bce45ca8a1677dc1d05b40894240628",
    ("yahoo_like", "small"):
        "8ae895c0f4f39ff4a4f014a197de8107a6e5064a669de56eb1823c478863f316",
    ("google_like", "small"):
        "71cbc87937b780f8cbe7884b6dd4666a6675d41b28fed3965e17221d50244eee",
}


def _trace_hash(tr):
    h = hashlib.sha256()
    for j in tr.jobs:
        h.update(np.float64(j.arrival).tobytes())
        h.update(np.uint8(j.is_long).tobytes())
        h.update(np.ascontiguousarray(j.durations, np.float64).tobytes())
    h.update(np.float64(tr.horizon).tobytes())
    return h.hexdigest()


def _assert_traces_equal(a, b):
    assert a.horizon == b.horizon and a.meta == b.meta
    assert len(a.jobs) == len(b.jobs)
    for x, y in zip(a.jobs, b.jobs):
        assert (x.job_id, x.arrival, x.is_long, x.tenant_id) == \
            (y.job_id, y.arrival, y.is_long, y.tenant_id)
        assert np.array_equal(x.durations, y.durations)


def _metrics_json(rr):
    return json.dumps(rr.metrics, indent=1, default=float)


# ------------------------------------------------------------------ copies

@pytest.mark.parametrize("rel", COPIES + tuple(EDITED_COPIES))
def test_copy_equals_reference_but_for_the_prefix(rel):
    ref = (SRC / "repro" / rel).read_text()
    port = (SRC / "repro_torch" / rel).read_text()
    want = re.sub(r"\brepro\.", "repro_torch.", ref)
    for old, new in EDITED_COPIES.get(rel, ()):
        assert want.count(old) == 1, (rel, old)
        want = want.replace(old, new)
    assert port == want


@pytest.mark.parametrize("name", rsched.scenario_names())
def test_scenario_preset_equals_reference(name):
    assert tsched.scenario_names() == rsched.scenario_names()
    assert len(tsched.scenario_names()) == 20
    ref, port = rsched.get_scenario(name), tsched.get_scenario(name)
    assert {f: getattr(port, f) for f in port.__dataclass_fields__} == \
        {f: getattr(ref, f) for f in ref.__dataclass_fields__}


def test_port_scenario_has_no_serving_config_and_arrivals_no_jax_half():
    """Named for the state before the serving fleet and the batch sampler
    were ported: the port's ``Scenario.serving_config`` now resolves every
    ``serve_*`` preset to the reference's fleet config (field for field,
    with and without a serving-only override), and the arrivals' batch
    half is present: every process has ``rate_grid`` and the package
    exports the sampler's entry points under the reference's names, with
    ``sample_counts_torch`` for ``sample_counts_jax``."""
    serve = [n for n in rsched.scenario_names() if n.startswith("serve_")]
    assert len(serve) == 7
    for name in serve:
        for quick in (True, False):
            for over in ({}, {"max_slots": 2, "threshold": 0.6}):
                port = tsched.get_scenario(name).serving_config(
                    quick=quick, sim_overrides=dict(over))
                ref = rsched.get_scenario(name).serving_config(
                    quick=quick, sim_overrides=dict(over))
                assert astuple(port) == astuple(ref), (name, quick, over)
    assert callable(twork.batch_sample_counts) and callable(twork.sample_counts_torch)
    assert not hasattr(twork, "sample_counts_jax")
    assert {n for n in dir(rwork) if "sample" in n} - {"sample_counts_jax"} <= \
        {n for n in dir(twork) if "sample" in n}
    for cls in (twork.Poisson, twork.MMPP, twork.Diurnal, twork.FlashCrowd,
                twork.Modulated, twork.Superpose):
        assert cls.rate_grid is not twork.ArrivalProcess.rate_grid, cls
    assert hasattr(twork.ArrivalProcess, "rate_grid")


# ------------------------------------------------------------------ traces

@pytest.mark.parametrize("builder", sorted(rwork.TRACE_BUILDERS))
def test_trace_builder_matches_reference(builder):
    assert sorted(twork.TRACE_BUILDERS) == sorted(rwork.TRACE_BUILDERS)
    kw = dict(seed=7, horizon=2 * 3600.0, **SMALL)
    _assert_traces_equal(twork.TRACE_BUILDERS[builder](**kw),
                         rwork.TRACE_BUILDERS[builder](**kw))


@pytest.mark.parametrize("fn,scale", sorted(SHIM_HASHES))
def test_shim_hashes_hold_on_the_port(fn, scale):
    kw = dict(seed=0)
    if scale == "small":
        kw.update(n_servers=200, horizon=3600.0)
        if fn == "yahoo_like":
            kw["n_short"] = 8
    assert _trace_hash(getattr(ttraces, fn)(**kw)) == SHIM_HASHES[fn, scale]


# --------------------------------------------------------------------- DES

@pytest.mark.parametrize("name", rsched.scenario_names())
def test_des_byte_identical_to_reference(name):
    port = tx.run(name, "des", seed=7, **SMALL_KW)
    ref = rx.run(name, "des", seed=7, **SMALL_KW)
    assert _metrics_json(port) == _metrics_json(ref)
    assert sorted(port.series) == sorted(ref.series)
    for k in ref.series:
        assert np.array_equal(port.series[k], ref.series[k]), k
    assert port.config == ref.config and port.meta == ref.meta
    # the scheduler event streams, through an EventRecorder each
    tr = tsched.get_scenario(name).trace(
        quick=True, seed=7, trace_overrides=SMALL_KW["trace_overrides"])
    rec, ref_rec = EventRecorder(), RefRecorder()
    tsched.get_scenario(name).run(quick=True, trace=tr, sim_overrides=SMALL_SIM,
                                  recorder=rec)
    rsched.get_scenario(name).run(quick=True, trace=tr, sim_overrides=SMALL_SIM,
                                  recorder=ref_rec)
    assert len(rec.events) == len(ref_rec.events)
    assert [astuple(e) for e in rec.events] == [astuple(e) for e in ref_rec.events]


def test_des_sweep_matches_reference():
    grid = {"r": [1.0, 3.0], "threshold": [0.9, 0.95]}
    port = tx.sweep("coaster_r3", grid, engine="des", seed=7, **SMALL_KW)
    ref = rx.sweep("coaster_r3", grid, engine="des", seed=7, **SMALL_KW)
    assert port.shape == ref.shape == (2, 2)
    assert sorted(port.metrics) == sorted(ref.metrics)
    for k in ref.metrics:
        assert np.array_equal(port.metrics[k], ref.metrics[k], equal_nan=True), k
    assert port.best("short_avg_wait_s") == ref.best("short_avg_wait_s")


# -------------------------------------------------------------- controller

def _controller_inputs(seed, lanes=512, slots=12):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.random(s).astype(np.float32)  # noqa: E731
    total = (400 + f(lanes) * 100).astype(np.float32)
    long_busy = (total * (0.7 + f(lanes) * 0.3)).astype(np.float32)
    n_tr = (f(lanes) * 60).astype(np.float32)
    pipe = (f(lanes, slots) * 8).astype(np.float32)
    thr = (0.8 + f(lanes) * 0.2).astype(np.float32)
    # budgets around what is already online or pending, so that
    # k_max - (n_tr + pipe.sum()) is below 0 for about half the lanes
    k_max = (n_tr + pipe.sum(-1) + (f(lanes) - 0.5) * 4).astype(np.float32)
    floor = (total - f(lanes) * 40).astype(np.float32)
    return long_busy, total, n_tr, pipe, thr, k_max, floor


@pytest.mark.parametrize("seed,slots", [(0, 12), (1, 3), (2, 1)])
def test_fluid_controller_step_bitwise_equal_to_reference(seed, slots):
    long_busy, total, n_tr, pipe, thr, k_max, floor = _controller_inputs(
        seed, slots=slots)
    ref = jax.vmap(lambda lb, tot, n, p, t, k, fl: ref_controller_step(
        lb, tot, n, p, threshold=t, max_transient=k, floor_total=fl))(
        *(jnp.asarray(a) for a in (long_busy, total, n_tr, pipe, thr, k_max,
                                   floor)))
    got = fluid_controller_step(
        *(torch.from_numpy(a) for a in (long_busy, total, n_tr, pipe)),
        threshold=torch.from_numpy(thr), max_transient=torch.from_numpy(k_max),
        floor_total=torch.from_numpy(floor))
    for name, r, g in zip(("lr", "add", "drain"), ref, got):
        assert np.array_equal(np.asarray(r), g.numpy()), name
    add, drain = got[1].numpy(), got[2].numpy()
    # inverted clip bounds: a budget overdrawn gives a negative add, as jnp.clip
    assert (add < 0).sum() > 10 and (add > 0).sum() > 10 and (drain > 0).sum() > 10


def test_fluid_controller_inverted_bounds_return_the_upper_bound():
    """``jnp.clip(x, 0, hi)`` with ``hi < 0`` returns ``hi``; so must the
    port (``max(min(x, hi), 0)`` would return 0)."""
    one = lambda v: np.asarray([v], np.float32)  # noqa: E731
    args = (one(380.0), one(400.0), one(10.0), np.zeros((1, 4), np.float32))
    kw = dict(threshold=one(0.9), max_transient=one(9.75), floor_total=one(390.0))
    ref = ref_controller_step(*(jnp.asarray(a[0]) for a in args[:3]),
                              jnp.asarray(args[3][0]),
                              **{k: jnp.asarray(v[0]) for k, v in kw.items()})
    got = fluid_controller_step(*(torch.from_numpy(a) for a in args),
                                **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert float(ref[1]) == -0.25
    assert got[1].tolist() == [-0.25]


# ------------------------------------------------------------ cross-loading

def test_trace_npz_cross_loads(tmp_path):
    """Both packages write the same npz bytes, and each loads the other's
    file to the trace it loads from its own."""
    tr = rwork.TRACE_BUILDERS["multi_tenant"](seed=3, horizon=3600.0, **SMALL)
    port_file = twork.save_trace(tmp_path / "port.npz", tr)
    ref_file = rwork.save_trace(tmp_path / "ref.npz", tr)
    assert port_file.read_bytes() == ref_file.read_bytes()
    _assert_traces_equal(twork.load_trace(ref_file), rwork.load_trace(ref_file))
    _assert_traces_equal(rwork.load_trace(port_file), twork.load_trace(port_file))
    assert _trace_hash(twork.load_trace(ref_file)) == _trace_hash(tr)


def _as(cls, rr):
    """The same record as the other package's RunResult class."""
    return cls(**{f.name: getattr(rr, f.name) for f in fields(rr)})


@pytest.mark.parametrize("suffix", ["json", "npz"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_runresult_cross_loads(tmp_path, writer, suffix):
    if writer == "port":
        rr = tx.run("spot_r3", "des", seed=7, **SMALL_KW)
        back, rr = rx.RunResult.load(rr.save(tmp_path / f"a.{suffix}")), \
            _as(rx.RunResult, rr)
    else:
        rr = rx.run("spot_r3", "des", seed=7, **SMALL_KW)
        back, rr = tx.RunResult.load(rr.save(tmp_path / f"a.{suffix}")), \
            _as(tx.RunResult, rr)
    assert back.equals(rr)
    assert back.to_json() == rr.to_json()


# ---------------------------------------------------------------- launcher

def test_launcher_des_writes_reference_metrics(tmp_path, monkeypatch):
    argv = ["--scenario", "burst_guard_r3", "--quick", "--engine", "des",
            "--servers", "150", "--short", "8", "--horizon-h", "2"]
    tsim.main(argv + ["--out", str(tmp_path / "port.json")])
    monkeypatch.setattr(sys, "argv", ["sim"] + argv
                        + ["--out", str(tmp_path / "ref.json")])
    rsim.main()
    port = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "ref.json").read_text())
    assert port["engine"] == ref["engine"] == "des"
    assert json.dumps(port["metrics"]) == json.dumps(ref["metrics"])


# ------------------------------------------------------------------- lint

def test_port_passes_the_reference_linter():
    from repro.analysis.core import LintContext

    scanned = {sf.rel for sf in LintContext.from_root(SRC / "repro_torch").files}
    assert {"runtime/serving.py", "examples/serve_bursty.py", "exp/runner.py",
            "launch/serve.py", "launch/sim.py", "core/engine.py",
            "runtime/serving_torch.py", "kernels/serving_fleet/ref.py",
            "launch/smoke.py", "examples/serve_multitenant.py",
            "examples/quickstart.py", "examples/trace_replay.py",
            "workload/arrivals.py", "runtime/threefry.py",
            "parallel/sharding.py", "parallel/layouts.py", "parallel/local.py",
            "parallel/distribute.py", "parallel/spawn.py", "launch/dryrun.py",
            "launch/mesh.py", "launch/specs.py"} <= scanned
    out = subprocess.run(
        [sys.executable, "-m", "repro.analysis.lint", "--root",
         str(SRC / "repro_torch"), "--rules", "determinism,obs-hygiene,static-shape"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s) from 3 rule(s)" in out.stdout, out.stdout


def test_serving_torch_schema_harvested_like_the_reference(monkeypatch):
    """The reference linter's harvesters, pointed at the port's engine: the
    traced names (``OVERRIDE_SPEC`` and ``make_params`` keys) stay out of
    ``FleetSpec``'s fields, and the plain program stacks one event column
    per ``EVENT_TYPES`` entry, as a run's ``event_counts`` holds."""
    from dataclasses import fields as dc_fields

    from repro.analysis import harvest
    from repro.analysis.core import LintContext, SourceFile

    from repro_torch.obs.events import EVENT_TYPES
    from repro_torch.runtime import serving_torch

    root = SRC / "repro_torch"
    monkeypatch.setattr(harvest, "SERVING_JAX_REL", "runtime/serving_torch.py")
    ctx = LintContext(root, [SourceFile(root, root / rel) for rel in
                             ("exp/runner.py", "runtime/serving_torch.py")], [])
    traced = harvest.harvest_traced_names(ctx)
    params = set(serving_torch.make_params(
        rsched.get_scenario("serve_yahoo").serving_config(quick=True)))
    assert params <= traced and {"threshold", "max_transient", "max_slots"} <= traced
    assert traced.isdisjoint(f.name for f in dc_fields(serving_torch.FleetSpec))
    ref_py = SourceFile(root, root / "kernels" / "serving_fleet" / "ref.py")
    width, _ = harvest.harvest_ev_counts_arity(ref_py)
    events, _ = harvest.harvest_event_types(SourceFile(root, root / "obs" / "events.py"))
    assert width == len(events) == len(EVENT_TYPES)

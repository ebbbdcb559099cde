"""The port's ``serving_torch`` engine held against the JAX package's
``serving_jax``, on the CPU.

``repro_torch.runtime.serving_torch`` runs the serving fleet as one program
over a lane axis; on the CPU that program is the plain PyTorch version
(``repro_torch.kernels.serving_fleet.ref``), the oracle the card's kernel
is held to. Its routing and revocation draws are ``jax.random``'s
(``repro_torch.runtime.threefry``), so it must equal the reference bit for
bit: every output array of the program on the three deterministic cases of
tests/test_obs.py and on random workloads of tests/test_serving_jax.py's
shape (8-entry queues that overflow included), and every metric and
series of ``exp.run`` on four quick-scale ``serve_*`` presets, stochastic
ones included. Torch runs on one thread here, as in
tests/test_torch_serving.py.
"""

import ast
import json
import pathlib
import runpy
import sys
from dataclasses import asdict, replace

import jax
import numpy as np
import pytest
import torch

import repro.exp as rx
import repro.launch.sim as rsim
from repro.launch import smoke as rsmoke
from repro.runtime import serving_jax as sj
from repro.runtime.serving import Request, ServingFleetConfig

import repro_torch.exp as tx
import repro_torch.launch.sim as tsim
from repro_torch.examples import serve_multitenant
from repro_torch.kernels import LAUNCHES, PLAIN_CALLS, reset_counts
from repro_torch.kernels.serving_fleet.ref import tick_keys
from repro_torch.launch import smoke as tsmoke
from repro_torch.obs import EventRecorder, diff_event_streams
from repro_torch.obs.metrics import REGISTRY
from repro_torch.runtime import serving as tserving
from repro_torch.runtime import serving_torch as st
from repro_torch.runtime import threefry

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

#: the quick-scale presets held bit for bit (revocations and spot pricing
#: in serve_spot, tenant credits in serve_tenant_trio, 4-slot replicas in
#: serve_batched_yahoo)
PRESETS = ("serve_yahoo", "serve_batched_yahoo", "serve_spot", "serve_tenant_trio")
QUICK = dict(quick=True, seed=42, sim_seed=0)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Run this module's torch ops on one thread: the plain program is a
    long chain of tiny ops, and torch's intra-op pool stalls on them when
    other test processes hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_RUNS = {}


def _run(pkg, name):
    """exp.run of a quick preset on the reference's ``serving_jax`` or the
    port's ``serving_torch`` on the CPU, once per module."""
    key = (pkg, name)
    if key not in _RUNS:
        _RUNS[key] = (rx.run(name, "serving_jax", **QUICK) if pkg == "ref" else
                      tx.run(name, "serving_torch", device="cpu", **QUICK))
    return _RUNS[key]


def _metrics_json(m):
    return json.dumps(m, indent=1, default=float)


# ---------------------------------------------------------------- threefry

@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 + 5])
def test_threefry_draws_equal_jax_random(seed):
    """The tick's draws (serving_jax.py:299, 404, 416, 421, 433, 527), bit
    for bit: probes (probe_retries, probe_d), fallbacks (probe_d,), the
    revocation vector (R,), and the bits under them."""
    key = jax.random.PRNGKey(np.uint32(seed))
    tkey = threefry.seed_key(seed)
    assert [int(w) for w in key] == [int(w) for w in tkey]
    for t in (0, 5, 36530):
        tk, ttk = jax.random.fold_in(key, t), threefry.fold_in(tkey, t)
        assert [int(w) for w in tk] == [int(w) for w in ttk]
        for i in (0, 3, 511):
            ek = jax.random.fold_in(jax.random.fold_in(tk, 1), i)
            tek = threefry.fold_in(threefry.fold_in(ttk, 1), i)
            for sub, shape in ((0, (3, 2)), (1, (2,))):
                want = np.asarray(jax.random.uniform(jax.random.fold_in(ek, sub), shape))
                got = threefry.uniform(threefry.fold_in(tek, sub), int(np.prod(shape)))
                assert np.array_equal(want.ravel().view(np.uint32),
                                      got.numpy().view(np.uint32))
        rk, trk = jax.random.fold_in(tk, 3), threefry.fold_in(ttk, 3)
        want = np.asarray(jax.random.uniform(rk, (200,)))
        assert np.array_equal(want.view(np.uint32),
                              threefry.uniform(trk, 200).numpy().view(np.uint32))
        bits = np.asarray(jax.random.bits(rk, (200,))).astype(np.int64)
        assert np.array_equal(bits, threefry.random_bits(trk, 200).numpy())
    # the per-tick keys of a batch of lanes, as the plain program makes them
    route, revoke = tick_keys(threefry.seed_key(torch.tensor([seed, 7])), 9)
    for lane, s in enumerate((seed, 7)):
        tk = jax.random.fold_in(jax.random.PRNGKey(np.uint32(s)), 8)
        for k, pair in ((1, route), (3, revoke)):
            want = jax.random.fold_in(tk, k)
            assert [int(w) for w in want] == [int(pair[0][lane, 8]), int(pair[1][lane, 8])]


# ------------------------------------------------------------ front-end copies

FRONT_END = ("INT", "DRAIN_CODES", "_pow2", "FleetSpec", "make_spec", "make_params",
             "build_consts", "summarize", "SWEEP_AXES")


def _top_level_source(path):
    text = path.read_text()
    lines = text.splitlines(keepends=True)
    out = {}
    for node in ast.parse(text).body:
        name = getattr(node, "name", None)
        if name is None and isinstance(node, ast.Assign):
            name = getattr(node.targets[0], "id", None)
        first = min([node.lineno] + [d.lineno for d in getattr(node, "decorator_list", [])])
        out[name] = "".join(lines[first - 1:node.end_lineno])
    return out


@pytest.mark.parametrize("name", FRONT_END)
def test_front_end_equals_reference_but_for_the_prefix(name):
    ref = _top_level_source(SRC / "repro" / "runtime" / "serving_jax.py")[name]
    port = _top_level_source(SRC / "repro_torch" / "runtime" / "serving_torch.py")[name]
    assert port == ref.replace("repro.", "repro_torch.")


def _rand_workload(seed, n=80, T=400):
    """tests/test_serving_jax.py's random workload."""
    rng = np.random.default_rng(seed)
    arr = np.sort(rng.integers(0, T - 20, n))
    reqs = [Request(i, int(arr[i]), int(rng.integers(1, 6))) for i in range(n)]
    pin = np.zeros(T, int)
    pin[50:150] = int(rng.integers(1, 3))
    pin[300:T] = 2  # keep transients online through run end
    return reqs, pin


_SMALL_CFG = ServingFleetConfig(n_replicas=2, max_transient=2, threshold=0.5,
                                provisioning_delay=3.0, tick_s=1.0)


def test_make_params_and_build_consts_equal_reference():
    reqs, pin = _rand_workload(0)
    for cfg, kw in ((_SMALL_CFG, {}),
                    (replace(_SMALL_CFG, revocation_mttf=50.0),
                     dict(n_tenants=3, credit_rate=[0.5, 0.0, 1.0],
                          credit_burst=[4.0, 2.0, 1e9]))):
        want, got = sj.make_params(cfg, **kw), st.make_params(cfg, **kw)
        assert sorted(want) == sorted(got)
        for k in want:
            assert np.asarray(want[k]).dtype == np.asarray(got[k]).dtype
            assert np.array_equal(want[k], got[k]), k
    spec = sj.make_spec(_SMALL_CFG, n_requests=len(reqs), max_ticks=400,
                        max_arrivals_per_tick=3)
    assert asdict(st.FleetSpec(**asdict(spec))) == asdict(spec)
    want, got = sj.build_consts(spec, reqs, pin), st.build_consts(spec, reqs, pin)
    for k in want:
        assert np.asarray(want[k]).dtype == np.asarray(got[k]).dtype
        assert np.array_equal(want[k], got[k]), k


# -------------------------------------------------- the program, bit for bit

#: tests/test_obs.py's deterministic cases: one on-demand replica, at most
#: one transient, no random choice anywhere
_DET_CASES = [
    (ServingFleetConfig(n_replicas=1, max_transient=0, threshold=0.5,
                        provisioning_delay=3.0, tick_s=1.0),
     [Request(0, 0, 3), Request(1, 0, 2), Request(2, 4, 1)], None, 30),
    (ServingFleetConfig(n_replicas=1, max_transient=1, threshold=0.5,
                        provisioning_delay=3.0, tick_s=1.0),
     [Request(0, 0, 3), Request(1, 2, 4), Request(2, 6, 2),
      Request(3, 8, 3), Request(4, 12, 2), Request(5, 21, 1)], 1, 40),
    (ServingFleetConfig(n_replicas=1, max_transient=1, max_slots=2,
                        threshold=0.5, provisioning_delay=3.0),
     [Request(0, 0, 3), Request(1, 2, 4), Request(2, 6, 2),
      Request(3, 8, 3), Request(4, 12, 2), Request(5, 21, 1)], 1, 40),
]


def _det_case(i):
    cfg, reqs, pinned, T = _DET_CASES[i]
    pin = np.zeros(T, int)
    if pinned:
        pin[5:20] = 1
    return cfg, reqs, pin, T


def _program_outputs(cfg, reqs, pin, T, sim_seed=0, queue_cap=None):
    """The reference's and the port's raw program outputs for one point."""
    spec = sj.make_spec(cfg, n_requests=len(reqs), max_ticks=T,
                        max_arrivals_per_tick=int(np.bincount([q.arrival for q in reqs]).max()),
                        queue_cap=queue_cap)
    consts = sj.build_consts(spec, reqs, pin)
    ref = sj.get_program(spec)(sj.make_params(cfg), consts, sj._seed_key(sim_seed))
    port = st.get_program(st.FleetSpec(**asdict(spec)), device="cpu")(
        st.make_params(cfg), consts, st._seed_key(sim_seed))
    return {k: np.asarray(v) for k, v in ref.items()}, port


def _assert_outputs_equal(ref, port):
    assert sorted(ref) == sorted(port)
    for k, v in ref.items():
        assert port[k].dtype == v.dtype and port[k].shape == v.shape, k
        assert np.array_equal(port[k], v), k


@pytest.mark.parametrize("case", range(len(_DET_CASES)))
def test_program_bitwise_on_deterministic_cases(case):
    ref, port = _program_outputs(*_det_case(case))
    _assert_outputs_equal(ref, port)
    assert port["event_counts"].sum() > 0


@pytest.mark.parametrize("seed", range(3))
def test_program_bitwise_on_random_workloads(seed):
    reqs, pin = _rand_workload(seed)
    ref, port = _program_outputs(_SMALL_CFG, reqs, pin, 400, sim_seed=seed)
    _assert_outputs_equal(ref, port)


def test_program_bitwise_with_queue_overflow():
    """tests/test_serving_jax.py's overflow case: 64 requests in a 10-tick
    burst onto 8-entry queues."""
    rng = np.random.default_rng(7)
    reqs = sorted((Request(i, int(rng.integers(0, 10)), int(rng.integers(3, 8)))
                   for i in range(64)), key=lambda q: q.arrival)
    reqs = [Request(i, q.arrival, q.gen_len) for i, q in enumerate(reqs)]
    ref, port = _program_outputs(_SMALL_CFG, reqs, np.zeros(200, int), 200, queue_cap=8)
    _assert_outputs_equal(ref, port)
    assert int(port["n_overflow"]) > 0


@pytest.mark.parametrize("case", range(len(_DET_CASES)))
def test_event_streams_equal_host_fleet_on_deterministic_cases(case):
    cfg, reqs, pin, T = _det_case(case)
    rec = EventRecorder()
    fleet = tserving.ElasticServingFleet.from_config(cfg, seed=0, recorder=rec)
    fleet.run([tserving.Request(q.rid, q.arrival, q.gen_len, job_id=q.job_id) for q in reqs],
              lambda t: int(pin[t]) if t < len(pin) else 0, T)
    _, series, _ = st.run_workload(cfg, reqs, pin, T, sim_seed=0, device="cpu")
    assert diff_event_streams(rec.counts(T), series["event_counts"]) == []


@pytest.mark.parametrize("name", PRESETS)
def test_quick_preset_bitwise_equal_to_serving_jax(name):
    ref, port = _run("ref", name), _run("port", name)
    assert _metrics_json(port.metrics) == _metrics_json(ref.metrics)
    assert sorted(port.series) == sorted(ref.series)
    for k, v in ref.series.items():
        assert port.series[k].dtype == v.dtype and np.array_equal(port.series[k], v), k
    assert port.meta["fleet_spec"] == ref.meta["fleet_spec"]
    assert port.config == ref.config and port.meta["workload"] == ref.meta["workload"]
    assert port.series["event_counts"].sum() > 0


def test_run_result_carries_the_serving_jax_contract():
    """exp/results.py validates only the ``serving_jax`` tag: the port's
    result carries the same series set, ``meta["fleet_spec"]`` and
    ``meta["obs"]``, so it passes that check under the reference's tag."""
    rr = _run("port", "serve_spot")
    assert rr.engine == "serving_torch" and rr.sim_seed == 0
    assert tx.validate_run_result(rr) == []
    assert tx.validate_run_result(replace(rr, engine="serving_jax")) == []
    assert set(tx.REQUIRED_SERIES["serving_jax"]) <= set(rr.series)
    assert {"jit_cache", "compile", "steady", "phase", "phase_means",
            "device"} <= set(rr.meta["obs"])
    assert rr.meta["obs"]["device"] == "cpu"
    assert rr.metrics["n_revocations"] > 0 and rr.metrics["n_hedges"] > 0


def test_repeated_spec_is_a_program_cache_hit():
    reqs, pin = _rand_workload(1)
    st.run_workload(_SMALL_CFG, reqs, pin, 400, sim_seed=1, device="cpu")
    misses = REGISTRY.counter("serving_torch.jit_cache_miss").value
    info = st.cache_info()
    m1, s1, spec = st.run_workload(_SMALL_CFG, reqs, pin, 400, sim_seed=1, device="cpu")
    assert st.cache_info().hits == info.hits + 1 and st.cache_info().misses == info.misses
    assert REGISTRY.counter("serving_torch.jit_cache_miss").value == misses
    obs = st.last_run_obs()
    assert obs["phase"] == "steady" and obs["program_cache_hit"]
    m2, _, _ = st.run_workload(_SMALL_CFG, reqs, pin, 400, sim_seed=1, spec=spec, device="cpu")
    assert m1 == m2


def test_cube_equals_single_points_and_the_reference_cube():
    reqs, pin = _rand_workload(2, n=120)
    axes = dict(thresholds=[0.25, 0.75], max_transients=[1, 2], max_slots_values=[1, 2],
                sim_seeds=(0, 1))
    reset_counts()
    grids, spec = st.sweep_cube(_SMALL_CFG, reqs, pin, 400, device="cpu", **axes)
    assert PLAIN_CALLS["serving_fleet"] == 1 and LAUNCHES["serving_fleet"] == 0
    ref_grids, ref_spec = sj.sweep_cube(_SMALL_CFG, reqs, pin, 400, **axes)
    assert asdict(spec) == asdict(ref_spec)
    assert sorted(grids) == sorted(ref_grids)
    for k, v in ref_grids.items():
        assert np.array_equal(grids[k], v), k
    # two lanes of the cube against their own single-point programs
    consts = st.build_consts(spec, reqs, pin)
    grid = [(s, t, k, m) for s in (0, 1) for t in axes["thresholds"]
            for k in axes["max_transients"] for m in axes["max_slots_values"]]
    params = st.cube_params(_SMALL_CFG, grid)
    keys = np.stack([st._seed_key(g[0]) for g in grid])
    cube = st.get_program(spec, batch="map", device="cpu")(params, consts, keys)
    for lane in (3, 14):
        one = st.get_program(spec, device="cpu")(
            {k: v[lane] for k, v in params.items()}, consts, keys[lane])
        for k, v in one.items():
            assert np.array_equal(cube[k][lane], v), k


def test_exp_sweep_cube_equals_reference():
    grid = {"threshold": [0.25, 0.75], "max_slots": [1, 4]}
    kw = dict(quick=True, seed=42, sim_seed=0,
              trace_overrides=dict(horizon=1800.0))
    port = tx.sweep("serve_batched_yahoo", grid, engine="serving_torch", device="cpu", **kw)
    ref = rx.sweep("serve_batched_yahoo", grid, engine="serving_jax", **kw)
    assert port.engine == "serving_torch" and port.shape == ref.shape == (2, 2)
    for k, v in ref.metrics.items():
        assert np.array_equal(port.metrics[k], v), k
    assert port.meta["fleet_spec"] == ref.meta["fleet_spec"]


# ------------------------------------------------------- the paper's scale

def test_chip_smoke_golden_values_equal_a_fresh_reference_run():
    """chip_smoke.py holds the card's paper-scale serve_batched_yahoo run to
    constants, since the chip machine has no JAX: they must be the
    reference's."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    rr = rx.run(chip_smoke.SERVE_TORCH_SCENARIO, "serving_jax", quick=False, seed=42,
                sim_seed=0)
    assert _metrics_json(rr.metrics) == _metrics_json(chip_smoke.SERVE_TORCH_GOLDEN)
    assert chip_smoke.event_counts_sha256(rr.series["event_counts"]) == \
        chip_smoke.SERVE_TORCH_GOLDEN_EVENTS
    assert rr.meta["fleet_spec"] == chip_smoke.SERVE_TORCH_PAPER_SPEC


# ----------------------------------------------- launcher, example, smoke

def test_launcher_serving_torch_equals_exp_run_and_reference(tmp_path, monkeypatch):
    argv = ["--scenario", "serve_batched_yahoo", "--quick", "--seed", "3",
            "--horizon-h", "0.5"]
    tsim.main(argv + ["--engine", "serving_torch", "--device", "cpu",
                      "--out", str(tmp_path / "port.json")])
    monkeypatch.setattr(sys, "argv", ["sim"] + argv + [
        "--engine", "serving_jax", "--out", str(tmp_path / "ref.json")])
    rsim.main()
    port = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "ref.json").read_text())
    assert port["engine"] == "serving_torch" and ref["engine"] == "serving_jax"
    assert json.dumps(port["metrics"]) == json.dumps(ref["metrics"])
    direct = tx.run("serve_batched_yahoo", "serving_torch", quick=True, seed=3, sim_seed=3,
                    trace_overrides=dict(horizon=1800.0), device="cpu")
    assert port["metrics"] == direct.metrics


def _table(text):
    """The example's table rows: label -> the two columns' numbers."""
    rows = {}
    section = None
    for line in text.splitlines():
        parts = line.split()
        if len(parts) == 3:
            try:
                rows[(section, parts[0])] = (float(parts[1]), float(parts[2]))
                continue
            except ValueError:
                pass
        if line and not line.startswith(" "):
            section = parts[0]
    return rows


def test_multitenant_example_equals_reference_table(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve_multitenant.py"])
    runpy.run_path(str(ROOT / "examples" / "serve_multitenant.py"), run_name="__main__")
    ref = capsys.readouterr().out
    serve_multitenant.main(["--device", "cpu"])
    port = capsys.readouterr().out
    assert "serving_jax" in ref and "serving_torch" in port
    ref_rows, port_rows = _table(ref), _table(port)
    assert len(ref_rows) == 12 and port_rows == ref_rows
    assert port_rows[("fleet", "n_throttled")][1] > 0


def test_smoke_driver_twin_equals_reference(tmp_path, monkeypatch):
    """The catalog driver on one serving preset, both packages: its jobs,
    schema gate and summary; DES and serving results byte-identical,
    serving_torch equal to serving_jax."""
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    common = ["--quick", "--scenario", "serve_batched_yahoo", "--processes", "1"]
    assert tsmoke.main(common + ["--device", "cpu", "--out-dir", str(port_dir)]) == 0
    assert rsmoke.main(common + ["--out-dir", str(ref_dir)]) == 0
    assert "serving_torch" in tsmoke.SINGLE_PROCESS_ENGINES
    port = json.loads((port_dir / "smoke_summary.json").read_text())
    ref = json.loads((ref_dir / "smoke_summary.json").read_text())
    rename = {"serving_jax": "serving_torch"}
    assert sorted((j["scenario"], j["engine"]) for j in port["jobs"]) == sorted(
        (j["scenario"], rename.get(j["engine"], j["engine"])) for j in ref["jobs"])
    for key in ("n_jobs", "n_crashed", "n_validated", "n_schema_invalid"):
        assert port[key] == ref[key], key
    for engine, ref_engine in (("des", "des"), ("serving", "serving"),
                               ("serving_torch", "serving_jax")):
        got = tx.RunResult.load(port_dir / f"serve_batched_yahoo-{engine}.runresult.npz")
        want = rx.RunResult.load(ref_dir / f"serve_batched_yahoo-{ref_engine}.runresult.npz")
        assert _metrics_json(got.metrics) == _metrics_json(want.metrics), engine
        for k, v in want.series.items():
            assert np.array_equal(got.series[k], v), (engine, k)

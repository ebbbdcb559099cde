"""The port's fluid engine (``repro_torch.core.simtorch``, a lane-batched
torch program) held against the JAX package's ``repro.core.simjax``, on the
CPU: single runs, the 2-D and 3-D sweep cubes, and the experiment API's
fluid paths (``exp.run``/``exp.sweep``, ``compare_engines``, ``calibrate``,
the launcher), on every scenario preset at a small scale (150 servers, 2 h,
as tests/test_exp.py).

Tolerance: summaries agree to rtol 1e-5 and series to 1e-5 of their max
|value|. That is the reference's own tolerance between a sweep point and a
single run (tests/test_simjax.py); the two packages order a few f32
operations differently (XLA contracts some multiply-adds), which moves a
few slots by one ulp. The qualitative checks of tests/test_simjax.py hold
on the port, and with no card the fluid entry points raise instead of
falling back to the CPU.
"""

import json
import sys

import numpy as np
import pytest
import torch

import repro.core.simjax as rsim_jax
import repro.exp as rx
import repro.launch.sim as rsim
import repro.sched as rsched
from repro.sched import FluidPolicyParams as RefParams
from repro.traces import yahoo_like as ref_yahoo_like

import repro_torch.exp as tx
import repro_torch.launch.sim as tsim
from repro_torch.core import SimConfig, simulate
from repro_torch.core.simtorch import FluidConfig, simulate_fluid, sweep, trace_to_rates
from repro_torch.sched import FluidPolicyParams
from repro_torch.traces import yahoo_like

RTOL = 1e-5
CPU = dict(device="cpu")
SMALL = dict(n_servers=150, n_short=8)
SMALL_SIM = dict(n_servers=150, n_short_reserved=8)
SMALL_KW = dict(quick=True, trace_overrides=dict(SMALL, horizon=2 * 3600.0),
                sim_overrides=SMALL_SIM)
CUBE = {"replace_fraction": [0.0, 0.25, 0.5, 0.75, 1.0],
        "threshold": [0.85, 0.9, 0.95, 0.99],
        "max_transient": [0.0, 4.0, 8.0, 12.0]}


def _close(got, ref, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0, err_msg=what)


def _series_close(got, ref, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = np.abs(ref).max() if ref.size else 0.0
    assert np.abs(got - ref).max(initial=0.0) <= RTOL * scale, what


def _setup():
    """tests/test_simjax.py's fixture: a 200-server, 3 h yahoo trace."""
    tr = yahoo_like(seed=11, n_servers=200, n_short=8, horizon=3 * 3600)
    lw, sw = trace_to_rates(tr, 10.0)
    cfg = FluidConfig(n_general=192, n_static_short=4, dt=10.0)
    return tr, lw, sw, cfg


def _ref_cfg(cfg):
    return rsim_jax.FluidConfig(**cfg.__dict__)


# ------------------------------------------------------- simulate_fluid/sweep

@pytest.mark.parametrize("case", ["eagle", "policy", "n_static_short",
                                  "one_provision_slot", "no_budget"])
def test_simulate_fluid_matches_simjax(case):
    _, lw, sw, cfg = _setup()
    kw = dict(threshold=0.93, max_transient=9.0)
    pol = ref_pol = None
    if case == "policy":
        pol = FluidPolicyParams(backlog_partition_share=0.5,
                                transient_availability=0.7)
        ref_pol = RefParams(backlog_partition_share=0.5,
                            transient_availability=0.7)
    elif case == "n_static_short":
        kw["n_static_short"] = 2
    elif case == "one_provision_slot":
        cfg = FluidConfig(n_general=192, n_static_short=4, dt=10.0,
                          provision_slots=1)
    elif case == "no_budget":
        kw["max_transient"] = 0.0
    got = simulate_fluid(lw, sw, cfg, policy=pol, **CPU, **kw)
    ref = rsim_jax.simulate_fluid(lw, sw, _ref_cfg(cfg), policy=ref_pol, **kw)
    assert sorted(got) == sorted(ref)
    for k in ref:
        if k == "series":
            assert sorted(got[k]) == sorted(ref[k])
            for s in ref[k]:
                _series_close(got[k][s], ref[k][s], s)
        else:
            assert got[k].shape == ()
            _close(got[k], ref[k], k)


@pytest.mark.parametrize("cube", ["2d", "3d"])
def test_sweep_matches_simjax(cube):
    _, lw, sw, cfg = _setup()
    thr, ks = np.array([0.85, 0.9, 0.95]), np.array([0.0, 4.0, 8.0, 12.0])
    kw = {}
    if cube == "3d":
        kw = dict(replace_fractions=np.array([0.0, 0.3, 0.5, 1.0]),
                  n_short_reserved=8)
    got = sweep(lw, sw, cfg, thr, ks, **kw, **CPU)
    ref = rsim_jax.sweep(lw, sw, _ref_cfg(cfg), thr, ks, **kw)
    assert sorted(got) == sorted(ref)
    shape = (3, 4) if cube == "2d" else (4, 3, 4)
    for k in ref:
        assert tuple(got[k].shape) == shape
        _close(got[k], ref[k], k)


def test_sweep_point_equals_single_run():
    _, lw, sw, cfg = _setup()
    grid = sweep(lw, sw, cfg, np.array([0.9, 0.95]), np.array([0.0, 8.0]),
                 replace_fractions=np.array([0.5, 1.0]), n_short_reserved=8,
                 **CPU)
    single = simulate_fluid(lw, sw, cfg, threshold=0.95, max_transient=8,
                            n_static_short=0, **CPU)
    for k in ("avg_short_delay", "avg_transients", "avg_lr"):
        _close(grid[k][1, 1, 1], single[k], k)


# ---------------------------------------------------------- experiment API

@pytest.mark.parametrize("name", rsched.scenario_names())
def test_fluid_run_matches_reference(name):
    got = tx.run(name, "fluid", seed=7, **SMALL_KW, **CPU)
    ref = rx.run(name, "fluid", seed=7, **SMALL_KW)
    assert got.engine == ref.engine == "fluid"
    assert got.config == ref.config and got.meta == ref.meta
    assert list(got.metrics) == list(ref.metrics)
    for k in ref.metrics:
        _close(got.metrics[k], ref.metrics[k], k)
    assert sorted(got.series) == sorted(ref.series)
    for k in ref.series:
        assert got.series[k].dtype == ref.series[k].dtype == np.float64
        _series_close(got.series[k], ref.series[k], k)
    assert tx.validate_run_result(got) == []


@pytest.mark.parametrize("axes", [("max_transient",),
                                  ("threshold", "max_transient"),
                                  ("replace_fraction", "threshold",
                                   "max_transient")])
def test_exp_sweep_fluid_matches_reference(axes):
    grid = {a: CUBE[a] for a in axes}
    got = tx.sweep("burst_guard_r3", grid, engine="fluid", seed=7,
                   **SMALL_KW, **CPU)
    ref = rx.sweep("burst_guard_r3", grid, engine="fluid", seed=7, **SMALL_KW)
    assert got.engine == ref.engine and list(got.axes) == list(ref.axes)
    for a in ref.axes:
        assert np.array_equal(got.axes[a], ref.axes[a])
    assert sorted(got.metrics) == sorted(ref.metrics)
    for k in ref.metrics:
        _close(got.metrics[k], ref.metrics[k], k)
    assert got.best("short_avg_wait_s") == pytest.approx(
        ref.best("short_avg_wait_s"), rel=RTOL)
    assert got.meta["n_points"] == ref.meta["n_points"]


def test_exp_sweep_point_equals_exp_run():
    """coaster_r3 at this scale has K = r·N_s·p = 3·8·0.5 = 12."""
    grid = {"threshold": [0.9, 0.95], "max_transient": [0.0, 12.0]}
    res = tx.sweep("coaster_r3", grid, engine="fluid", seed=7, **SMALL_KW,
                   **CPU)
    one = tx.run("coaster_r3", "fluid", seed=7, quick=True,
                 trace_overrides=SMALL_KW["trace_overrides"],
                 sim_overrides=dict(SMALL_SIM, threshold=0.95), **CPU)
    assert one.config["controller"]["max_transient"] == 12
    point = res.at(threshold=0.95, max_transient=12.0)
    for k in ("short_avg_wait_s", "avg_active_transients", "avg_lr"):
        _close(point[k], one.metrics[k], k)


def test_compare_engines_matches_reference():
    got = tx.compare_engines("coaster_r3", quick=True, seed=5, **CPU)
    ref = rx.compare_engines("coaster_r3", quick=True, seed=5)
    assert sorted(got["metrics"]) == sorted(ref["metrics"])
    for m, row in ref["metrics"].items():
        assert got["metrics"][m]["des"] == row["des"]
        _close(got["metrics"][m]["fluid"], row["fluid"], m)


def test_calibrate_chooses_the_reference_parameters():
    kw = dict(quick=True, seed=5, shares=(0.25, 0.5, 1.0), avails=(0.6, 1.0))
    got = tx.calibrate("burst_guard_r3", **kw, **CPU)
    ref = rx.calibrate("burst_guard_r3", **kw)
    assert got["before"]["policy"] == ref["before"]["policy"]
    assert got["fitted"]["policy"] == ref["fitted"]["policy"]
    for part in ("before", "fitted"):
        for m, row in ref[part]["metrics"].items():
            _close(got[part]["metrics"][m]["fluid"], row["fluid"], m)


def test_launcher_fluid_matches_reference(tmp_path, monkeypatch):
    argv = ["--scenario", "spot_r3", "--quick", "--servers", "150",
            "--short", "8", "--horizon-h", "2"]
    tsim.main(argv + ["--engine", "fluid", "--device", "cpu",
                      "--out", str(tmp_path / "port.json")])
    monkeypatch.setattr(sys, "argv", ["sim"] + argv
                        + ["--fluid", "--out", str(tmp_path / "ref.json")])
    rsim.main()
    got = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "ref.json").read_text())
    assert got["engine"] == ref["engine"] == "fluid"
    assert list(got["metrics"]) == list(ref["metrics"])
    for k, v in ref["metrics"].items():
        _close(got["metrics"][k], v, k)


def test_launcher_offers_the_ports_engines_only():
    with pytest.raises(SystemExit):
        tsim.main(["--engine", "serving_jax"])


# ------------------------------------------------------------ no fallback

@pytest.mark.parametrize("entry", ["simulate_fluid", "sweep", "exp.run",
                                   "exp.sweep", "launcher"])
def test_fluid_raises_without_a_card(entry, monkeypatch):
    """With no device given the fluid engine runs on cuda, and with no card
    it raises: it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, lw, sw, cfg = _setup()
    calls = {
        "simulate_fluid": lambda: simulate_fluid(lw, sw, cfg, threshold=0.95,
                                                 max_transient=8),
        "sweep": lambda: sweep(lw, sw, cfg, [0.9], [8.0]),
        "exp.run": lambda: tx.run("coaster_r3", "fluid", **SMALL_KW),
        "exp.sweep": lambda: tx.sweep("coaster_r3", {"threshold": [0.9]},
                                      **SMALL_KW),
        "launcher": lambda: tsim.main(["--quick", "--engine", "fluid"]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_des_needs_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rr = tx.run("coaster_r3", "des", seed=7, **SMALL_KW)
    assert rr.series["short_waits"].size > 0


# ------------------------------------------------ qualitative (test_simjax)

def test_monotone_in_budget():
    _, lw, sw, cfg = _setup()
    delays = [float(simulate_fluid(lw, sw, cfg, threshold=0.95,
                                   max_transient=k, **CPU)["avg_short_delay"])
              for k in (0, 4, 8, 12)]
    assert all(a >= b - 1e-6 for a, b in zip(delays, delays[1:])), delays
    assert delays[-1] < delays[0]


def test_budget_respected():
    _, lw, sw, cfg = _setup()
    out = simulate_fluid(lw, sw, cfg, threshold=0.9, max_transient=6, **CPU)
    assert float(out["peak_transients"]) <= 6 + 1e-6


def test_lr_in_range():
    _, lw, sw, cfg = _setup()
    out = simulate_fluid(lw, sw, cfg, threshold=0.95, max_transient=8, **CPU)
    lr = out["series"]["lr"].numpy()
    assert (lr >= 0).all() and (lr <= 1.0 + 1e-6).all()


def test_fluid_matches_des_ordering():
    """DES and fluid model agree on the ordering of (baseline, r=3)."""
    tr, lw, sw, cfg = _setup()
    des_base = simulate(tr, SimConfig(n_servers=200, n_short_reserved=8,
                                      replace_fraction=0.0)).summary()
    des_r3 = simulate(tr, SimConfig(n_servers=200, n_short_reserved=8,
                                    replace_fraction=0.5,
                                    cost_ratio=3.0)).summary()
    fl_base = simulate_fluid(lw, sw, cfg, threshold=0.95, max_transient=0, **CPU)
    fl_r3 = simulate_fluid(lw, sw, cfg, threshold=0.95, max_transient=12, **CPU)
    assert des_r3["short_avg_wait_s"] < des_base["short_avg_wait_s"]
    assert float(fl_r3["avg_short_delay"]) < float(fl_base["avg_short_delay"])


def test_trace_to_rates_equals_reference():
    tr = ref_yahoo_like(seed=11, n_servers=200, n_short=8, horizon=3 * 3600)
    for got, ref in zip(trace_to_rates(tr, 10.0),
                        rsim_jax.trace_to_rates(tr, 10.0)):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)

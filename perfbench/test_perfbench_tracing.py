"""Traced runs: the program's tracer in the run and the span metrics it
feeds, the slice's numbers (``kernels``, device intervals, the offset
between the host clock and the profiler's) from synthetic profiler events,
and the offset against a real profile on the CPU."""

import importlib.util
import pathlib
import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from perfbench import harness
from perfbench.conftest import CLOSED, DENSE, MOE, OPEN

HERE = pathlib.Path(__file__).resolve().parent


def _reader(name):
    spec = importlib.util.spec_from_file_location("reader_" + name,
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("config,traffic", [(DENSE, OPEN), (MOE, CLOSED)])
def test_traced_run_reads_the_program_spans(tiny, config, traffic):
    result, run = tiny(config, traffic, trace=True)
    m = {k: v["value"] for k, v in result["metrics"].items()}
    for name in ("admit_wait_ms", "first_token_hold_ms", "decode_issue_ms"):
        assert m[name] is not None and m[name] >= 0, name
    assert m["decode_issue_ms"] > 0 and m["first_token_hold_ms"] > 0
    assert "decode_issue_idle_share" not in m  # no slice on the CPU
    assert run.tracer is not None and run.model.tracer is run.tracer
    # the warm-up's spans were cleared: every submit is a planned request's
    rids = {e["args"]["rid"] for e in run.tracer.events if e["name"] == "batcher.submit"}
    assert rids == {s.plan.rid for s in run.served if not s.failed}
    # issue time lies inside the synchronised step that the stand-in times
    steps = [t1 - t0 for t0, t1, _ in run.timed.decodes if 0 <= t0 < run.seconds]
    assert m["decode_issue_ms"] <= 1e3 * sum(steps) / len(steps)
    assert result["correct"], result["checks"]


def test_untraced_run_has_no_tracer(tiny):
    result, run = tiny(DENSE, OPEN)
    assert run.tracer is None and run.model.tracer is None
    assert result["correct"], result["checks"]


def _ev(name, start, end, device=DeviceType.CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def _synthetic():
    """A slice of 1,000 us at profiler time 5,000 whose host clock reads
    the profiler's less 4,000 us (anchor 3 bracketed most narrowly)."""
    cpu = DeviceType.CPU
    anchors, events = [], [_ev("bench.slice", 5000.0, 6000.0, cpu)]
    for i, width in enumerate([8.0, 6.0, 9.0, 2.0, 7.0, 5.0, 6.0, 8.0]):
        mid = 5010.0 + 20 * i
        events.append(_ev("bench.anchor", mid - 0.5, mid + 0.5, cpu))
        skew = 0.0 if i == 3 else 3.0  # the profiler's range off the middle of wide brackets
        anchors.append(((mid - 4000.0 - width / 2 + skew) / 1e6,
                        (mid - 4000.0 + width / 2 + skew) / 1e6))
    events += [
        _ev("bench.decode", 5300.0, 5500.0, cpu), _ev("bench.prefill", 5600.0, 5900.0, cpu),
        _ev("bench.decode", 5300.0, 5400.0),  # a range's device annotation: no work
        _ev("void flash_wgmma_kernel<128>", 5600.0, 5700.0),
        _ev("void flash_wgmma_kernel<128>", 5750.0, 5800.0),
        _ev("void decode_kernel<bf16>", 5350.0, 5360.0),
        _ev("void combine_kernel<bf16>", 5360.0, 5362.0),
        _ev("void decode_kernel<bf16>", 5400.0, 5420.0),
        _ev("nvjet_gemm", 5300.0, 5340.0), _ev("nvjet_gemm", 5450.0, 5470.0),
        _ev("Memcpy HtoD (Pageable -> Device)", 5200.0, 5201.0),
    ]
    sl = {"t0": 1.0, "t1": 2.0, "anchors": anchors,
          "launches": {"flash_attention": 2, "paged_decode_attention": 1}}
    return events, sl


def test_read_slice_from_synthetic_events():
    events, sl = _synthetic()
    out = harness.read_slice(events, sl)
    assert (out["lo"], out["hi"], out["window_s"]) == (5000.0, 6000.0, 1e-3)
    assert out["offset_us"] == pytest.approx(4000.0) and out["offset_bracket_us"] == \
        pytest.approx(2.0)
    k = out["kernels"]
    assert set(k) == {"void flash_wgmma_kernel<128>", "void decode_kernel<bf16>",
                      "void combine_kernel<bf16>", "nvjet_gemm",
                      "Memcpy HtoD (Pageable -> Device)"}
    assert k["void flash_wgmma_kernel<128>"] == [2, pytest.approx(150e-6)]
    assert k["nvjet_gemm"] == [2, pytest.approx(60e-6)]
    # B1 and B2 as the kernels table has them
    assert (out["flash_recorded"], out["flash_s"]) == (2, pytest.approx(150e-6))
    assert k["void decode_kernel<bf16>"] == [out["decode_recorded"],
                                             pytest.approx(out["decode_s"])]
    assert out["decode_recorded"] == 2 and out["decode_issued"] == 2 and out["complete"]
    assert out["device_intervals"] == sorted(out["device_intervals"])
    assert len(out["device_intervals"]) == 8
    assert out["busy_s"] == pytest.approx((1 + 40 + 12 + 20 + 20 + 100 + 50) * 1e-6)
    # the gaps whose middle falls inside the decode range: 5,340-5,350,
    # 5,362-5,400 and 5,420-5,450 (5,470-5,600's middle is past its end)
    assert dict(out["idle_gaps"])["host: decode step launches"] == pytest.approx(78e-6)


def test_read_slice_without_every_anchor_maps_nothing():
    events, sl = _synthetic()
    events = [e for e in events if e is not events[1]]  # the first anchor lost
    assert harness.read_slice(events, sl)["offset_us"] is None


def test_decode_issue_idle_share_by_hand():
    events, sl = _synthetic()
    sl = harness.read_slice(events, sl)
    # two decode steps on the host clock: 5,300-5,480 and 5,900-6,100 us on
    # the profiler's (the second clipped at the slice's end)
    spans = [{"name": "model.decode_step", "ph": "X", "ts": 1300.0, "dur": 180.0},
             {"name": "model.decode_step", "ph": "X", "ts": 1900.0, "dur": 200.0}]
    run = SimpleNamespace(slices=[sl], tracer=SimpleNamespace(events=spans))
    busy = 40 + 12 + 20 + 20  # device time inside 5,300-5,480
    idle = (180 - busy) + 100
    assert _reader("decode_issue_idle_share")(run) == pytest.approx(100 * idle / 1000)
    assert _reader("decode_issue_idle_share")(
        SimpleNamespace(slices=[], tracer=run.tracer)) is None


def test_decode_issue_ms_leaves_out_the_profiled_slices():
    """Window 100-110 s on the host clock, a slice at 8-9 s of it."""
    spans = [{"name": "model.decode_step", "ph": "X", "ts": t * 1e6, "dur": d}
             for t, d in [(99.5, 9000.0), (101.0, 1000.0), (103.0, 2000.0),
                          (108.5, 7000.0), (110.5, 5000.0)]]
    run = SimpleNamespace(origin=100.0, seconds=10.0, slices=[{"t0": 8.0, "t1": 9.0}],
                          tracer=SimpleNamespace(events=spans))
    assert _reader("decode_issue_ms")(run) == pytest.approx(1.5)
    run.tracer = None
    assert _reader("decode_issue_ms")(run) is None


def test_offset_maps_the_host_clock_onto_a_real_profile():
    """On the CPU's profiler: a range bracketed by the host clock lands,
    once mapped, inside its bracket widened by the anchor's."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.slice"):
            anchors = harness.anchor_ranges()
            time.sleep(0.01)
            h0 = time.perf_counter()
            with record_function("probe"):
                torch.ones(64).sum()
            h1 = time.perf_counter()
    events = prof.events()
    notes = []
    sl = harness.Run._read_slice(SimpleNamespace(slices=[], note=notes.append), prof,
                                 {"anchors": anchors, "launches": {}})
    assert sl["device_ops"] == [] and "kernels' B2 entries (0, 0)" in notes[0]
    probe = next(e for e in events if e.name == "probe")
    off, tol = sl["offset_us"], sl["offset_bracket_us"] + 5.0
    assert 1e6 * h0 + off - tol <= probe.time_range.start
    assert probe.time_range.end <= 1e6 * h1 + off + tol


def test_no_retake_once_its_range_has_passed(few_threads, monkeypatch):
    """A slice read that outlasts the retake's range ends the tracing: no
    profile is started that the loop's end would leave open (the harness
    drives the profiler as on the card, with the CPU's events)."""
    orig = harness.read_slice

    def slow(events, sl):
        time.sleep(0.6)  # past the retake's range, 0.9-1.1 s
        return dict(orig(events, sl), complete=False)

    monkeypatch.setattr(harness, "read_slice", slow)
    monkeypatch.setattr(harness.Run, "sync", lambda self: None)
    cell = {"name": "tiny", "config": DENSE["name"], "traffic": "t", "chips": 1}
    run = harness.Run(cell, DENSE, OPEN, 11, 0.6, True, "cpu")
    run.cuda = True
    with torch.inference_mode():
        run.build()
        run.warm()
        run.serve()
    assert len(run.slices) == 1 and not run.slices[0]["complete"]
    assert run._prof is None and run._done

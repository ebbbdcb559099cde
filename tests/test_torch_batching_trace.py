"""Host-clock spans of the port's served path (``repro_torch.obs.trace``'s
``Tracer.span``) inside ``ContinuousBatcher`` and ``DecoderLM``, on the
paged layout with the tiny dense and MoE shapes of the benchmark's CPU
fixtures: one submit and one admit a request under its ``rid``, every
span inside the one its ``parent`` names, steps that never overlap, the
serial wait of a third admission behind two, the same tokens with and
without a tracer, a valid Chrome export, and tracing off allocating
nothing.
"""

import json
import pathlib
import sys
import tracemalloc

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.conftest import DENSE, MOE  # noqa: E402
from perfbench.harness import model_config  # noqa: E402
from repro_torch.models.decoder import DecoderLM  # noqa: E402
from repro_torch.obs.trace import NO_SPAN, Tracer, validate_trace_events  # noqa: E402
from repro_torch.runtime.batching import ContinuousBatcher, GenRequest  # noqa: E402

CONFIGS = {"dense": DENSE, "moe": MOE}
_PARAMS = {}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batcher(kind, tracer=None, max_slots=4):
    if kind not in _PARAMS:
        model = DecoderLM(model_config(CONFIGS[kind]))
        _PARAMS[kind] = model.init(torch.Generator().manual_seed(7), device="cpu")
    model = DecoderLM(model_config(CONFIGS[kind]), tracer=tracer)
    return ContinuousBatcher(model, _PARAMS[kind], max_slots=max_slots, max_len=128,
                             kv_layout="paged", kv_block_size=16, device="cpu",
                             tracer=tracer)


def _requests(n=6, seed=3):
    rng = np.random.default_rng(seed)
    return [GenRequest(rid=100 + i, prompt=rng.integers(1, 256, int(rng.integers(8, 60)))
                       .astype(np.int32), max_new=int(rng.integers(2, 7))) for i in range(n)]


def _serve(b, reqs, per_step=2):
    """Submit ``per_step`` requests before each step, then drain."""
    pending = list(reqs)
    while pending or b.queue or b.slots.n_active:
        for _ in range(min(per_step, len(pending))):
            b.submit(pending.pop(0))
        b.step()
    return reqs


def _spans(tr):
    return {e["args"]["id"]: e for e in tr.events if e["ph"] == "X"}


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_spans_nest_under_their_parents(kind):
    tr = Tracer()
    b = _batcher(kind, tr)
    reqs = _serve(b, _requests())
    spans = _spans(tr)
    by_name = {}
    for e in spans.values():
        by_name.setdefault(e["name"], []).append(e)
    submits = [e for e in tr.events if e["name"] == "batcher.submit"]
    admits = by_name["batcher.admit"]
    steps = by_name["batcher.step"]
    # one submit and one admit a request, under its rid
    assert sorted(e["args"]["rid"] for e in submits) == [r.rid for r in reqs]
    assert sorted(e["args"]["rid"] for e in admits) == [r.rid for r in reqs]
    assert all(e["args"]["prompt_len"] == len(r.prompt) and e["args"]["max_new"] == r.max_new
               for e, r in zip(sorted(submits, key=lambda e: e["args"]["rid"]), reqs))
    # every parent id is the enclosing span's, and the innermost one's
    for e in spans.values():
        p = e["args"]["parent"]
        if p is None:
            assert e["name"] == "batcher.step"
            continue
        assert _inside(e, spans[p]), (e, spans[p])
        between = [o for o in spans.values() if o is not e and o is not spans[p]
                   and _inside(e, o) and _inside(o, spans[p])]
        assert not between, (e["name"], [o["name"] for o in between])
    # each admit lies inside one step; prefill inside its admit
    for a in admits:
        assert spans[a["args"]["parent"]]["name"] == "batcher.step"
        kids = sorted(o["name"] for o in spans.values() if o["args"]["parent"] == a["args"]["id"])
        assert kids == ["batcher.first_token", "model.prefill", "paging.scatter"]
        assert a["args"]["pages"] >= 1 and a["args"]["bucket"] >= 16
    for name in ("model.decode_step", "batcher.sync"):
        assert by_name[name]
        assert all(spans[e["args"]["parent"]]["name"] == "batcher.step" for e in by_name[name])
    # steps never overlap, and count what they did
    steps.sort(key=lambda e: e["ts"])
    assert all(a["ts"] + a["dur"] <= b_["ts"] for a, b_ in zip(steps, steps[1:]))
    assert [e["args"]["step"] for e in steps] == list(range(len(steps)))
    assert sum(e["args"]["n_admitted"] for e in steps) == len(reqs)
    n_dec = sum(1 for e in steps if e["args"]["n_active"])
    assert len(by_name["model.decode_step"]) == len(by_name["batcher.sync"]) == n_dec
    # each model call: embed, one layer a layer (attention and FFN), unembed
    L = CONFIGS[kind]["model"]["num_layers"]
    ffn = "model.moe" if kind == "moe" else "model.mlp"
    for call in by_name["model.decode_step"] + by_name["model.prefill"]:
        kids = sorted((o for o in spans.values() if o["args"]["parent"] == call["args"]["id"]),
                      key=lambda o: o["ts"])
        assert [o["name"] for o in kids] == ["model.embed"] + ["model.layer"] * L + \
            ["model.unembed"]
        assert [o["args"]["i"] for o in kids[1:-1]] == list(range(L))
        for layer in kids[1:-1]:
            inner = sorted((o for o in spans.values()
                            if o["args"]["parent"] == layer["args"]["id"]), key=lambda o: o["ts"])
            assert [o["name"] for o in inner] == ["model.attn", ffn]


def test_third_admission_waits_behind_the_first_two():
    """Three requests queued before one step are admitted one after
    another: the serial wait inside a step that ``admit_wait_ms`` sees."""
    tr = Tracer()
    b = _batcher("dense", tr)
    for r in _requests(3):
        b.submit(r)
    b.step()
    admits = sorted((e for e in tr.events if e["name"] == "batcher.admit"),
                    key=lambda e: e["ts"])
    assert [e["args"]["rid"] for e in admits] == [100, 101, 102]
    third = admits[2]
    assert all(a["ts"] + a["dur"] <= third["ts"] for a in admits[:2])
    step = next(e for e in tr.events if e["name"] == "batcher.step")
    assert step["args"]["n_admitted"] == 3 and step["args"]["n_active"] == 3


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_tokens_identical_with_and_without_a_tracer(kind):
    plain = _serve(_batcher(kind), _requests())
    traced = _serve(_batcher(kind, Tracer()), _requests())
    off = _serve(_batcher(kind, Tracer(enabled=False)), _requests())
    assert [r.tokens for r in plain] == [r.tokens for r in traced] == [r.tokens for r in off]
    assert [(r.start_step, r.finish_step) for r in plain] == \
        [(r.start_step, r.finish_step) for r in traced]


def test_export_passes_the_schema_check(tmp_path):
    tr = Tracer()
    _serve(_batcher("moe", tr), _requests(4))
    assert validate_trace_events(tr.to_dict()) == []
    path = tr.export(str(tmp_path / "served.trace.json"))
    obj = json.loads(pathlib.Path(path).read_text())
    assert validate_trace_events(obj) == []
    assert {e["name"] for e in obj["traceEvents"]} >= {
        "batcher.submit", "batcher.step", "batcher.admit", "batcher.first_token",
        "batcher.sync", "paging.scatter", "model.prefill", "model.decode_step",
        "model.embed", "model.layer", "model.attn", "model.moe", "model.unembed"}


def test_span_ids_parents_and_annotate():
    tr = Tracer()
    with tr.span("a", rid=5):
        with tr.span("b"):
            tr.annotate(n=2)
        tr.annotate(m=1)
    with pytest.raises(RuntimeError):
        with tr.span("c"):
            raise RuntimeError("recorded all the same")
    ev = {e["name"]: e for e in tr.events}
    assert ev["a"]["args"] == {"rid": 5, "id": 1, "parent": None, "m": 1}
    assert ev["b"]["args"] == {"id": 2, "parent": 1, "n": 2}
    assert ev["c"]["args"] == {"id": 3, "parent": None}
    assert _inside(ev["b"], ev["a"]) and ev["a"]["dur"] >= ev["b"]["dur"] >= 0
    tr.annotate(x=1)  # no open span: nothing to add to
    assert "x" not in ev["c"]["args"]


def test_tracer_disabled_path_is_allocation_free():
    tr = Tracer(enabled=False)
    tracemalloc.start()
    base = tracemalloc.take_snapshot()
    for i in range(10_000):
        tr.complete("req", i, 1.0, tid=3)
        tr.counter("queue_depth", i, i % 7)
        tr.async_begin("transient", i, aid=i, cat="transient")
        with tr.span("batcher.admit", rid=i):
            tr.annotate(n_active=i)
    snap = tracemalloc.take_snapshot()
    tracemalloc.stop()
    grown = sum(s.size_diff for s in snap.compare_to(base, "lineno") if s.size_diff > 0)
    assert tr.events == [] and tr.span("x") is NO_SPAN
    # 50k disabled calls must not accumulate anything; the bound is loose
    # (interpreter noise) but catches any per-call allocation
    assert grown < 16_384, f"disabled tracer grew {grown} bytes"


def test_served_path_without_a_tracer_allocates_nothing_for_tracing():
    """With ``tracer=None`` every guarded site enters the shared NO_SPAN:
    no allocation is made in the tracer's module while serving."""
    b = _batcher("moe")
    reqs = _requests(4)
    trace_py = sys.modules[Tracer.__module__].__file__
    tracemalloc.start()
    _serve(b, reqs)
    snap = tracemalloc.take_snapshot().filter_traces(
        [tracemalloc.Filter(True, trace_py)])
    tracemalloc.stop()
    assert sum(s.size for s in snap.statistics("lineno")) == 0
    assert all(r.finish_step is not None for r in reqs)

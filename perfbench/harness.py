"""One run of one cell: build the replica, warm it, serve the cell's
traffic for the window, read the metrics, and judge what was served
against the plain reference.

The replica is the program's ``ContinuousBatcher`` over its ``DecoderLM``,
paged KV layout, bf16 pool of ``kv_block_size``-token blocks. The harness
submits each request when it is due and calls ``step()`` while there is
work; a token reaches the client when the ``step()`` call that produced it
returns, and every time is taken on the host clock from the window's start.

A traced run (``trace=True``) hands the batcher a thin stand-in for the
model that synchronises around each prefill and decode step and times it,
labels the host's work with profiler ranges, and profiles a fixed slice at
the end of the window (``trace_slice_s``), retaken one cycle later when
the profiler dropped kernel records. It also hands the program's model and
batcher one ``repro_torch.obs.trace.Tracer`` (``Run.tracer``; None in an
untraced run), whose host-clock spans a reader maps onto the slice's
profiler clock by the slice's ``offset_us``.

Each configuration is judged by the reference that its file's
``"reference"`` key names, a path from the repo root
(``perfbench/reference/decoder.py`` where the key is absent). The file
defines ``Ref(m, params, quant=None)``: ``m`` the configuration's
``"model"`` sizes, ``params`` the weights the benchmark made, ``quant``
None or ``"fp8"`` (the control). ``Ref.forward(tokens, n_prompt, routes)``
runs one request teacher-forced and returns ``{"logits": ...}`` (f32, one
row a served token), with ``routed_off_tie``, ``route_gap_max`` and
``keep_mismatch`` where the stack has experts; ``routes[j]`` is the routing
the program recorded in the j-th MoE layer of the stack, in layer order
(None in a stack without experts). A file that is missing or defines no
``Ref`` stops the run before it builds anything.
"""

from __future__ import annotations

import contextlib
import heapq
import importlib.util
import json
import math
import pathlib
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from perfbench import traffic as TR
from perfbench import weights
from perfbench import yardstick as Y
from perfbench.reference.decoder import capacity

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SLICE_TRIES = 3
ANCHORS = 8  # anchor ranges a slice brackets, to map the host clock onto the profiler's
DEFAULT_REFERENCE = "perfbench/reference/decoder.py"


def load_cell(workload: str, spec: Optional[dict] = None):
    """(cell, configuration file, traffic mix, limits) of a workload name."""
    spec = spec or json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in spec["workloads"]}[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((ROOT / entry["file"]).read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    return cell, config, TR.load(cell["traffic"]), limits


def load_reference(config: dict):
    """The ``Ref`` class of the file the configuration's ``"reference"``
    names (from the repo root; ``DEFAULT_REFERENCE`` without the key)."""
    rel = config.get("reference", DEFAULT_REFERENCE)
    path = (ROOT / rel).resolve()
    if not path.is_file():
        raise FileNotFoundError(f"configuration {config.get('name')!r}: its reference "
                                f"{rel!r} is missing")
    name = "perfbench_reference_" + "".join(c if c.isalnum() else "_" for c in rel)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    if not isinstance(getattr(mod, "Ref", None), type):
        raise ImportError(f"configuration {config.get('name')!r}: its reference {rel!r} "
                          f"defines no class Ref")
    return mod.Ref


def model_config(config: dict):
    from repro_torch.models.config import ModelConfig

    fields = dict(config["model"])
    for key in ("attn_pattern", "mixer_pattern"):
        if key in fields:
            fields[key] = tuple(fields[key])
    return ModelConfig(**fields)


# ------------------------------------------------------------------ serving


@dataclass
class Served:
    """A request as the client sees it."""
    plan: TR.Planned
    req: object = None  # the program's GenRequest once submitted
    due: float = math.inf
    times: List[float] = field(default_factory=list)  # one a served token
    slot: Optional[int] = None
    failed: bool = False


class Timed:
    """The model as the batcher sees it in a traced run: prefill and decode
    step between synchronisations, timed, in profiler ranges."""

    def __init__(self, model, clock: Callable[[], float], sync):
        self._model, self._clock, self._sync = model, clock, sync
        self.prefills: List[tuple] = []  # (t0, t1, true_len)
        self.decodes: List[tuple] = []  # (t0, t1, positions of the active slots)
        self.batcher = None

    def __getattr__(self, name):
        return getattr(self._model, name)

    def prefill(self, params, **kw):
        from torch.profiler import record_function

        self._sync()
        t0 = self._clock()
        with record_function("bench.prefill"):
            out = self._model.prefill(params, **kw)
            self._sync()
        self.prefills.append((t0, self._clock(), int(kw["true_len"])))
        return out

    def decode_step_paged(self, params, pools, **kw):
        from torch.profiler import record_function

        b = self.batcher
        positions = [int(b.pos[s]) for s, _ in b.slots.items()]
        self._sync()
        t0 = self._clock()
        with record_function("bench.decode"):
            out = self._model.decode_step_paged(params, pools, **kw)
            self._sync()
        self.decodes.append((t0, self._clock(), positions))
        return out


class Run:
    """Everything one run needs and records."""

    def __init__(self, cell, config, t, seed: int, seconds: float, trace: bool, device,
                 drain_s: Optional[float] = None):
        self.cell, self.config, self.t = cell, config, t
        self.m = config["model"]
        self.Ref = load_reference(config)
        # past the close, serve on until every request submitted finishes, for
        # at most this many seconds (None: the loop ends at the close)
        self.drain_s = drain_s
        self.tracer = None  # the program's Tracer, in a traced run
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.moe = bool(self.m.get("num_experts"))
        self.steps: List[tuple] = []  # (start, end, n_active) of each step()
        self.served: List[Served] = []
        self.records: Dict[str, dict] = {"prefill": {}, "decode": {}}  # routing by rid, by step
        self.slices: List[dict] = []
        self.origin = time.perf_counter()  # the window's start, set by serve()

    # ------------------------------------------------------------- helpers

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def note(self, text: str):
        print(text, file=sys.stderr, flush=True)

    # --------------------------------------------------------------- build

    def build(self):
        from repro_torch.models import mlp
        from repro_torch.models.decoder import DecoderLM
        from repro_torch.runtime.batching import ContinuousBatcher

        t = self.t
        t0 = time.perf_counter()
        torch.zeros(1, device=self.device)  # the CUDA context
        self.sync()
        t1 = time.perf_counter()
        self.model = DecoderLM(model_config(self.config))
        shapes = self.model.init_shape()
        t2 = time.perf_counter()
        self.params = weights.make(shapes, self.seed, self.device)
        self.sync()
        self.note(f"context {t1 - t0:.3f} s, model {t2 - t1:.3f} s, "
                  f"weights {time.perf_counter() - t2:.3f} s")
        extra = SLICE_TRIES * self._retake_s() if self.trace and self.cuda else 0.0
        self.plan = TR.plan(t, self.seed, self.seconds, extra)
        self.prompts = TR.prompts(self.plan, self.m["vocab_size"], self.seed)
        self.end_s = self.seconds + extra
        model = self.model
        if self.trace:
            model = Timed(self.model, self.clock, self.sync)
        self.batcher = ContinuousBatcher(
            model, self.params, max_slots=t["max_slots"], max_len=t["max_len"],
            kv_layout="paged",
            kv_block_size=t["kv_block_size"], device=self.device)
        if self.trace:
            from repro_torch.obs.trace import Tracer

            model.batcher = self.batcher
            # attributes, read by the program where it has spans, ignored where not
            self.tracer = Tracer()
            self.model.tracer = self.tracer
            self.batcher.tracer = self.tracer
        self.timed = model if self.trace else None
        if self.moe:
            mlp.RECORD = []
        self._mlp = mlp

    def _retake_s(self) -> float:
        return float(self.t["cycle_s"] if self.t["loop"] == "open" else self.t["trace_slice_s"])

    def warm(self):
        """Every prefill bucket the traffic uses, at its longest planned
        prompt, then decode steps: the shapes the window will see."""
        from repro_torch.runtime.batching import GenRequest

        rng = np.random.default_rng([self.seed, 99])
        longest: Dict[int, int] = {}
        for p in self.plan:
            b = TR.bucket_for(p.prompt_len, self.t)
            longest[b] = max(longest.get(b, 0), p.prompt_len)
        for i, (b, plen) in enumerate(sorted(longest.items())):
            prompt = rng.integers(1, self.m["vocab_size"], size=plen, dtype=np.int32)
            self.batcher.submit(GenRequest(rid=-1 - i, prompt=prompt, max_new=3))
        self.batcher.run()
        self.sync()
        if self.moe:
            self._mlp.RECORD.clear()
        if self.trace:
            self.timed.prefills.clear()
            self.timed.decodes.clear()
            self.tracer.events.clear()
            if self.cuda:  # the profiler's first start is slow: not in the window
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                    torch.zeros(1, device=self.device).add_(1)
                    self.sync()

    # --------------------------------------------------------------- serve

    def clock(self) -> float:
        return time.perf_counter() - self.origin

    def serve(self):
        from repro_torch.runtime.batching import GenRequest
        from repro_torch.runtime.paging import PagedCacheOOM
        from torch.profiler import record_function

        t, b = self.t, self.batcher
        lead = float(t["lead_in_s"])
        closed = t["loop"] == "closed"
        due_heap: list = []
        by_client: Dict[int, List[TR.Planned]] = {}
        if closed:
            for p in self.plan:
                by_client.setdefault(p.client, []).append(p)
            for c in by_client:
                by_client[c].reverse()
                heapq.heappush(due_heap, (TR.closed_start(t, c), c))
        pending: Deque[Served] = deque()  # submitted, not admitted (FIFO)
        running: List[Served] = []
        nxt = 0
        record = self._mlp.RECORD if self.moe else None
        n_moe = sum(1 for s in self.model.layer_specs if s.is_moe)
        self.step0 = b.step_count
        self.origin = time.perf_counter() + lead

        def submit(p: TR.Planned, due: float):
            s = Served(plan=p, due=due)
            self.served.append(s)
            s.req = GenRequest(rid=p.rid, prompt=self.prompts[p.rid], max_new=p.max_new,
                               arrival=b.step_count)
            try:
                b.submit(s.req)
            except (ValueError, PagedCacheOOM) as exc:
                s.failed = True
                self.note(f"request {p.rid} refused: {exc}")
                return
            pending.append(s)

        span = record_function if self.trace else (lambda name: contextlib.nullcontext())
        while True:
            now = self.clock()
            self._slice_edge(now)
            if now >= self.end_s and (
                    self.drain_s is None or now >= self.end_s + self.drain_s
                    or not (b.queue or b.slots.n_active
                            or (not closed and nxt < len(self.plan)))):
                break
            if closed:
                while now < self.end_s and due_heap and due_heap[0][0] <= now:
                    due, c = heapq.heappop(due_heap)
                    if by_client[c]:
                        submit(by_client[c].pop(), due)
            else:
                while nxt < len(self.plan) and self.plan[nxt].due <= now:
                    submit(self.plan[nxt], self.plan[nxt].due)
                    nxt += 1
            if not (b.queue or b.slots.n_active):
                if closed:
                    wake = due_heap[0][0] if due_heap else self.end_s
                else:
                    wake = self.plan[nxt].due if nxt < len(self.plan) else self.end_s
                wake = min(wake, self.end_s, self._next_edge())
                with span("bench.wait"):
                    time.sleep(max(0.0, wake - self.clock()))
                continue
            mark = len(record) if record is not None else 0
            with span("bench.step"):
                n_active = b.step()
            end = self.clock()
            step = b.step_count - 1
            self.steps.append((now, end, n_active))
            admitted = []
            while pending and pending[0].req.start_step is not None:
                admitted.append(pending.popleft())
            running.extend(admitted)
            if record is not None:
                self._keep_routes(record, mark, step, admitted, n_moe)
            still = []
            for s in running:
                req = s.req
                if s.slot is None:
                    s.slot = next((i for i, r in b.slots.items() if r is req), -1)
                new = len(req.tokens) - len(s.times)
                if new:
                    s.times.extend([end] * new)
                if req.finish_step is None:
                    still.append(s)
                elif closed:
                    heapq.heappush(due_heap, (end + float(t.get("think_s", 0.0)),
                                              s.plan.client))
            running = still
        self.sync()

    def _keep_routes(self, record, mark, step, admitted, n_moe):
        """The routing of this step's MoE calls, as the program recorded it:
        each prefill's (in admission order) and the decode step's."""
        entries = record[mark:]
        del record[mark:]
        for i, s in enumerate(admitted):
            calls = entries[i * n_moe:(i + 1) * n_moe]
            self.records["prefill"][s.plan.rid] = [(idx[0], keep[0]) for idx, _, keep in calls]
        dec = entries[len(admitted) * n_moe:]
        self.records["decode"][step] = [(idx[0], keep[0]) for idx, _, keep in dec]

    # ------------------------------------------------------------- tracing

    def _slice_edges(self):
        """(start, end) of each slice the traced run may profile."""
        d = float(self.t["trace_slice_s"])
        return [(self.seconds + k * self._retake_s() - d, self.seconds + k * self._retake_s())
                for k in range(SLICE_TRIES)]

    def _next_edge(self) -> float:
        if not self.trace or not self.cuda:
            return math.inf
        if getattr(self, "_prof", None) is not None:
            return self._slice_end
        edges = self._slice_edges()[len(self.slices):]
        return edges[0][0] if edges else math.inf

    def _slice_edge(self, now: float):
        """Start or stop the profiler at a slice's edges (traced runs on the
        card). A slice that recorded every kernel launch ends the trace."""
        if not self.trace or not self.cuda or getattr(self, "_done", False):
            return
        from repro_torch.kernels import LAUNCHES
        from torch.profiler import ProfilerActivity, profile, record_function

        prof = getattr(self, "_prof", None)
        if prof is None:
            edges = self._slice_edges()
            if len(self.slices) >= len(edges) or now < edges[len(self.slices)][0]:
                return
            if now >= edges[len(self.slices)][1]:
                # reading the last slice outlasted this one's range: no retake (a
                # profile started now would still be open when the loop ends)
                self._done = True
                self.end_s = max(self.seconds, now)
                return
            self.sync()
            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._rf = record_function("bench.slice")
            self._rf.__enter__()
            anchors = anchor_ranges()
            self._slice_end = edges[len(self.slices)][1]
            self._slice = {"t0": self.clock(), "launches": dict(LAUNCHES), "anchors": anchors}
        elif now >= self._slice_end:
            self.sync()
            self._rf.__exit__(None, None, None)
            self._slice["t1"] = self.clock()
            self._slice["launches"] = {k: LAUNCHES[k] - v
                                       for k, v in self._slice["launches"].items()}
            prof.__exit__(None, None, None)
            self._prof = None
            sl = self._read_slice(prof, self._slice)
            self.slices.append(sl)
            if sl["complete"]:
                self._done = True
                self.end_s = max(self.seconds, self.clock())

    def _read_slice(self, prof, sl: dict) -> dict:
        t0 = time.perf_counter()
        sl = read_slice(prof.events(), sl)
        sl["device_ops"] = _top_ops(prof)
        self.note(f"trace slice {len(self.slices) + 1} (read in {time.perf_counter() - t0:.1f} s)"
                  f": B2 {sl['flash_recorded']}/"
                  f"{sl['flash_issued']} B1 kernels {sl['decode_recorded']}/"
                  f"{sl['decode_issued']} recorded, busy {sl['busy_s']:.4f} of "
                  f"{sl['window_s']:.4f} s, host clock mapped within "
                  f"{sl['offset_bracket_us']:.1f} us; kernels' B2 entries "
                  f"{_named(sl['kernels'], 'flash')}, B1's {_named(sl['kernels'], 'decode_kernel')}"
                  f" (records, s); {len(sl['kernels'])} kernel names, "
                  f"{sum(1 for a, b in sl['device_intervals'] if a < sl['lo'] or b > sl['hi'])}"
                  f" device intervals outside the slice's range")
        return sl

    # ------------------------------------------------------------- results

    def counted(self) -> List[Served]:
        return [s for s in self.served if 0.0 <= s.due < self.seconds]

    def end_to_end(self) -> dict:
        T = self.seconds
        ttft, gaps, tokens = [], [], 0
        for s in self.served:
            times = s.times
            tokens += sum(1 for x in times if 0.0 <= x <= T)
            gaps.extend(b - a for a, b in zip(times, times[1:]) if 0.0 <= b <= T)
        for s in self.counted():
            first = s.times[0] if s.times else math.inf
            ttft.append(min(first, T) - s.due)
        return {"ttft_p95_ms": 1e3 * Y.percentile(ttft, 95),
                "itl_p95_ms": 1e3 * Y.percentile(gaps, 95),
                "tokens_per_s": tokens / T}


def anchor_ranges() -> List[tuple]:
    """Enter and leave ``ANCHORS`` empty profiler ranges named
    ``bench.anchor``; the host clock (``perf_counter``) just before and
    just after each, which ``read_slice`` maps onto the profiler's clock."""
    from torch.profiler import record_function

    out = []
    for _ in range(ANCHORS):
        a0 = time.perf_counter()
        with record_function("bench.anchor"):
            pass
        out.append((a0, time.perf_counter()))
    return out


def read_slice(events, sl: dict) -> dict:
    """The slice's numbers from the profiler's events (``prof.events()``):
    the ``bench.slice`` range's edges ``lo``, ``hi`` (profiler us), every
    device interval (``device_intervals``, sorted) and, by kernel name, its
    records and device seconds (``kernels``: name -> [count, seconds]),
    B1's and B2's among them, the idle time by host range, and
    ``offset_us``, the profiler's clock less the host's ``perf_counter``
    (in us), from the anchor range whose host bracket was narrowest."""
    from torch.autograd import DeviceType

    span = next(e for e in events if e.name == "bench.slice")
    lo, hi = span.time_range.start, span.time_range.end
    # the device side of the benchmark's own ranges is an annotation, no work
    kernels = [(e.time_range.start, e.time_range.end, e.name) for e in events
               if e.device_type == DeviceType.CUDA and not e.name.startswith("bench.")]
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU and e.name.startswith("bench.")
            and e.name not in ("bench.slice", "bench.anchor")]
    anchors = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.device_type == DeviceType.CPU and e.name == "bench.anchor")
    width, offset = math.inf, None  # no mapping unless every anchor was recorded
    if len(anchors) == len(sl["anchors"]):
        width, offset = min((a1 - a0, (s + e) / 2 - 1e6 * (a0 + a1) / 2)
                            for (a0, a1), (s, e) in zip(sl["anchors"], anchors))
    by_name: Dict[str, list] = {}
    for s, e, n in kernels:
        k = by_name.setdefault(n, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) / 1e6
    busy = Y.union_seconds([(s, e) for s, e, _ in kernels], lo, hi) / 1e6
    flash = [(s, e) for s, e, n in kernels if "flash" in n]
    dec = [(s, e) for s, e, n in kernels if "decode_kernel" in n]
    issued_flash = sl["launches"].get("flash_attention", 0)
    issued_dec = sl["launches"].get("paged_decode_attention", 0)
    return dict(
        sl, lo=lo, hi=hi, offset_us=offset, offset_bracket_us=1e6 * width,
        device_intervals=sorted((s, e) for s, e, _ in kernels), kernels=by_name,
        window_s=(hi - lo) / 1e6, busy_s=busy,
        flash_s=sum(e - s for s, e in flash) / 1e6, flash_recorded=len(flash),
        flash_issued=issued_flash,
        decode_s=sum(e - s for s, e in dec) / 1e6, decode_recorded=len(dec),
        decode_issued=2 * issued_dec,
        complete=len(flash) == issued_flash and len(dec) == 2 * issued_dec,
        idle_gaps=_idle_gaps(kernels, host, lo, hi))


def _named(kernels: Dict[str, list], part: str) -> tuple:
    """(records, device seconds) of the slice's kernels whose name holds
    ``part``."""
    rows = [v for k, v in kernels.items() if part in k]
    return sum(c for c, _ in rows), sum(t for _, t in rows)


def _top_ops(prof, n: int = 10) -> List[list]:
    from torch.autograd import DeviceType

    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("bench.")]
    rows.sort(key=lambda r: -r[1])
    return [[name[:160], us / 1e6] for name, us in rows[:n]]


LABELS = {"bench.prefill": "host: prefill launches", "bench.decode": "host: decode step launches",
          "bench.step": "host: batcher (admission, page tables, argmax sync)",
          "bench.wait": "host: waiting for arrivals"}


def _idle_gaps(kernels, host, lo, hi, n: int = 10) -> List[list]:
    """Device idle time in [lo, hi] (us), summed by what the host was doing
    at the middle of each gap (the innermost benchmark range)."""
    busy, cur = [], None
    for s, e, _ in sorted(kernels):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur and s <= cur[1]:
            cur[1] = max(cur[1], e)
        else:
            if cur:
                busy.append(cur)
            cur = [s, e]
    if cur:
        busy.append(cur)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    totals: Dict[str, float] = {}
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        inner = [h for h in host if h[0] <= mid <= h[1]]
        label = LABELS.get(min(inner, key=lambda h: h[1] - h[0])[2], "host: other") \
            if inner else "host: harness loop"
        totals[label] = totals.get(label, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


# --------------------------------------------------------------- correctness


def sample(run: Run) -> List[Served]:
    """Finished requests drawn from the seed until ``check_tokens`` served
    tokens, the ones with the longest prompt and the longest output first."""
    done = [s for s in run.served if s.req is not None and s.req.finish_step is not None
            and not s.failed]
    if not done:
        return []
    rng = np.random.default_rng([run.seed, 5])
    first = [max(done, key=lambda s: len(s.req.prompt)),
             max(done, key=lambda s: len(s.req.tokens))]
    order = first + [done[i] for i in rng.permutation(len(done))]
    out, seen, n = [], set(), 0
    for s in order:
        if id(s) in seen:
            continue
        seen.add(id(s))
        out.append(s)
        n += len(s.req.tokens)
        if n >= int(run.t["check_tokens"]):
            break
    return out


def routes(run: Run, s: Served) -> Optional[List[dict]]:
    """Per MoE layer, the program's routing of the request's prompt (one
    group, capacity of its bucket) and of each decode token (its step's
    group; ``prior`` counts the assignments of the rows before its slot)."""
    if not run.moe:
        return None
    m, t, dev = run.m, run.t, run.device
    E, k, cf = m["num_experts"], m["experts_per_token"], m.get("capacity_factor", 1.25)
    P, n = len(s.req.prompt), len(s.req.tokens)
    c_pre = capacity(TR.bucket_for(P, t), k, E, cf)
    c_dec = capacity(t["max_slots"], k, E, cf)
    pre = run.records["prefill"][s.plan.rid]
    steps = [run.records["decode"][s.req.start_step + i] for i in range(n - 1)]
    out = []
    for layer, (pidx, pkeep) in enumerate(pre):
        idx = [pidx[:P]]
        keep = [pkeep.reshape(-1, k)[:P]]
        prior = [torch.zeros((P, E), dtype=torch.long, device=dev)]
        for rec in steps:
            didx, dkeep = rec[layer]
            idx.append(didx[s.slot:s.slot + 1])
            keep.append(dkeep.reshape(-1, k)[s.slot:s.slot + 1])
            prior.append(torch.nn.functional.one_hot(didx[:s.slot].reshape(-1), E)
                         .sum(0, keepdim=True))
        out.append({
            "idx": torch.cat(idx).to(dev), "keep": torch.cat(keep).to(dev),
            "prior": torch.cat(prior).to(dev),
            "group": torch.cat([torch.zeros(P, dtype=torch.long),
                                torch.arange(1, n, dtype=torch.long)]).to(dev),
            "cap": torch.cat([torch.full((P,), c_pre), torch.full((n - 1,), c_dec)]).to(dev)})
    return out


def judge(run: Run, quant: Optional[str] = None) -> Dict[str, float]:
    """The numbers compared: the widest gap by which a served token's
    logit lies below the reference's best (with ``quant``, of the token the
    control puts first), and for MoE the routing choices off a near tie
    and the capacity rule's mismatches (``Ref.moe``), with the widest
    router-logit gap a choice crossed beside them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chosen = sample(run)
    if not chosen:
        return {"requests_checked": 0.0}
    ref = run.Ref(run.m, run.params)
    ctl = run.Ref(run.m, run.params, quant=quant) if quant else None
    out = {"logit_gap": 0.0}
    if run.moe:
        out.update(routed_off_tie=0.0, keep_mismatch=0.0, route_gap_max=0.0)
    short = 0
    with torch.inference_mode():
        for s in chosen:
            served = torch.as_tensor(s.req.tokens, dtype=torch.long, device=run.device)
            short += int(len(s.req.tokens) != s.plan.max_new)
            toks = torch.cat([torch.as_tensor(s.req.prompt, dtype=torch.long,
                                              device=run.device), served[:-1]])
            rt = routes(run, s)
            r = ref.forward(toks, len(s.req.prompt), rt)
            best = r["logits"].max(-1).values
            c = None if ctl is None else ctl.forward(toks, len(s.req.prompt), rt)
            pick = served if c is None else c["logits"].argmax(-1)
            gap = float((best - r["logits"].gather(1, pick[:, None])[:, 0]).max())
            out["logit_gap"] = max(out["logit_gap"], gap)
            if run.moe:
                judged = r if c is None else c
                out["routed_off_tie"] += judged["routed_off_tie"]
                out["route_gap_max"] = max(out["route_gap_max"], judged["route_gap_max"])
                out["keep_mismatch"] += r["keep_mismatch"]
            del r
    out["short_requests"] = float(short)
    out["tokens_checked"] = float(sum(len(s.req.tokens) for s in chosen))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {value, limit}}) over the numbers that have a limit;
    a run that checked nothing, or served a request short, is not correct."""
    checks = {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
    checks["short_requests"] = {"value": numbers.get("short_requests"), "limit": 0}
    ok = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


# ------------------------------------------------------------------ readers


def read_per_layer(run: Run, spec: dict) -> dict:
    """Each per-layer metric of the cell, from its reader
    ``metrics/<name>.py``; a reader that finds nothing returns None and
    the metric is left out."""
    out = {}
    for metric in spec["per_layer"]:
        if "workloads" in metric and run.cell["name"] not in metric["workloads"]:
            continue
        path = HERE / "metrics" / f"{metric['name']}.py"
        mod_spec = importlib.util.spec_from_file_location(
            "perfbench_metric_" + metric["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        value = mod.read(run)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def loaded_forbidden() -> List[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


# --------------------------------------------------------------------- run


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: Optional[float] = None, spec: Optional[dict] = None,
             inputs=None, drain_s: Optional[float] = None) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec or json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, config, t, limits = inputs or load_cell(workload, spec)
    run = Run(cell, config, t, seed, seconds, trace, device, drain_s=drain_s)
    with torch.inference_mode():
        t0 = time.perf_counter()
        run.build()
        t1 = time.perf_counter()
        run.warm()
        setup_s = time.perf_counter() - t_start
        run.note(f"set-up {setup_s:.3f} s: start {t0 - t_start:.3f}, build "
                 f"{t1 - t0:.3f}, warm-up {time.perf_counter() - t1:.3f}")
        run.serve()
    if run.moe:
        run._mlp.RECORD = None
    cuda = run.cuda
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    counted = run.counted()
    attempted, failed = len(counted), sum(s.failed for s in counted)
    if trace:
        metrics = read_per_layer(run, spec)
        steps = [t1 - t0 for t0, t1, _ in run.timed.decodes if 0.0 <= t0 < run.seconds]
        if steps:
            run.note(f"synchronised decode step: mean {1e3 * sum(steps) / len(steps):.3f} ms "
                     f"over {len(steps)} steps of the window")
    else:
        e2e = dict(run.end_to_end(), setup_s=setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]
                   if cell["name"] in m.get("workloads", [cell["name"]])}
    del run.batcher
    if cuda:
        torch.cuda.empty_cache()
    numbers = judge(run)
    run.note(f"numbers read {numbers}")
    correct, checks = verdict(numbers, limits)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace and run.slices:
        sl = run.slices[-1]
        device_info.update(busy_s=sl["busy_s"], window_s=sl["window_s"])
        result["breakdown"] = {"device_ops": sl["device_ops"], "idle_gaps": sl["idle_gaps"]}
    result["checks"] = checks
    result["_run"] = run
    return result

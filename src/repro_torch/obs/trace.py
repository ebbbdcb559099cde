"""Chrome trace-event tracer + validator — open exports in Perfetto.

:class:`Tracer` collects span/counter/flow events in the Chrome trace-event
JSON format (the ``traceEvents`` array Perfetto ingests,
https://ui.perfetto.dev). The serving fleet draws each replica as a lane
(pid 0 = fleet, tid = replica index): transient lifetimes are async spans
(``b``/``e``, cat ``"transient"``) from provision to drain/revoke, request
service is a complete span (``X``) on the replica lane, hedges are flow
arrows (``s``/``f``) from the stuck primary's lane to the reserve replica,
and fleet-wide queue depth / active transients are counter tracks (``C``).

The served path (``runtime/batching.py``'s ``ContinuousBatcher``, and
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

CLI — the CI smoke gate's trace schema check::

    python -m repro_torch.obs.trace --check out.trace.json \
        --require-counter queue_depth --require-cat transient
"""

from __future__ import annotations

import json
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

    # -- metadata ---------------------------------------------------------
    def process_name(self, pid: int, name: str) -> None:
        if not self.enabled:
            return
        self.events.append({"ph": "M", "name": "process_name", "pid": pid,
                            "tid": 0, "args": {"name": name}})

    def thread_name(self, pid: int, tid: int, name: str) -> None:
        if not self.enabled:
            return
        self.events.append({"ph": "M", "name": "thread_name", "pid": pid,
                            "tid": tid, "args": {"name": name}})

    # -- spans / instants -------------------------------------------------
    def complete(self, name: str, t: float, dur: float, *, pid: int = 0,
                 tid: int = 0, args: Optional[dict] = None,
                 cat: Optional[str] = None) -> None:
        if not self.enabled:
            return
        ev = {"ph": "X", "name": name, "pid": pid, "tid": tid,
              "ts": t * self._scale, "dur": max(dur, 0.0) * self._scale}
        if cat:
            ev["cat"] = cat  # e.g. the owning tenant of a request slice
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, t: float, *, pid: int = 0, tid: int = 0,
                args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        ev = {"ph": "i", "name": name, "pid": pid, "tid": tid,
              "ts": t * self._scale, "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def async_begin(self, name: str, t: float, *, aid: int, cat: str,
                    pid: int = 0, tid: int = 0,
                    args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        ev = {"ph": "b", "name": name, "cat": cat, "id": aid, "pid": pid,
              "tid": tid, "ts": t * self._scale}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def async_end(self, name: str, t: float, *, aid: int, cat: str,
                  pid: int = 0, tid: int = 0,
                  args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        ev = {"ph": "e", "name": name, "cat": cat, "id": aid, "pid": pid,
              "tid": tid, "ts": t * self._scale}
        if args:
            ev["args"] = args
        self.events.append(ev)

    # -- host-clock spans -------------------------------------------------
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

    # -- flows (hedge arrows) --------------------------------------------
    def flow_start(self, name: str, t: float, *, fid: int, pid: int = 0,
                   tid: int = 0) -> None:
        if not self.enabled:
            return
        self.events.append({"ph": "s", "name": name, "cat": "flow",
                            "id": fid, "pid": pid, "tid": tid,
                            "ts": t * self._scale})

    def flow_end(self, name: str, t: float, *, fid: int, pid: int = 0,
                 tid: int = 0) -> None:
        if not self.enabled:
            return
        self.events.append({"ph": "f", "name": name, "cat": "flow",
                            "id": fid, "bp": "e", "pid": pid, "tid": tid,
                            "ts": t * self._scale})

    # -- counters ---------------------------------------------------------
    def counter(self, name: str, t: float, value, *, pid: int = 0) -> None:
        if not self.enabled:
            return
        self.events.append({"ph": "C", "name": name, "pid": pid, "tid": 0,
                            "ts": t * self._scale,
                            "args": {"value": float(value)}})

    # -- export -----------------------------------------------------------
    def to_dict(self) -> dict:
        # metadata first, then stable ts order — guarantees the monotone-ts
        # invariant the schema check enforces per (pid, tid) track
        meta = [e for e in self.events if e["ph"] == "M"]
        rest = sorted((e for e in self.events if e["ph"] != "M"),
                      key=lambda e: e["ts"])
        return {"traceEvents": meta + rest, "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh)
        return path


def trace_from_run_result(res, path: str) -> str:
    """Post-hoc trace from a RunResult's series alone — the fallback for
    engines that don't tracer-instrument live (fluid, serving_jax): queue
    depth and online-transient counter tracks, plus per-tick event instants
    when an ``event_counts`` series is present."""
    from repro_torch.obs.events import EVENT_TYPES

    tick_s = float(res.meta.get("tick_s", 1.0)) if res.meta else 1.0
    tr = Tracer(tick_s=tick_s)
    tr.process_name(0, f"{res.engine}:{res.scenario}")
    counters = [("queue_depth", "queue_depth"),
                ("online_transients", "online_transients"),
                ("transients_online", "online_transients")]
    for key, name in counters:
        series = res.series.get(key)
        if series is None:
            continue
        for t, v in enumerate(series):
            tr.counter(name, float(t), float(v))
    ec = res.series.get("event_counts")
    if ec is not None:
        for t, row in enumerate(ec):
            for e, n in enumerate(row):
                if n:
                    tr.instant(EVENT_TYPES[e], float(t),
                               args={"count": int(n)})
    return tr.export(path)


_TS_PHASES = ("X", "b", "e", "s", "f", "C", "i", "B", "E")


def validate_trace_events(obj, *, require_counters: Sequence[str] = (),
                          require_async_cats: Sequence[str] = ()
                          ) -> List[str]:
    """Structural check for a Chrome trace-event export. Returns problem
    strings (empty = valid): traceEvents array present, required per-phase
    fields, non-negative durations, non-decreasing ts per (pid, tid) track,
    plus presence of required counter names / async-span categories."""
    problems: List[str] = []
    if not isinstance(obj, dict) or not isinstance(obj.get("traceEvents"),
                                                   list):
        return ["top level must be a dict with a 'traceEvents' list"]
    last_ts: Dict[Tuple[int, int], float] = {}
    seen_counters = set()
    seen_cats = set()
    for i, ev in enumerate(obj["traceEvents"]):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ph, str) or not ph:
            problems.append(f"event {i}: missing 'ph'")
            continue
        if not isinstance(ev.get("name"), str):
            problems.append(f"event {i} (ph={ph}): missing 'name'")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if ph in _TS_PHASES and not isinstance(ts, (int, float)):
            problems.append(f"event {i} (ph={ph}): missing numeric 'ts'")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: 'X' needs non-negative 'dur'")
        elif ph in ("b", "e"):
            if "id" not in ev or not isinstance(ev.get("cat"), str):
                problems.append(f"event {i}: '{ph}' needs 'id' and 'cat'")
            elif ph == "b":
                seen_cats.add(ev["cat"])
        elif ph in ("s", "f"):
            if "id" not in ev:
                problems.append(f"event {i}: '{ph}' needs 'id'")
        elif ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args or \
                    not all(isinstance(v, (int, float))
                            for v in args.values()):
                problems.append(f"event {i}: 'C' needs numeric args")
            else:
                seen_counters.add(ev["name"])
        key = (ev.get("pid", 0), ev.get("tid", 0))
        prev = last_ts.get(key)
        if prev is not None and ts < prev:
            problems.append(f"event {i} (ph={ph}): ts {ts} < {prev} — "
                            f"non-monotone on track pid={key[0]} "
                            f"tid={key[1]}")
        last_ts[key] = ts
    for name in require_counters:
        if name not in seen_counters:
            problems.append(f"required counter track '{name}' missing")
    for cat in require_async_cats:
        if cat not in seen_cats:
            problems.append(f"required async-span category '{cat}' missing")
    return problems


def validate_trace_file(path: str, *, require_counters: Sequence[str] = (),
                        require_async_cats: Sequence[str] = ()
                        ) -> List[str]:
    try:
        with open(path) as fh:
            obj = json.load(fh)
    except (OSError, json.JSONDecodeError) as exc:
        return [f"{path}: unreadable trace ({exc})"]
    return validate_trace_events(obj, require_counters=require_counters,
                                 require_async_cats=require_async_cats)


def _main(argv: Optional[Iterable[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.trace",
        description="Validate Chrome trace-event JSON files")
    ap.add_argument("--check", nargs="+", required=True, metavar="FILE",
                    help="trace files to validate")
    ap.add_argument("--require-counter", action="append", default=[],
                    metavar="NAME", help="counter track that must be present")
    ap.add_argument("--require-cat", action="append", default=[],
                    metavar="CAT", help="async-span category that must be "
                    "present")
    args = ap.parse_args(argv if argv is None else list(argv))
    rc = 0
    for path in args.check:
        problems = validate_trace_file(
            path, require_counters=args.require_counter,
            require_async_cats=args.require_cat)
        if problems:
            rc = 1
            print(f"FAIL {path}")
            for p in problems:
                print(f"  - {p}")
        else:
            print(f"OK   {path}")
    return rc


if __name__ == "__main__":
    raise SystemExit(_main())

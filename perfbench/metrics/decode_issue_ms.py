"""Model step: mean length of the window's ``model.decode_step`` spans, the
host's time to issue a decode step (the program's spans: with the decode
graph, its input copies and one replay; eager, every launch). The device
work is not waited for inside the span. Steps inside a profiled slice are
left out: the profiler's own callbacks lengthen their issue several times
over (a replay's 1.3 ms read 7.4 inside the slice, starcoder2-3b on the
H100)."""

from perfbench import spans


def read(run):
    start, close = spans.window(run)
    profiled = [(start + sl["t0"], start + sl["t1"]) for sl in run.slices]
    calls = [e for e in spans.events(run, "model.decode_step")
             if start <= spans.start(e) < close
             and not any(a <= spans.start(e) < b for a, b in profiled)]
    return sum(e["dur"] for e in calls) / 1e3 / len(calls) if calls else None

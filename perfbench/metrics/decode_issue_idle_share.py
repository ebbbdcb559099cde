"""Device: share of the traced slice in which the card sat idle while the
host was issuing a decode step: each ``model.decode_step`` span (the
program's, on the host clock) mapped onto the profiler's clock by the
slice's ``offset_us``, less the union of the device intervals inside it,
summed, over the slice."""

from perfbench import spans
from perfbench import yardstick as Y


def read(run):
    if not run.slices or run.slices[-1]["offset_us"] is None:
        return None
    sl = run.slices[-1]
    lo, hi, off = sl["lo"], sl["hi"], sl["offset_us"]
    issue = [(max(lo, e["ts"] + off), min(hi, e["ts"] + e["dur"] + off))
             for e in spans.events(run, "model.decode_step")]
    issue = [(a, b) for a, b in issue if b > a]
    if not issue:
        return None
    busy = Y.merged(sl["device_intervals"])
    idle = sum((b - a) - Y.covered(busy, a, b) for a, b in issue)
    return 100.0 * idle / (hi - lo)

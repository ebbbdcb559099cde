"""Batcher: mean time a request due in the window waited in the batcher's
queue, from its ``batcher.submit`` instant to the start of its
``batcher.admit`` span (the program's spans); one still queued at the close
counts what it had waited by then. It leaves out the generator's lateness,
which ``queue_wait_ms`` counts; a request submitted only after the close
waited nothing in the window and is left out."""

from perfbench import spans


def read(run):
    submitted = {e["args"]["rid"]: spans.start(e) for e in spans.events(run, "batcher.submit")}
    admitted = {}
    for e in spans.events(run, "batcher.admit"):
        admitted.setdefault(e["args"]["rid"], spans.start(e))
    if not submitted:
        return None
    _, close = spans.window(run)
    waits = []
    for s in run.counted():
        t0 = submitted.get(s.plan.rid)
        if s.failed or t0 is None or t0 >= close:
            continue
        waits.append(min(admitted.get(s.plan.rid, close), close) - t0)
    return 1e3 * sum(waits) / len(waits) if waits else None

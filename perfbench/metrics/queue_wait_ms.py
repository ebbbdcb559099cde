"""Batcher: mean time a request waited from when it was due to the start
of the ``step()`` call that admitted it (host clock); a request still
queued when the window closed counts the time it had waited."""


def read(run):
    start = {run.step0 + i: s[0] for i, s in enumerate(run.steps)}
    waits = []
    for s in run.counted():
        if s.failed:
            continue
        st = start.get(s.req.start_step)
        waits.append((run.seconds if st is None else min(st, run.seconds)) - s.due)
    return 1e3 * sum(waits) / len(waits) if waits else None

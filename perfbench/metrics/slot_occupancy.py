"""Batcher: mean share of the slots that held a request, over the window's
``step()`` calls."""


def read(run):
    n = [a for s0, _, a in run.steps if 0.0 <= s0 < run.seconds]
    return 100.0 * sum(n) / (len(n) * run.t["max_slots"]) if n else None

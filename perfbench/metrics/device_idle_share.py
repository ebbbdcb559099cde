"""Device: share of the traced slice in which no kernel, copy or set ran
on the card (1 - union of the profiler's device intervals / slice)."""


def read(run):
    if not run.slices:
        return None
    sl = run.slices[-1]
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])

"""Model step: the window's prefills' model FLOPs (true prompt tokens,
top-k experts, causal and windowed pairs; ``yardstick.prefill_flops``)
over their synchronised wall time at the bf16 peak."""

from perfbench import yardstick as Y


def read(run):
    if not run.cuda:
        return None
    calls = [c for c in run.timed.prefills if 0.0 <= c[0] < run.seconds]
    wall = sum(t1 - t0 for t0, t1, _ in calls)
    if not calls or wall <= 0:
        return None
    flops = sum(Y.prefill_flops(run.m, P) for _, _, P in calls)
    return 100.0 * flops / (wall * Y.PEAK_BF16_FLOPS)

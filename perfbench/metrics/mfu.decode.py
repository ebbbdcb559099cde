"""Model step: the window's decode steps' model FLOPs (active slots, keys
each can see; ``yardstick.decode_flops``) over their synchronised wall
time at the bf16 peak."""

from perfbench import yardstick as Y


def read(run):
    if not run.cuda:
        return None
    calls = [c for c in run.timed.decodes if 0.0 <= c[0] < run.seconds]
    wall = sum(t1 - t0 for t0, t1, _ in calls)
    if not calls or wall <= 0:
        return None
    flops = sum(Y.decode_flops(run.m, pos) for _, _, pos in calls)
    return 100.0 * flops / (wall * Y.PEAK_BF16_FLOPS)

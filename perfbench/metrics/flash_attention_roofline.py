"""Kernels: B2 (prefill attention) in the traced slice, its bound at each
prefill's true prompt length (``yardstick.flash_attention_bound_s``, one
launch a layer) over its kernels' profiler device time. Where the profiler
dropped records in every try, the bound is taken over the share recorded."""

from perfbench import yardstick as Y


def read(run):
    if not run.slices:
        return None
    sl, m = run.slices[-1], run.m
    calls = [c for c in run.timed.prefills if sl["t0"] <= c[0] and c[1] <= sl["t1"]]
    if not calls or not sl["flash_recorded"] or sl["flash_s"] <= 0:
        return None
    w = m["window_size"] if tuple(m["attn_pattern"]) == ("local",) else 0
    bound = m["num_layers"] * sum(
        Y.flash_attention_bound_s(P, m["num_heads"], m["num_kv_heads"], m["head_dim"], w)
        for _, _, P in calls)
    bound *= sl["flash_recorded"] / sl["flash_issued"]
    return 100.0 * bound / sl["flash_s"]

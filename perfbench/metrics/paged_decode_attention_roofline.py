"""Kernels: B1 (paged decode attention) in the traced slice, its bound over
the keys each active slot sees (``yardstick.paged_decode_bound_s``, one
launch a layer) over its kernels' profiler device time (split pass and
combine). Where the profiler dropped records in every try, the bound is
taken over the share recorded."""

from perfbench import yardstick as Y


def read(run):
    if not run.slices:
        return None
    sl, m, t = run.slices[-1], run.m, run.t
    calls = [c for c in run.timed.decodes if sl["t0"] <= c[0] and c[1] <= sl["t1"]]
    if not calls or not sl["decode_recorded"] or sl["decode_s"] <= 0:
        return None
    w = m["window_size"] if tuple(m["attn_pattern"]) == ("local",) else 0
    L = Y.cache_len(m, t["max_len"])
    bound = m["num_layers"] * sum(
        Y.paged_decode_bound_s([Y.decode_visible(p, w) for p in pos], m["num_heads"],
                               m["num_kv_heads"], m["head_dim"], L, t["kv_block_size"])
        for _, _, pos in calls)
    bound *= sl["decode_recorded"] / sl["decode_issued"]
    return 100.0 * bound / sl["decode_s"]

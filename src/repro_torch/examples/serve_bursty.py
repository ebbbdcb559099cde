"""Bursty serving with an elastic transient fleet, scenario-driven through
the experiment API (twin of ``examples/serve_bursty.py``).

Real autoregressive decoding (a ``ContinuousBatcher`` over a decoder model:
bucketed prefill, KV cache, one slot-batched decode step per call) behind
the CloudCoaster controller: the ``serve_yahoo`` scenario's trace becomes
the request stream, its long class pins replicas, and the controller rents
transient replicas during request storms. ``exp.run(..., engine="serving")``
drives everything; the same call with ``max_transient=0`` plus an
equal-cost on-demand reserve is the static baseline. The fleet runs on the
host; the model runs on ``--device`` (default ``cuda``, which raises
without a card).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_bursty [--no-model]
      [--kv dense|paged]   # KV-cache layout for the real decode path
      [--trace-out FILE]   # Perfetto timeline of the elastic run
      [--arch ID] [--smoke|--no-smoke] [--device cuda|cpu]
      [--horizon-s S]      # cut the scenario's trace to S seconds

The default model is the gemma2-2b smoke config, as in the JAX package's
example; ``--arch starcoder2-3b --no-smoke`` decodes the published widths.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import exp
from repro_torch.sched import get_scenario

#: static baseline budget: extra on-demand reserve replicas (compared
#: against the elastic fleet's avg_active_transients / r paid budget)
STATIC_BUDGET = 2


def build_decoder(kv_layout: str = "dense", *, arch: str = "gemma2-2b",
                  smoke: bool = True, device=None, seed: int = 0,
                  max_len: int = 64,
                  prompt_lens: Optional[Sequence[int]] = None,
                  max_new: Optional[int] = None):
    """A continuously-batched decoder (prefill buckets + slot-batched decode
    through ``runtime.batching``) standing in for the replica's model server.
    Each controller decode tick advances every active slot one token; a
    synthetic request stream keeps the batcher (4 slots of ``max_len``
    tokens, 16-token pages when paged) busy: whenever it is idle, 4 requests
    arrive with prompt lengths drawn from 4-16 and 4-12 new tokens (the JAX
    example's stream), or with prompt lengths drawn from ``prompt_lens`` and
    ``max_new`` new tokens each when those are given. ``kv_layout="paged"``
    runs the same workload against the paged KV pool (block allocator +
    page-table gather); generation is token-identical to dense.

    Returns ``(decode_fn, stats)``: ``stats["n"]`` counts generated tokens,
    ``stats["calls"]`` the hook's calls; ``stats["batcher"]`` and
    ``stats["requests"]`` are the batcher and every request it was given.
    """
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.runtime.batching import ContinuousBatcher, GenRequest

    dev = resolve_device(device)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    batcher = ContinuousBatcher(model, params, max_slots=4, max_len=max_len,
                                kv_layout=kv_layout, device=dev)
    rng = np.random.default_rng(0)
    stats = {"n": 0, "calls": 0, "batcher": batcher, "requests": []}

    def decode_fn(replica_id):
        stats["calls"] += 1
        if not (batcher.queue or batcher.slots.n_active):
            for _ in range(4):
                plen = (int(rng.choice(prompt_lens)) if prompt_lens
                        else int(rng.integers(4, 17)))
                req = GenRequest(
                    len(stats["requests"]),
                    rng.integers(1, cfg.vocab_size, plen).astype(np.int32),
                    max_new=max_new or int(rng.integers(4, 13)))
                batcher.submit(req)
                stats["requests"].append(req)
        with torch.inference_mode():
            stats["n"] += batcher.step()  # one token per active slot

    return decode_fn, stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-model", action="store_true",
                    help="run the fleet without a model behind decode_fn")
    ap.add_argument("--kv", default="dense", choices=["dense", "paged"],
                    help="KV-cache layout of the real decode path")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="Perfetto timeline of the elastic run")
    ap.add_argument("--arch", default="gemma2-2b", help="model config id")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True, help="reduced widths (default); "
                                       "--no-smoke for the published ones")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (cuda or cpu)")
    ap.add_argument("--horizon-s", type=float, default=None,
                    help="cut the scenario's trace to this many seconds")
    args = ap.parse_args(argv)

    decode_fn, counter = (None, {"n": 0})
    if not args.no_model:
        decode_fn, counter = build_decoder(
            args.kv, arch=args.arch, smoke=args.smoke, device=args.device)

    # the scenario's quick scale (400 servers / 4 h trace -> ~870
    # requests): real decode is ~47k one-token steps
    trace_over = {} if args.horizon_s is None else {"horizon": args.horizon_s}
    common = dict(engine="serving", quick=True, seed=0, sim_seed=0,
                  trace_overrides=trace_over)
    # static baseline: no transients, an on-demand reserve instead
    static = exp.run("serve_yahoo", sim_overrides={
        "max_transient": 0, "n_reserve": STATIC_BUDGET}, **common)
    tracer = None
    if args.trace_out:
        from repro_torch.obs import Tracer

        cfg = get_scenario("serve_yahoo").serving_config(quick=True,
                                                         sim_overrides={})
        tracer = Tracer(tick_s=cfg.tick_s)
    elastic = exp.run("serve_yahoo", decode_fn=decode_fn, tracer=tracer,
                      record_events=True, **common)
    if tracer is not None:
        print(f"trace written to {tracer.export(args.trace_out)} "
              f"(open in ui.perfetto.dev)")

    print(f"{'':24s}{'static':>12s}{'elastic':>12s}")
    for k in ("short_avg_wait_s", "short_p99_wait_s", "short_max_wait_s",
              "n_done", "avg_active_transients", "n_transients_used",
              "n_revocations", "n_hedges", "n_hedge_cancelled"):
        print(f"{k:24s}{static.metrics[k]:>12.1f}{elastic.metrics[k]:>12.1f}")
    r = get_scenario("serve_yahoo").sim_config(quick=True).cost_ratio
    cost_el = elastic.metrics["avg_active_transients"] / r
    print(f"\npaid budget (on-demand equivalents): "
          f"static={float(STATIC_BUDGET):.1f} elastic={cost_el:.1f}")
    if decode_fn is not None:
        print(f"real decode tokens generated on-model ({args.kv} KV, "
              f"{counter['batcher'].device}): {counter['n']} in "
              f"{counter['calls']} decode steps")
    print(f"avg wait improvement: "
          f"{static.metrics['short_avg_wait_s'] / max(elastic.metrics['short_avg_wait_s'], 1e-9):.1f}x")
    return {"static": static, "elastic": elastic, "decoder": counter}


if __name__ == "__main__":
    main()

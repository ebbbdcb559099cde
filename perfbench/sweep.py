"""Find the knee of an open-loop cell: the highest steady Poisson rate the
replica sustains without a growing backlog.

    python3 perfbench/sweep.py --workload <cell> --rates 2,3,4,5 --seconds 30 --seed <n>

Each rate runs the cell's own traffic (lengths, slots, lead-in) with its
burst cycle replaced by steady Poisson arrivals drawn from ``--seed``
(``"loop": "poisson"`` in ``traffic.py``), in one process on the card. For
each rate it prints one JSON line: the offered and completed requests a
second, the requests waiting or running at the window's middle and end,
the p50 and p95 of time to first token, and tokens a second. A rate is
sustained when the backlog at the end is no larger than at the middle
plus the slots, and nine in ten of the requests due finished. The cell
then offers 0.8 of the highest sustained rate, written into its traffic
file as a number.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests a second")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    from perfbench import harness
    from perfbench import yardstick as Y

    cell, config, t, _ = harness.load_cell(args.workload)
    if t["loop"] != "open":
        print("the sweep is for open-loop cells", file=sys.stderr)
        return 2
    for rate in (float(r) for r in args.rates.split(",")):
        steady = dict(t, rate_rps=rate, loop="poisson")
        run = harness.Run(cell, config, steady, args.seed, args.seconds, False, "cuda")
        with torch.inference_mode():
            run.build()
            run.warm()
            run.serve()
        T = args.seconds

        def backlog(at):
            return sum(1 for s in run.served if s.due <= at and not s.failed
                       and (len(s.times) < s.plan.max_new or s.times[-1] > at))

        counted = run.counted()
        done = [s for s in counted if len(s.times) == s.plan.max_new and s.times[-1] <= T]
        ttft = [min(s.times[0] if s.times else T, T) - s.due for s in counted]
        mid, end = backlog(T / 2), backlog(T)
        line = {"rate_rps": rate, "offered_rps": len(counted) / T,
                "completed_rps": len(done) / T, "backlog_mid": mid, "backlog_end": end,
                "ttft_p50_ms": 1e3 * Y.percentile(ttft, 50),
                "ttft_p95_ms": 1e3 * Y.percentile(ttft, 95),
                "tokens_per_s": run.end_to_end()["tokens_per_s"],
                "sustained": end <= mid + t["max_slots"] and len(done) >= 0.9 * len(counted)}
        print(json.dumps(line), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

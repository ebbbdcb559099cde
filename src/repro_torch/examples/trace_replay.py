"""Replay the paper's §4 evaluation at any scale (the port's twin of the JAX
package's ``examples/trace_replay.py``, printing the same table).

Runs the Eagle + CloudCoaster r in {1,2,3} presets through the unified
experiment API (``repro_torch.exp.run``, the DES on the host) on a shared
Yahoo-calibrated trace and prints the Fig. 3 / Table 1 numbers next to the
paper's.

Run:  PYTHONPATH=src python -m repro_torch.examples.trace_replay [--full] [--seed 42]
      (--full = the paper's 4000-server, 24 h configuration; ~2 min)
"""

import argparse

from repro_torch.exp import run as exp_run
from repro_torch.sched import get_scenario


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--burst-mult", type=float, default=5.0)
    ap.add_argument("--scenarios", default="eagle,coaster_r1,coaster_r2,coaster_r3",
                    help="comma-separated registry names to replay")
    args = ap.parse_args(argv)

    quick = not args.full
    names = args.scenarios.split(",")
    tr = get_scenario(names[0]).trace(
        quick=quick, seed=args.seed,
        trace_overrides=dict(burst_mult=args.burst_mult))
    print(f"trace: {tr.n_jobs} jobs / {tr.n_tasks} tasks / "
          f"util {tr.meta['utilization']:.2f}")

    rows = [(name, exp_run(name, engine="des", quick=quick, trace=tr))
            for name in names]

    print(f"\n{'config':16s}{'avg wait':>10s}{'max wait':>10s}"
          f"{'act transients':>15s}{'life h':>8s}{'save':>8s}")
    for name, res in rows:
        s = res.metrics
        print(f"{name:16s}{s['short_avg_wait_s']:>10.1f}"
              f"{s['short_max_wait_s']:>10.0f}"
              f"{s['avg_active_transients']:>15.1f}"
              f"{s['transient_avg_lifetime_h']:>8.2f}"
              f"{s.get('dynamic_partition_cost_saving', 0):>8.1%}")
    base = rows[0][1].metrics
    last = rows[-1][1].metrics
    print(f"\navg improvement {rows[-1][0]} vs {rows[0][0]}: "
          f"{base['short_avg_wait_s'] / last['short_avg_wait_s']:.1f}x "
          f"(paper r=3: 4.8x) | max: "
          f"{base['short_max_wait_s'] / last['short_max_wait_s']:.1f}x "
          f"(paper: 1.83x)")


if __name__ == "__main__":
    main()

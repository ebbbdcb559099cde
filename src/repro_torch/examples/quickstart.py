"""Quickstart: the paper in 60 seconds (the port's twin of the JAX
package's ``examples/quickstart.py``, printing the same lines).

1. Synthesize a bursty Yahoo-calibrated trace.
2. Run the Eagle baseline and CloudCoaster (r=3) through the DES.
3. Print the paper's headline metrics side by side.

The DES runs on the host; no card is needed.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
"""

from repro_torch.core import SimConfig, simulate
from repro_torch.traces import yahoo_like

# scaled-down cluster (400 servers) so this finishes in seconds
SCALE = dict(n_servers=400, n_short=8, horizon=4 * 3600)
SIM = dict(n_servers=400, n_short_reserved=8)


def main(argv=None):
    print("generating Yahoo-calibrated bursty trace ...")
    tr = yahoo_like(seed=1, **SCALE)
    print(f"  {tr.n_jobs} jobs, {tr.n_tasks} tasks, "
          f"utilization {tr.meta['utilization']:.2f}\n")

    base = simulate(tr, SimConfig(**SIM, replace_fraction=0.0)).summary()
    print("Eagle baseline (static 8-server short partition):")
    print(f"  short-task queueing delay avg={base['short_avg_wait_s']:.1f}s "
          f"max={base['short_max_wait_s']:.0f}s")

    cc = simulate(tr, SimConfig(**SIM, replace_fraction=0.5,
                                cost_ratio=3.0)).summary()
    print("\nCloudCoaster (p=0.5, r=3, L_r^T=0.95, 120s provisioning):")
    print(f"  short-task queueing delay avg={cc['short_avg_wait_s']:.1f}s "
          f"max={cc['short_max_wait_s']:.0f}s")
    print(f"  -> {base['short_avg_wait_s'] / cc['short_avg_wait_s']:.1f}x "
          f"average improvement (paper: 4.8x at full scale)")
    print(f"  transients: avg active={cc['avg_active_transients']:.1f}, "
          f"avg lifetime={cc['transient_avg_lifetime_h']:.2f}h "
          f"(paper: ~0.8h, far below spot MTTF)")
    print(f"  dynamic-partition cost saving="
          f"{cc['dynamic_partition_cost_saving']:.1%} (paper: 29.5%)")
    print(f"  long-job delay unchanged: {base['long_avg_wait_s']:.0f}s -> "
          f"{cc['long_avg_wait_s']:.0f}s")


if __name__ == "__main__":
    main()

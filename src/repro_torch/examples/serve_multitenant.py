"""Three tenants, one elastic fleet — the multi-tenant SLO layer end to end
(the port's twin of the JAX package's ``examples/serve_multitenant.py``).

The ``serve_tenant_trio`` preset superposes a steady Poisson tenant, a
flash-crowd tenant, and a heavy-tailed MMPP tenant onto the elastic
serving fleet, with TenantGuard's per-tenant token buckets gating request
routing: a tenant arriving inside its paid credit rate routes like plain
Eagle, an over-credit spike is throttled to the owner's home slice of the
general partition. The same preset runs on both serving engines — the
host fleet's tick loop and the fleet as one device program
(``serving_torch``: one CUDA kernel launch on the card, the plain PyTorch
version on the CPU) — and the per-tenant SLO table below comes out of the
shared ``RunResult`` schema (``tenant/<name>/*`` metrics), so the two
columns should agree to within seed noise. The ``serving_torch`` column is
the reference's ``serving_jax`` column, bit for bit.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_multitenant
      [--device cpu]       # serving_torch's device (default cuda)
      [--trace-out FILE]   # Perfetto timeline; slices are categorized by
                           # tenant (cat=steady/bursty/heavytail), so the
                           # UI can filter one tenant's requests
"""

from __future__ import annotations

import argparse

from repro_torch import exp
from repro_torch.sched import get_scenario
from repro_torch.tenancy import get_tenant_set

SCENARIO = "serve_tenant_trio"
TENANT_SET = "trio"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the serving_torch engine (cuda or cpu)")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write the host fleet's Perfetto timeline")
    args = ap.parse_args(argv)

    ts = get_tenant_set(TENANT_SET)
    common = dict(quick=True, seed=42, sim_seed=0)

    tracer = None
    if args.trace_out:
        from repro_torch.obs import Tracer

        cfg = get_scenario(SCENARIO).serving_config(quick=True,
                                                    sim_overrides={})
        tracer = Tracer(tick_s=cfg.tick_s)
    oracle = exp.run(SCENARIO, engine="serving", tracer=tracer,
                     record_events=True, **common)
    if tracer is not None:
        print(f"trace written to {tracer.export(args.trace_out)} "
              f"(open in ui.perfetto.dev; filter slices by cat=tenant)\n")
    device_run = exp.run(SCENARIO, engine="serving_torch", device=args.device,
                         **common)

    slo = dict(zip(ts.names, ts.slo_targets_s()))

    def row(label, key, fmt=".1f"):
        print(f"  {label:>18s}{oracle.metrics[key]:>12{fmt}}"
              f"{device_run.metrics[key]:>15{fmt}}")

    print(f"{'':20s}{'serving':>12s}{'serving_torch':>15s}")
    for name in ts.names:
        print(f"{name} (SLO: p99 wait <= {slo[name]:.0f}s)")
        row("p99_wait_s", f"tenant/{name}/p99_wait_s")
        row("avg_wait_s", f"tenant/{name}/avg_wait_s")
        row("slo_attainment", f"tenant/{name}/slo_attainment", ".3f")
    print("fleet")
    row("jain_fairness", "tenant_jain_fairness", ".3f")
    row("n_throttled", "n_throttled", ".0f")
    row("n_done", "n_done", ".0f")

    thr = oracle.metrics["n_throttled"]
    print(f"\nTenantGuard throttled {thr:.0f} over-credit placements to "
          f"their tenants' home slices.")
    return oracle, device_run


if __name__ == "__main__":
    main()

"""Scheduler-simulation launcher — a thin CLI over ``repro_torch.exp.run``.

Runs a named scenario from the ``repro_torch.sched`` registry on either engine;
the override flags are generated from the declarative
``repro_torch.exp.OVERRIDE_SPEC`` table (one row per knob, no if-chain):

  PYTHONPATH=src python -m repro_torch.launch.sim --scenario coaster_r3 \
      --threshold 0.95 --horizon-h 24
  PYTHONPATH=src python -m repro_torch.launch.sim --list
  PYTHONPATH=src python -m repro_torch.launch.sim --scenario spot_r3 --fluid \
      --out artifacts/spot_r3.runresult.npz
  PYTHONPATH=src python -m repro_torch.launch.sim --scenario coaster_r3 --quick \
      --engine fluid --device cpu
  PYTHONPATH=src python -m repro_torch.launch.sim --scenario serve_yahoo --quick \
      --engine serving --trace-out serve_yahoo.trace.json
  PYTHONPATH=src python -m repro_torch.launch.sim --scenario serve_batched_yahoo \
      --engine serving_torch --device cpu

The DES and the serving fleet run on the host and need no card. The fluid
engine and ``serving_torch`` (the serving fleet as one device program) run
on ``--device`` (default ``cuda``, which raises without a card).

``--out`` persists the full :class:`~repro_torch.exp.RunResult` — time series
included (per-task waits for the DES, the per-slot fluid trajectories that
were previously discarded) — as npz, or JSON with a ``.json`` suffix.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    from repro_torch.exp import OVERRIDE_SPEC, resolve_overrides
    from repro_torch.exp import run as exp_run
    from repro_torch.sched import get_scenario, scenario_names

    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="coaster_r3",
                    help="preset from the repro_torch.sched scenario registry")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    for name, spec in OVERRIDE_SPEC.items():
        ap.add_argument("--" + name.replace("_", "-"), dest=name,
                        type=spec.type, default=None, help=spec.help)
    ap.add_argument("--trace-cache", default=None, metavar="DIR",
                    help="cache the synthesized trace as npz under DIR "
                         "(repro_torch.workload.io; keyed on builder + params)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized scale (400 servers / 4 h)")
    ap.add_argument("--engine", default=None,
                    choices=["des", "fluid", "serving", "serving_torch"],
                    help="engine adapter (default des; 'serving' runs the "
                         "pod-level elastic serving fleet, 'serving_torch' "
                         "the same fleet as one device program)")
    ap.add_argument("--fluid", action="store_true",
                    help="alias for --engine fluid")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the fluid and serving_torch engines "
                         "(cuda or cpu)")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="persist the full RunResult (series included) "
                         "as npz, or JSON with a .json suffix")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write a Chrome trace-event JSON timeline "
                         "(open in ui.perfetto.dev); the serving engine "
                         "records live spans, other engines reconstruct "
                         "counter tracks from the RunResult series")
    args = ap.parse_args(argv)

    if args.list:
        for name in scenario_names():
            print(f"{name:24s} {get_scenario(name).description}")
        return

    sc = get_scenario(args.scenario)
    trace_over, sim_over = resolve_overrides(
        **{name: getattr(args, name) for name in OVERRIDE_SPEC})

    if args.trace_cache:
        import repro_torch.traces as traces
        from repro_torch.workload.io import cached_trace

        kw = sc.trace_params(quick=args.quick, seed=args.seed,
                             trace_overrides=trace_over)
        tr = cached_trace(getattr(traces, sc.trace_fn), args.trace_cache,
                          **kw)
    else:
        tr = sc.trace(quick=args.quick, seed=args.seed,
                      trace_overrides=trace_over)
    print(f"scenario: {sc.name} | trace: jobs={tr.n_jobs} tasks={tr.n_tasks} "
          f"util={tr.meta['utilization']:.3f}")
    engine = args.engine or ("fluid" if args.fluid else "des")
    engine_kwargs = (dict(device=args.device)
                     if engine in ("fluid", "serving_torch") else {})
    tracer = None
    if args.trace_out and engine == "serving":
        from repro_torch.obs import Tracer

        cfg = sc.serving_config(quick=args.quick, sim_overrides=sim_over)
        tracer = Tracer(tick_s=cfg.tick_s)
        engine_kwargs = dict(tracer=tracer, record_events=True)
    res = exp_run(sc, engine=engine,
                  quick=args.quick, seed=args.seed, sim_seed=args.seed,
                  trace=tr, trace_overrides=trace_over,
                  sim_overrides=sim_over, **engine_kwargs)
    print(json.dumps(res.metrics, indent=1, default=float))
    if args.trace_out:
        if tracer is not None:
            path = tracer.export(args.trace_out)
        else:
            from repro_torch.obs import trace_from_run_result

            path = trace_from_run_result(res, args.trace_out)
        print(f"trace written to {path}", file=sys.stderr)
    if args.out:
        path = res.save(args.out)
        print(f"RunResult saved to {path}", file=sys.stderr)


if __name__ == "__main__":
    main()

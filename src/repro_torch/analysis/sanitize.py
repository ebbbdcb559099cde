"""Runtime sanitizer: ``python -m repro_torch.analysis.sanitize --quick``.

Two dynamic invariants the AST linter cannot see:

1. **Run hygiene** — one quick scenario per engine (``des``, ``fluid``,
   ``serving``, ``serving_torch``), each run re-validated against the
   RunResult schema. JAX's ``check_tracer_leaks`` has no torch twin: an
   eager program has no traced scope a value could leak from, so the
   reference's tracer-leak check has nothing to check here.
2. **No retrace after warmup** — an identical back-to-back ``serving_torch``
   sweep must be a pure program-cache hit: the ``obs/metrics``
   ``serving_torch.jit_cache_miss`` counter (``_record_exec``) must not
   move on the second sweep and ``last_run_obs()["phase"]`` must report
   ``steady``. A miss here means something nondeterministic (or a swept
   value) leaked into ``FleetSpec`` and the whole cube-vs-pointwise
   speedup silently died.

The engines that run on a device (``fluid``, ``serving_torch``) run on
``--device``: ``cuda`` by default, which raises without a card as every
entry point does; ``--device cpu`` runs their plain versions.

Exit code 0 only when every engine run, schema validation, and the
retrace assert pass — CI wires this into the scenario-smoke job.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional, Sequence

DEFAULT_ENGINES = ("des", "fluid", "serving", "serving_torch")
#: the engines that take a ``device``
DEVICE_ENGINES = ("fluid", "serving_torch")
DEFAULT_SCENARIO = "serve_flash_crowd"
#: the two-point sweep used for the warm-cache assert (values well inside
#: every serve_* preset's plausible band; the cube size is irrelevant —
#: only spec identity matters for the program cache)
RETRACE_GRID = {"threshold": [2.0, 3.0]}


def run_engines(scenario: str, engines: Sequence[str], *, quick: bool,
                seed: int, device: str = "cuda") -> List[str]:
    """One scenario per engine; returns
    human-readable failure strings (empty = all clean)."""
    from repro_torch.exp import run
    from repro_torch.exp.results import validate_run_result

    failures: List[str] = []
    for engine in engines:
        t0 = time.perf_counter()
        try:
            kw = {"device": device} if engine in DEVICE_ENGINES else {}
            rr = run(scenario, engine=engine, quick=quick, seed=seed, **kw)
            problems = validate_run_result(rr)
            if problems:
                failures.append(f"{engine}: RunResult schema violations: "
                                f"{problems}")
                continue
            print(f"ok   {engine}: {scenario} ran clean on "
                  f"{device if engine in DEVICE_ENGINES else 'the host'} "
                  f"({time.perf_counter() - t0:.1f}s)")
        except Exception as exc:
            failures.append(f"{engine}: {type(exc).__name__}: {exc}")
            print(f"FAIL {engine}: {type(exc).__name__}: {exc}")
    return failures


def check_no_retrace(scenario: str, *, quick: bool, seed: int,
                     device: str = "cuda") -> List[str]:
    """Identical back-to-back serving_torch sweeps: the second must be a
    pure jit-cache hit (no compile, ``phase == steady``)."""
    from repro_torch.exp import sweep
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.runtime import serving_torch

    def counters():
        snap = REGISTRY.snapshot()["counters"]
        return (snap.get("serving_torch.jit_cache_miss", 0),
                snap.get("serving_torch.jit_cache_hit", 0))

    t0 = time.perf_counter()
    sweep(scenario, RETRACE_GRID, engine="serving_torch", quick=quick,
          seed=seed, device=device)
    miss_warm, hit_warm = counters()
    sweep(scenario, RETRACE_GRID, engine="serving_torch", quick=quick,
          seed=seed, device=device)
    miss_again, hit_again = counters()
    failures: List[str] = []
    if miss_again != miss_warm:
        failures.append(
            f"sweep_cube retraced after warmup: jit_cache_miss "
            f"{miss_warm} -> {miss_again} on an identical sweep — a "
            f"swept or nondeterministic value reached FleetSpec")
    if hit_again <= hit_warm:
        failures.append(
            f"second sweep recorded no jit_cache_hit "
            f"({hit_warm} -> {hit_again}) — the obs/metrics counters "
            f"are no longer wired through get_program")
    phase = serving_torch.last_run_obs().get("phase")
    if phase != "steady":
        failures.append(f"last_run_obs()['phase'] is {phase!r} after a "
                        f"warm identical sweep (expected 'steady')")
    if not failures:
        print(f"ok   serving_torch: warm identical sweep was a pure cache "
              f"hit (miss {miss_warm} -> {miss_again}, hit {hit_warm} -> "
              f"{hit_again}, {time.perf_counter() - t0:.1f}s)")
    return failures


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.sanitize",
        description="runtime sanitizer: every engine's RunResult "
                    "+ serving_torch no-retrace assert")
    ap.add_argument("--quick", action="store_true",
                    help="quick-scale scenario runs (what CI uses)")
    ap.add_argument("--scenario", default=DEFAULT_SCENARIO,
                    help=f"scenario to drive (default {DEFAULT_SCENARIO}; "
                         f"must be a serve_* preset for the serving "
                         f"engines)")
    ap.add_argument("--engines", default=",".join(DEFAULT_ENGINES),
                    help="comma-separated engine tags")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda",
                    help="device of the fluid and serving_torch engines "
                         "(cuda by default; cpu runs their plain versions)")
    ap.add_argument("--skip-retrace", action="store_true",
                    help="skip the warm-cache no-retrace assert")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device

    device = str(resolve_device(args.device))
    engines = [e.strip() for e in args.engines.split(",") if e.strip()]
    failures = run_engines(args.scenario, engines, quick=args.quick,
                           seed=args.seed, device=device)
    if not args.skip_retrace and "serving_torch" in engines:
        failures += check_no_retrace(args.scenario, quick=args.quick,
                                     seed=args.seed, device=device)
    for f in failures:
        print(f"FAIL {f}")
    print(f"{len(failures)} failure(s) "
          f"({len(engines)} engine(s), scenario {args.scenario!r})")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

"""Parallel scenario-smoke driver — the CI catalog gate.

Fans the (scenario x engine) catalog out over processes through
``repro_torch.exp.run``: every registered scenario on the DES and fluid
engines, the ``serve_*`` presets additionally on the serving and
serving_torch engines. The DES and the serving fleet run in the process
pool; the device engines (fluid and serving_torch, on ``--device``,
``cuda`` by default) run serially in the driver process, sharing its one
device context and the serving_torch program cache. Each run
persists one ``<scenario>-<engine>.runresult.npz``; the driver then
*re-loads* every persisted RunResult in the output directory and validates
the schema (``repro_torch.exp.validate_run_result``: canonical metric names
present and finite, the engine's required series non-empty, seed/engine
provenance set) and prints a pass/fail summary table — failures first,
then a slowest-5 wall-time digest. A machine-readable
``smoke_summary.json`` (per-job wall times, crash and schema-violation
counts) lands next to the RunResults for CI artifact upload. The exit
code is nonzero on any schema violation — not just on crashes — so CI
gates on the RunResult contract itself.

  PYTHONPATH=src python -m repro_torch.launch.smoke --quick
  PYTHONPATH=src python -m repro_torch.launch.smoke --quick --device cpu \
      --scenario serve_yahoo
  PYTHONPATH=src python -m repro_torch.launch.smoke --quick --processes 4 \
      --out-dir artifacts/runresults
  PYTHONPATH=src python -m repro_torch.launch.smoke --validate-only \
      --out-dir artifacts/runresults
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

#: scenarios with this prefix also run on the serving engines (mirrors the
#: retired ci.yml serving-presets bash loop)
SERVING_PREFIX = "serve_"

#: engines that run on ``--device``, kept out of the process pool: they
#: share the driver's one device context, and serving_torch jobs its one
#: program cache (same FleetSpec -> one program), where a pool worker would
#: set up the card per process
SINGLE_PROCESS_ENGINES = ("fluid", "serving_torch")


def catalog(names: Optional[Sequence[str]] = None) -> List[Tuple[str, str]]:
    """The (scenario, engine) job list: DES + fluid for every scenario,
    serving and serving_torch additionally for the ``serve_*`` presets."""
    from repro_torch.sched import scenario_names

    jobs: List[Tuple[str, str]] = []
    for name in (list(names) if names else scenario_names()):
        jobs.append((name, "des"))
        jobs.append((name, "fluid"))
        if name.startswith(SERVING_PREFIX):
            jobs.append((name, "serving"))
            jobs.append((name, "serving_torch"))
    return jobs


def _run_one(payload) -> Dict:
    """One (scenario, engine) run -> persisted RunResult (module-level so
    the process pool can pickle it); never raises — a crash comes back as a
    row the summary table reports and the exit code fails on."""
    name, engine, quick, seed, out_dir, device = payload
    t0 = time.perf_counter()
    try:
        from repro_torch import exp

        kw = dict(device=device) if engine in SINGLE_PROCESS_ENGINES else {}
        rr = exp.run(name, engine=engine, quick=quick, seed=seed,
                     sim_seed=seed, **kw)
        path = pathlib.Path(out_dir) / f"{name}-{engine}.runresult.npz"
        rr.save(path)
        return {"scenario": name, "engine": engine, "path": str(path),
                "seconds": time.perf_counter() - t0, "error": None}
    except Exception as e:
        return {"scenario": name, "engine": engine, "path": None,
                "seconds": time.perf_counter() - t0,
                "error": f"{type(e).__name__}: {e}"}


def run_catalog(out_dir: pathlib.Path, *, quick: bool, seed: int,
                processes: int,
                names: Optional[Sequence[str]] = None,
                device: str = "cuda") -> List[Dict]:
    payloads = [(n, e, quick, seed, str(out_dir), device)
                for n, e in catalog(names)]
    pooled = [p for p in payloads if p[1] not in SINGLE_PROCESS_ENGINES]
    serial = [p for p in payloads if p[1] in SINGLE_PROCESS_ENGINES]
    results: List[Dict] = []
    if processes > 1 and pooled:
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(max_workers=processes) as pool:
            results.extend(pool.map(_run_one, pooled))
    else:
        results.extend(_run_one(p) for p in pooled)
    results.extend(_run_one(p) for p in serial)
    return results


def validate_dir(out_dir: pathlib.Path) -> List[Dict]:
    """Re-load every persisted ``*.runresult.npz`` and collect schema
    violations per file (an unreadable file is itself a violation)."""
    from repro_torch.exp import RunResult, validate_run_result

    rows = []
    for path in sorted(pathlib.Path(out_dir).glob("*.runresult.npz")):
        try:
            rr = RunResult.load(path)
            scenario, engine = rr.scenario, rr.engine
            problems = validate_run_result(rr)
        except Exception as e:
            scenario = engine = "?"
            problems = [f"unreadable: {type(e).__name__}: {e}"]
        rows.append({"path": path.name, "scenario": scenario,
                     "engine": engine, "problems": problems})
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="parallel scenario-smoke driver: run the (scenario x "
                    "engine) catalog, persist RunResults, gate on schema")
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized scale (400 servers / 4 h)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out-dir", default="artifacts/runresults",
                    help="where *.runresult.npz land and are validated")
    ap.add_argument("--processes", type=int, default=0,
                    help="process fan-out width (0 = one per CPU)")
    ap.add_argument("--scenario", action="append", default=None,
                    metavar="NAME",
                    help="restrict to this scenario (repeatable)")
    ap.add_argument("--validate-only", action="store_true",
                    help="skip the runs; only validate what --out-dir holds")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the fluid and serving_torch "
                         "engines (cuda or cpu)")
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n_crashed = 0
    results: List[Dict] = []
    if not args.validate_only:
        procs = args.processes or os.cpu_count() or 1
        results = run_catalog(out_dir, quick=args.quick, seed=args.seed,
                              processes=procs, names=args.scenario,
                              device=args.device)
        print(f"ran {len(results)} (scenario x engine) jobs "
              f"across {procs} processes")
        # failures first, then by wall time — the broken row is the one the
        # CI log reader is scanning for
        for r in sorted(results, key=lambda r: (r["error"] is None,
                                                -r["seconds"])):
            status = "ok" if r["error"] is None else f"CRASH {r['error']}"
            print(f"  {r['scenario']:28s} {r['engine']:13s} "
                  f"{r['seconds']:6.1f}s  {status}")
        n_crashed = sum(r["error"] is not None for r in results)
        slowest = sorted(results, key=lambda r: -r["seconds"])[:5]
        print("slowest jobs:")
        for r in slowest:
            print(f"  {r['seconds']:6.1f}s  {r['scenario']}/{r['engine']}")

    rows = validate_dir(out_dir)
    print(f"\nvalidating {len(rows)} persisted RunResults in {out_dir}")
    n_bad = 0
    for row in rows:
        if row["problems"]:
            n_bad += 1
            print(f"  {row['path']:44s} FAIL")
            for p in row["problems"]:
                print(f"      - {p}")
        else:
            print(f"  {row['path']:44s} pass "
                  f"({row['scenario']}/{row['engine']})")

    summary = {
        "jobs": results,
        "n_jobs": len(results),
        "n_crashed": n_crashed,
        "validation": rows,
        "n_validated": len(rows),
        "n_schema_invalid": n_bad,
        "total_run_seconds": sum(r["seconds"] for r in results),
        "validate_only": bool(args.validate_only),
    }
    summary_path = out_dir / "smoke_summary.json"
    summary_path.write_text(json.dumps(summary, indent=1))
    print(f"summary written to {summary_path}")

    if not rows:
        print("FAIL: no RunResults found to validate")
        return 1
    if n_crashed or n_bad:
        print(f"FAIL: {n_crashed} crashed runs, "
              f"{n_bad} schema-invalid RunResults")
        return 1
    print(f"PASS: {len(rows)} RunResults, schema clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())

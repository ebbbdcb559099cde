"""Run one cell of the serving benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``perfbench/``
and the program (``src/repro_torch``). It needs a CUDA card; without one,
or without the program, it exits non-zero and prints no result. The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last: each number compared, beside its limit); the same checks
are the last lines of standard error.

The program's kernels build into ``build/kernels`` inside the checkout;
nothing else is written.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    os.environ["OMP_NUM_THREADS"] = "1"  # one process, few threads: steadier host times
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    t_import = time.perf_counter()
    import torch

    torch.set_num_threads(1)
    t_torch = time.perf_counter()

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in spec["workloads"]}.get(args.workload)
    if cell is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"the program is missing from this checkout: {exc}", file=sys.stderr)
        return 4

    from perfbench import harness

    print(f"start: arguments {t_import - T_START:.3f} s, import torch {t_torch - t_import:.3f} s, "
          f"card check and imports {time.perf_counter() - t_torch:.3f} s", file=sys.stderr)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start=T_START, spec=spec)
    result.pop("_run")
    found = harness.loaded_forbidden()
    if found:
        print(f"modules of JAX or of the JAX package were loaded: {found}", file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings a cell's limits are set from, in one process on the card:
for each seed, a short window at the cell's own load, then the numbers
compared for what the program served (its lower reading) and for the
control, the reference computed with float8 e4m3 products put in the
program's place (its upper reading), on the same prompts and tokens.

    python3 perfbench/control.py --workload <cell> --seconds 15 --seeds 1,2,3

One JSON line a seed. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    from perfbench import harness

    cell, config, t, _ = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.Run(cell, config, t, seed, args.seconds, False, "cuda")
        with torch.inference_mode():
            run.build()
            run.warm()
            run.serve()
        run.batcher = None
        if run.moe:
            run._mlp.RECORD = None
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        program = harness.judge(run)
        t2 = time.perf_counter()
        control = harness.judge(run, quant="fp8")
        print(json.dumps({"seed": seed, "program": program, "control": control,
                          "served_s": t1 - t0, "reference_s": t2 - t1,
                          "control_s": time.perf_counter() - t2}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

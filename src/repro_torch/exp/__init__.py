"""One experiment API for every engine and consumer.

Every experiment in the repo — the launcher, fig3/table1/sweep benchmarks,
the calibration study, examples, tests — goes through this package instead
of hand-rolling its own run loop:

  results.py — frozen :class:`RunResult` schema (canonical metric names
               shared by the DES and the fluid model, optional named time
               series, seed/wall-time provenance, deterministic JSON + npz
               serialization) + the two engine adapters
  runner.py  — ``run(scenario, engine="des"|"fluid", ...)`` and grid
               ``sweep(scenario, grid, engine=...)`` (serial/multiprocess
               DES fan-out, vmapped fluid cube), the engine-adapter
               registry, and the declarative override spec the launcher's
               CLI is generated from
  compare.py — fluid-vs-DES error tables across the scenario registry and
               the coarse ``FluidPolicyParams`` auto-fit
               (``benchmarks/calibration.py``)
"""

from repro_torch.exp.compare import (COMPARE_METRICS, calibrate,  # noqa: F401
                               calibrate_registry, compare_engines)
from repro_torch.exp.results import (CANONICAL_METRICS, REQUIRED_SERIES,  # noqa: F401
                               RunResult, from_fluid_output,
                               from_serving_fleet, from_serving_jax,
                               from_sim_result, validate_run_result)
from repro_torch.exp.runner import (OVERRIDE_SPEC, Override,  # noqa: F401
                              SweepResult, engine_names, register_engine,
                              resolve_overrides, run, sweep)

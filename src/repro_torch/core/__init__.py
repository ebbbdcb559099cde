"""Simulation engines for the paper's Eagle + CloudCoaster cluster model.

All scheduling *decisions* (placement policies, the §3.2 controller, the
scenario presets) live in :mod:`repro_torch.sched`; this package owns the
mechanics that execute them:

  jobs.py     — Job/Trace model
  cluster.py  — SimConfig (paper §4 defaults) + server state
  engine.py   — discrete-event loop (Eagle baseline == replace_fraction 0;
                CloudCoaster == replace_fraction p); delegates placement and
                manager ticks to injected repro_torch.sched policies
  metrics.py  — results & paper-table summaries
  simjax.py   — JAX slotted-time simulator for vmap/pjit parameter sweeps,
                driven by the same repro_torch.sched controller (fluid adapter)
  controller.py — back-compat shim re-exporting repro_torch.sched.controller
"""

from repro_torch.core.cluster import SimConfig  # noqa: F401
from repro_torch.core.engine import simulate  # noqa: F401
from repro_torch.core.jobs import Job, Trace  # noqa: F401
from repro_torch.core.metrics import SimResult  # noqa: F401

"""Pluggable scheduling policies — the paper's contribution as one layer.

The DES (``repro_torch.core.engine``), the JAX fluid simulator
(``repro_torch.core.simjax``) and the elastic runtime (``repro_torch.runtime``) all
delegate their scheduling decisions here:

  controller.py — §3.2 long-load-ratio controller: declarative
                  ``ControllerSpec`` + discrete and fluid adapters
  policy.py     — placement policies (centralized long, Eagle probing,
                  BoPF-style burst guard, spot-aware) + their fluid forms
  scenarios.py  — named ``trace x policy x SimConfig`` presets used by
                  launchers, benchmarks, examples and tests
"""

from repro_torch.sched.controller import (ControllerConfig, ControllerSpec,  # noqa: F401
                                    FleetView, desired_delta,
                                    fluid_controller_step, select_drain)
from repro_torch.sched.policy import (BurstGuardProbing, EagleProbing,  # noqa: F401
                                FluidPolicyParams, LeastLoadedCentral,
                                PlacementPolicy, ShortPlacementPolicy,
                                SpotAwareProbing, make_long_policy,
                                make_short_policy, running_entries)
from repro_torch.sched.scenarios import (PAPER_SCALE, QUICK_SCALE, Scenario,  # noqa: F401
                                   get_scenario, register_scenario,
                                   scenario_names)

"""Back-compat shim — the controller moved to :mod:`repro_torch.sched.controller`.

The long-load-ratio controller (paper §3.2) now lives in the unified
scheduling-policy package together with its fluid (JAX-traceable) adapter
and the placement policies; one implementation really does drive the DES
(``repro_torch.core.engine``), the fluid simulator (``repro_torch.core.simjax``) and the
elastic runtime (``repro_torch.runtime``). Import from ``repro_torch.sched`` in new
code.
"""

from repro_torch.sched.controller import (ControllerConfig, ControllerSpec,  # noqa: F401
                                    FleetView, desired_delta,
                                    fluid_controller_step, select_drain)

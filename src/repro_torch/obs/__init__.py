"""Flight-recorder layer shared by all four engines.

Three pieces, one observability spine (see ROADMAP "repro/obs"):

  events.py  — typed scheduler event log (RENT, PROVISION, DRAIN, REVOKE,
               HEDGE, HEDGE_WIN, ADMIT, DISPLACE, REROUTE, THROTTLE) emitted
               natively
               by the Python engines (``core/engine``, ``sched/controller``,
               ``runtime/serving``) and reconstructed post-hoc for
               ``runtime/serving_jax`` from its per-tick event-count series
               — one schema, so event streams diff across engines
  trace.py   — zero-cost-when-disabled span/counter tracer with Chrome
               trace-event JSON export (open in Perfetto: ui.perfetto.dev):
               the fleet's engine ticks, and host-clock spans
               (``Tracer.span``) inside the served path's batcher and
               model step
  metrics.py — counters/gauges/histograms registry snapshotted into
               ``RunResult.meta["obs"]`` (jit-cache hit/miss, compile vs
               steady wall time around ``serving_jax.get_program``)
"""

from repro_torch.obs.events import (ADMIT, DISPLACE, DRAIN, EVENT_TYPES,  # noqa: F401
                              HEDGE, HEDGE_WIN, PROVISION, RENT, REROUTE,
                              REVOKE, THROTTLE, EventRecorder, SchedEvent,
                              check_replica_lifecycles,
                              check_transient_conservation,
                              diff_event_streams, events_from_counts)
from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge,  # noqa: F401
                               Histogram, MetricsRegistry, timed)
from repro_torch.obs.trace import (Tracer, trace_from_run_result,  # noqa: F401
                             validate_trace_events, validate_trace_file)

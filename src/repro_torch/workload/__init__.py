"""Workload subsystem: composable arrival processes, job mixes, trace
builders, burstiness metrics, and deterministic trace persistence.

  arrivals.py — ArrivalProcess library (Poisson, N-state MMPP, Diurnal,
                FlashCrowd, Modulated/Superpose combinators) with exact
                serial samplers and the slot-binned batch sampler
                (``batch_sample_counts``, the JAX package's draws through
                threefry, on the card by default)
  jobmix.py   — job-size/duration mixes (Yahoo two-class, Google heavy-tail)
  builders.py — named trace builders (yahoo/google legacy-exact, diurnal,
                flash-crowd, poisson control) used by scenario presets
  stats.py    — burstiness / peak-to-mean / concurrency-curve metrics
  io.py       — npz trace save/load + params-keyed cache

``traces.synthetic`` is a compatibility shim over this package.
"""

from repro_torch.workload.arrivals import (ARRIVAL_PROCESSES, ArrivalProcess,  # noqa: F401
                                     Diurnal, FlashCrowd, MMPP, Modulated,
                                     Poisson, Superpose, batch_sample_counts,
                                     counts_to_times, make_arrival_process,
                                     sample_counts_torch)
from repro_torch.workload.builders import (TRACE_BUILDERS, diurnal_like,  # noqa: F401
                                     flash_crowd_like, google_arrivals,
                                     google_like, poisson_like,
                                     register_builder, yahoo_arrivals,
                                     yahoo_like, yahoo_rate)
from repro_torch.workload.io import (cached_trace, load_trace, save_trace,  # noqa: F401
                               trace_key)
from repro_torch.workload.jobmix import (HeavyTailMix, JobMix,  # noqa: F401
                                   TwoClassLognormalMix, build_trace)
from repro_torch.workload.stats import (burstiness_coefficient,  # noqa: F401
                                  concurrency_stats, index_of_dispersion,
                                  peak_to_mean, slot_counts, smooth,
                                  sparkline)

"""Straggler mitigation (a copy of ``repro.runtime.straggler``).

Training side: a step-time watchdog — pods consistently slower than
``factor`` x the rolling median are flagged to the controller as de-facto
revocations (drain + replace), the standard large-fleet mitigation when the
slow pod is persistent rather than transient.

Serving side: request hedging implements the paper's §3.3 rule ("at least one
copy of the short tasks is scheduled to an on-demand server"): a request
served by a transient replica that exceeds its deadline budget is re-issued
on the on-demand reserve; first finisher wins (see repro.runtime.serving).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List


@dataclass
class StragglerWatchdog:
    factor: float = 2.0
    window: int = 16
    min_samples: int = 4
    _times: Dict[int, Deque] = field(default_factory=dict)

    def observe(self, worker_id: int, step_time_s: float):
        self._times.setdefault(worker_id, deque(maxlen=self.window)).append(
            step_time_s)

    def _median_of_medians(self) -> float:
        meds = []
        for ts in self._times.values():
            s = sorted(ts)
            meds.append(s[len(s) // 2])
        s = sorted(meds)
        return s[len(s) // 2] if s else 0.0

    def flagged(self) -> List[int]:
        """Workers whose median step time exceeds factor x fleet median."""
        fleet = self._median_of_medians()
        out = []
        if fleet <= 0:
            return out
        for wid, ts in self._times.items():
            if len(ts) < self.min_samples:
                continue
            s = sorted(ts)
            if s[len(s) // 2] > self.factor * fleet:
                out.append(wid)
        return sorted(out)

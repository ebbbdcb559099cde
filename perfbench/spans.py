"""The program's host-clock spans as the per-layer readers take them: the
events of a traced run's ``Tracer`` (``Run.tracer``), in seconds of
``time.perf_counter()``, the clock the window's start (``Run.origin``) is
read on. Empty in an untraced run or where the program records no spans."""

from __future__ import annotations

from typing import Dict, List, Tuple


def events(run, name: str) -> List[dict]:
    """The tracer's events named ``name``, in the order recorded."""
    tracer = getattr(run, "tracer", None)
    if tracer is None:
        return []
    return [e for e in tracer.events if e["name"] == name]


def window(run) -> Tuple[float, float]:
    """The window's (start, close) on the spans' clock (seconds)."""
    return run.origin, run.origin + run.seconds


def start(e: dict) -> float:
    return e["ts"] / 1e6


def end(e: dict) -> float:
    return (e["ts"] + e["dur"]) / 1e6


def by_id(run, name: str) -> Dict[int, dict]:
    """Spans named ``name`` by their ``id``."""
    return {e["args"]["id"]: e for e in events(run, name)}

"""AST harvesters: the linter derives the names it enforces from the repo
itself (never from a hand-maintained list that could drift).

  traced sweep params   <- ``OVERRIDE_SPEC`` aliases + ``sim_key``s in
                           ``exp/runner.py`` and the dict literal returned
                           by ``make_params`` in ``runtime/serving_jax.py``
  event schema          <- the ``EVENT_TYPES`` tuple in ``obs/events.py``
  serving_jax columns   <- the ``ev_counts = jnp.stack([...])`` arity in
                           ``runtime/serving_jax.py``
  Python-engine emits   <- ``*.emit(t, <TYPE>, ...)`` call sites in the
                           engine modules

All helpers take a :class:`~repro_torch.analysis.core.SourceFile` (or context)
and return plain data; rules own the judgement calls.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.core import LintContext, SourceFile

#: repo-relative locations the project rules introspect (relative to the
#: lint root, i.e. ``src/repro``); fixture mini-trees mirror this layout
RUNNER_REL = "exp/runner.py"
#: the serving program the traced-name harvest reads (the twin of
#: ``runtime/serving_jax.py``)
SERVING_JAX_REL = "runtime/serving_torch.py"
#: where the plain fleet program stacks its per-tick event counts
EV_COUNTS_REL = "kernels/serving_fleet/ref.py"
EVENTS_REL = "obs/events.py"
LOCK_REL = "analysis/locks/event_types.lock"
#: modules that emit SchedEvents natively (the recorder side of the schema)
ENGINE_RELS = ("core/engine.py", "runtime/serving.py", "sched/controller.py")


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` attribute chain -> ``"a.b.c"``; None for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def import_aliases(tree: ast.Module) -> Dict[str, str]:
    """Local name -> fully dotted origin, from the module's imports
    (``import numpy as np`` -> ``{"np": "numpy"}``, ``from time import
    time`` -> ``{"time": "time.time"}``). Relative imports are skipped —
    they cannot shadow the stdlib/numpy names the determinism rule bans."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out[alias.asname or alias.name.split(".")[0]] = alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            for alias in node.names:
                if alias.name != "*":
                    out[alias.asname or alias.name] = \
                        f"{node.module}.{alias.name}"
    return out


def resolve(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Resolve a call target through the import aliases: the chain's root
    name must be import-bound, else None (locals never resolve)."""
    chain = dotted(node)
    if chain is None:
        return None
    root, _, rest = chain.partition(".")
    origin = aliases.get(root)
    if origin is None:
        return None
    return f"{origin}.{rest}" if rest else origin


def _const_strs(nodes) -> List[str]:
    return [n.value for n in nodes
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


def harvest_traced_names(ctx: LintContext) -> Set[str]:
    """The names that must never become ``FleetSpec`` fields: every
    ``OVERRIDE_SPEC`` alias and ``sim_key``, plus every key of the params
    dict ``serving_jax.make_params`` returns. Cached on the context."""
    cached = ctx.cache.get("traced_names")
    if cached is not None:
        return cached  # type: ignore[return-value]
    names: Set[str] = set()
    runner = ctx.file(RUNNER_REL)
    if runner is not None:
        for node in ast.walk(runner.tree):
            value = getattr(node, "value", None)
            if isinstance(node, (ast.Assign, ast.AnnAssign)) \
                    and isinstance(value, ast.Dict):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                if any(isinstance(t, ast.Name) and t.id == "OVERRIDE_SPEC"
                       for t in targets):
                    names.update(_const_strs(value.keys))
                    for v in value.values:
                        if isinstance(v, ast.Call):
                            names.update(
                                kw.value.value for kw in v.keywords
                                if kw.arg == "sim_key"
                                and isinstance(kw.value, ast.Constant)
                                and isinstance(kw.value.value, str))
    sjx = ctx.file(SERVING_JAX_REL)
    if sjx is not None:
        for node in ast.walk(sjx.tree):
            if isinstance(node, ast.FunctionDef) \
                    and node.name == "make_params":
                for ret in ast.walk(node):
                    if isinstance(ret, ast.Return) \
                            and isinstance(ret.value, ast.Dict):
                        names.update(_const_strs(ret.value.keys))
    ctx.cache["traced_names"] = names
    return names


def harvest_event_types(sf: SourceFile) -> Optional[Tuple[List[str], int]]:
    """The ``EVENT_TYPES`` tuple of string constants (in order) and the
    line it is assigned on; None when the module does not define it as a
    literal."""
    for node in ast.walk(sf.tree):
        value = getattr(node, "value", None)
        if isinstance(node, (ast.Assign, ast.AnnAssign)) \
                and isinstance(value, ast.Tuple):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            if any(isinstance(t, ast.Name) and t.id == "EVENT_TYPES"
                   for t in targets):
                return _const_strs(value.elts), node.lineno
    return None


def harvest_ev_counts_arity(sf: SourceFile) -> Optional[Tuple[int, int]]:
    """Element count of the list stacked into ``ev_counts`` inside
    ``_simulate`` (one element per EVENT_TYPES column) and its line; None
    when no ``ev_counts = ...stack([...])`` assignment exists."""
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Assign) \
                and any(isinstance(t, ast.Name) and t.id == "ev_counts"
                        for t in node.targets):
            for sub in ast.walk(node.value):
                chain = dotted(sub.func) if isinstance(sub, ast.Call) \
                    else None
                if chain is not None and chain.endswith("stack") \
                        and sub.args \
                        and isinstance(sub.args[0], (ast.List, ast.Tuple)):
                    return len(sub.args[0].elts), node.lineno
    return None


def harvest_emitted_types(sf: SourceFile, event_names: Set[str]) -> Set[str]:
    """Event-type constants referenced in ``<recorder>.emit(...)`` calls:
    either bare names imported from ``obs.events`` (``RENT``) or attribute
    form (``ev.ADMIT``). Only names in ``event_names`` count."""
    out: Set[str] = set()
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "emit":
            for arg in node.args:
                if isinstance(arg, ast.Name) and arg.id in event_names:
                    out.add(arg.id)
                elif isinstance(arg, ast.Attribute) \
                        and arg.attr in event_names:
                    out.add(arg.attr)
    return out

"""The five invariant rules (see ROADMAP "repro/analysis" for the prose
versions they mechanize). Each is a small class over the parsed-source
model in ``core.py``; add a rule by subclassing :class:`Rule`, decorating
with ``@register_rule``, and committing a ``# BAD``-annotated fixture its
``self_test`` exercises.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.core import (Finding, LintContext, Rule, SourceFile,
                                 check_fixture, expected_bad_lines,
                                 fixture_context, fixtures_root,
                                 register_rule)
from repro_torch.analysis.harvest import (ENGINE_RELS, EVENTS_REL, LOCK_REL,
                                    RUNNER_REL, SERVING_JAX_REL,
                                          EV_COUNTS_REL, dotted,
                                    harvest_emitted_types,
                                    harvest_ev_counts_arity,
                                    harvest_event_types,
                                    harvest_traced_names, import_aliases,
                                    resolve)

# --------------------------------------------------------------- determinism

#: numpy.random attributes that are fine: explicitly-seeded generator
#: construction, not hidden-global-state draws
_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "BitGenerator",
                 "PCG64", "Philox", "MT19937", "SFC64"}
#: stdlib random attributes that are fine: instance construction with an
#: explicit seed (the instance's methods don't resolve, so they never flag)
_PY_RANDOM_OK = {"Random", "SystemRandom"}
#: wall-clock datetime constructors
_DATETIME_BAD = {"now", "utcnow", "today"}


@register_rule
class DeterminismRule(Rule):
    """Forbid wall-clock and hidden-global-state randomness in src/repro:
    ``time.time``, ``datetime.now``/``utcnow``/``today``, module-level
    ``random.*`` draws, and unseeded ``np.random.<fn>``. Allowed:
    ``time.perf_counter`` (elapsed measurement), ``random.Random(seed)``,
    and ``np.random.default_rng(seed)`` / explicit bit generators. Every
    engine takes its RNG as a seeded ``Generator`` — a wall-clock or
    global-RNG call is exactly how two runs of one scenario diverge."""

    id = "determinism"
    description = ("no time.time / datetime.now / module-level random.* / "
                   "unseeded np.random.* in src/repro")

    def _check_call(self, sf: SourceFile, node: ast.Call,
                    aliases: Dict[str, str]) -> Optional[Finding]:
        target = resolve(node.func, aliases)
        if target is None:
            return None
        if target == "time.time":
            return sf.finding(node, self.id,
                              "wall-clock time.time() — use "
                              "time.perf_counter() for elapsed measurement")
        root, _, rest = target.partition(".")
        leaf = target.rsplit(".", 1)[-1]
        if root == "datetime" and leaf in _DATETIME_BAD:
            return sf.finding(node, self.id,
                              f"wall-clock {target}() — runs must not "
                              f"depend on the calendar")
        if root == "random" and leaf not in _PY_RANDOM_OK:
            return sf.finding(node, self.id,
                              f"module-level {target}() draws from the "
                              f"hidden global RNG — use a seeded "
                              f"random.Random / np.random.default_rng")
        if target.startswith("numpy.random."):
            if leaf not in _NP_RANDOM_OK:
                return sf.finding(node, self.id,
                                  f"np.random.{leaf}() uses the global "
                                  f"numpy RNG — use a seeded "
                                  f"np.random.default_rng(seed)")
            if leaf == "default_rng" and not node.args and not node.keywords:
                return sf.finding(node, self.id,
                                  "np.random.default_rng() without a seed "
                                  "is entropy-seeded — pass one explicitly")
        return None

    def run(self, ctx: LintContext) -> List[Finding]:
        out: List[Finding] = []
        for sf in ctx.files:
            aliases = import_aliases(sf.tree)
            if not aliases:
                continue
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Call):
                    f = self._check_call(sf, node, aliases)
                    if f is not None:
                        out.append(f)
        return out

    def self_test(self):
        ctx, (bad, clean) = fixture_context("determinism_bad.py",
                                            "determinism_clean.py")
        return [("seeded violations flagged",
                 *check_fixture(self, ctx, bad)),
                ("allowlist + suppressions stay clean",
                 *check_fixture(self, ctx, clean))]


# ------------------------------------------------------------- static shapes

#: the jit-cache-key classes the rule protects (constructor keywords and
#: class-body fields); extend if another engine grows a static spec
_SPEC_CLASSES = ("FleetSpec",)


@register_rule
class StaticShapeRule(Rule):
    """ROADMAP's "a swept value must never land in the spec" rule, made
    mechanical: any name harvested as a traced sweep param (OVERRIDE_SPEC
    aliases + sim_keys, ``make_params`` dict keys) may not appear as a
    ``FleetSpec`` field or constructor keyword — a swept value in the
    hashable spec keys the program cache and forces one XLA retrace per
    grid point, which is exactly the cube-vs-pointwise blowup the
    serving_jax engine exists to avoid."""

    id = "static-shape"
    description = ("traced sweep params (OVERRIDE_SPEC / make_params) must "
                   "never become FleetSpec fields")

    def run(self, ctx: LintContext) -> List[Finding]:
        traced = harvest_traced_names(ctx)
        if not traced:
            return []
        out: List[Finding] = []

        def flag(sf, node, name, where):
            out.append(sf.finding(
                node, self.id,
                f"traced sweep param {name!r} {where} — a swept value "
                f"must never land in the spec (it keys the jit program "
                f"cache; keep it in make_params)"))

        for sf in ctx.files:
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.ClassDef) \
                        and node.name in _SPEC_CLASSES:
                    for stmt in node.body:
                        tgt = stmt.target if isinstance(stmt, ast.AnnAssign) \
                            else (stmt.targets[0]
                                  if isinstance(stmt, ast.Assign)
                                  else None)
                        if isinstance(tgt, ast.Name) and tgt.id in traced:
                            flag(sf, stmt, tgt.id,
                                 f"declared as a {node.name} field")
                elif isinstance(node, ast.Call):
                    chain = dotted(node.func)
                    if chain is None \
                            or chain.rsplit(".", 1)[-1] not in _SPEC_CLASSES:
                        continue
                    for kw in node.keywords:
                        if kw.arg in traced:
                            flag(sf, kw.value, kw.arg,
                                 f"passed to {chain}(...)")
        return out

    def self_test(self):
        ctx, (bad,) = fixture_context("static_shape_bad.py")
        # pin the traced set so the fixture's # BAD markers stay exact even
        # if the real harvest grows; a second case checks the harvest
        # itself against the live repo
        ctx.cache["traced_names"] = {"threshold", "max_transient",
                                     "max_slots", "revoke_prob"}
        cases = [("seeded violations flagged",
                  *check_fixture(self, ctx, bad))]
        repo_root = fixtures_root().parents[1]  # src/repro_torch
        repo_ctx = LintContext(
            repo_root,
            [SourceFile(repo_root, repo_root / rel)
             for rel in (RUNNER_REL, SERVING_JAX_REL)
             if (repo_root / rel).exists()], [])
        harvested = harvest_traced_names(repo_ctx)
        want = {"threshold", "max_transient", "max_slots"}
        ok = want <= harvested
        cases.append(("harvest finds the canonical traced trio", ok,
                      f"harvested {len(harvested)} names"
                      if ok else f"missing {want - harvested}"))
        return cases


# -------------------------------------------------------------- schema drift

@register_rule
class SchemaDriftRule(Rule):
    """The event schema is on-disk data (column index = event type), so
    ``EVENT_TYPES`` is locked append-only against
    ``analysis/locks/event_types.lock``: reorder/rename/removal fails the
    gate, and an append fails until the lock is regenerated with
    ``--update-locks``. Two companion checks keep the JAX engine on the
    same schema: the ``ev_counts`` stack in ``serving_jax._simulate`` must
    have one column per type, and every type must be emitted by at least
    one Python engine (else ``diff_event_streams`` silently compares a
    dead column)."""

    id = "schema-drift"
    description = ("EVENT_TYPES locked append-only; serving_jax ev_counts "
                   "arity and Python-engine emit coverage must match")

    def _read_lock(self, ctx: LintContext) -> Optional[List[str]]:
        path = ctx.root / LOCK_REL
        if not path.exists():
            return None
        return [ln.strip() for ln in path.read_text().splitlines()
                if ln.strip() and not ln.lstrip().startswith("#")]

    def run(self, ctx: LintContext) -> List[Finding]:
        sf = ctx.file(EVENTS_REL)
        if sf is None:
            return []  # not a tree that carries the schema (fixture roots)
        out: List[Finding] = []
        harvested = harvest_event_types(sf)
        if harvested is None:
            return [Finding(EVENTS_REL, 1, self.id,
                            "EVENT_TYPES literal tuple not found")]
        types, line = harvested
        lock = self._read_lock(ctx)
        if lock is None:
            out.append(sf.finding(line, self.id,
                                  f"lock file {LOCK_REL} missing — run "
                                  f"python -m repro_torch.analysis.lint "
                                  f"--update-locks"))
        else:
            n = min(len(types), len(lock))
            if types[:n] != lock[:n]:
                i = next(i for i in range(n) if types[i] != lock[i])
                out.append(sf.finding(
                    line, self.id,
                    f"EVENT_TYPES[{i}] is {types[i]!r} but the committed "
                    f"lock says {lock[i]!r} — the schema is append-only "
                    f"(column index = on-disk event type); never reorder, "
                    f"rename or remove"))
            elif len(types) < len(lock):
                out.append(sf.finding(
                    line, self.id,
                    f"EVENT_TYPES dropped {lock[len(types):]} — the "
                    f"schema is append-only; removal breaks every "
                    f"persisted event-count series"))
            elif len(types) > len(lock):
                out.append(sf.finding(
                    line, self.id,
                    f"appended event types {types[len(lock):]} are not in "
                    f"the lock — run python -m repro_torch.analysis.lint "
                    f"--update-locks to record the new schema"))
        sjx = ctx.file(EV_COUNTS_REL)
        if sjx is not None:
            arity = harvest_ev_counts_arity(sjx)
            if arity is None:
                out.append(Finding(EV_COUNTS_REL, 1, self.id,
                                   "no `ev_counts = ...stack([...])` found "
                                   "— serving_jax no longer records the "
                                   "per-tick event-count series?"))
            elif arity[0] != len(types):
                out.append(Finding(
                    EV_COUNTS_REL, arity[1], self.id,
                    f"ev_counts stacks {arity[0]} columns but EVENT_TYPES "
                    f"has {len(types)} — every event type needs a matching "
                    f"per-tick count column in _simulate"))
        engine_sfs = [ctx.file(rel) for rel in ENGINE_RELS]
        engine_sfs = [e for e in engine_sfs if e is not None]
        if engine_sfs:
            emitted: Set[str] = set()
            for esf in engine_sfs:
                emitted |= harvest_emitted_types(esf, set(types))
            for name in types:
                if name not in emitted:
                    out.append(sf.finding(
                        line, self.id,
                        f"event type {name!r} is never emitted by a "
                        f"Python engine ({', '.join(ENGINE_RELS)}) — a "
                        f"dead column diffs as trivially equal"))
        return out

    def self_test(self):
        root = fixtures_root() / "schema_drift_tree"
        ctx = LintContext.from_root(root)
        got = {(f.path, f.line) for f in self.run(ctx)}
        want = set()
        for sf in ctx.files:
            for line in expected_bad_lines(sf):
                want.add((sf.rel, line))
        ok = got == want
        detail = (f"{len(got)} drift findings at the seeded sites" if ok
                  else f"got {sorted(got)} != expected {sorted(want)}")
        return [("reorder + arity + missing-emit tree flagged", ok, detail)]


# ----------------------------------------------------------- registry parity

#: SHORT_POLICIES entries excused from fluid_params (none today; naming a
#: policy here is the "explicit exemption" the rule accepts)
FLUID_EXEMPT: Set[str] = set()


def check_parity(*, short_policies: Dict[str, type],
                 fluid_exempt: Set[str],
                 scenarios: Dict[str, str],
                 trace_builders: Set[str],
                 builder_params: Set[str],
                 engines: Set[str],
                 required_series: Set[str],
                 override_spec: Dict[str, Tuple[Optional[str],
                                                Optional[str]]],
                 config_fields: Set[str]) -> List[Tuple[str, str]]:
    """Pure parity check over the registries (injected so the self-test
    can seed violations without monkeypatching live modules). Returns
    ``(anchor_rel, message)`` pairs."""
    out: List[Tuple[str, str]] = []
    for name, cls in short_policies.items():
        if name in fluid_exempt:
            continue
        if not callable(getattr(cls, "fluid_params", None)):
            out.append(("sched/policy.py",
                        f"SHORT_POLICIES[{name!r}] ({cls.__name__}) has no "
                        f"fluid_params() and is not in FLUID_EXEMPT — the "
                        f"fluid engine cannot calibrate it"))
    for sname, trace_fn in scenarios.items():
        if trace_fn not in trace_builders:
            out.append(("sched/scenarios.py",
                        f"scenario {sname!r}: trace_fn {trace_fn!r} does "
                        f"not resolve in TRACE_BUILDERS"))
    for engine in sorted(engines - required_series):
        out.append(("exp/results.py",
                    f"engine {engine!r} is registered but has no "
                    f"REQUIRED_SERIES entry — validate_run_result cannot "
                    f"gate its outputs"))
    for alias, (trace_key, sim_key) in override_spec.items():
        if sim_key is not None and sim_key not in config_fields:
            out.append(("exp/runner.py",
                        f"OVERRIDE_SPEC[{alias!r}].sim_key {sim_key!r} is "
                        f"not a SimConfig/ServingFleetConfig field"))
        if trace_key is not None and builder_params \
                and trace_key not in builder_params:
            out.append(("exp/runner.py",
                        f"OVERRIDE_SPEC[{alias!r}].trace_key {trace_key!r} "
                        f"is not accepted by any TRACE_BUILDERS builder"))
    return out


@register_rule
class RegistryParityRule(Rule):
    """Every cross-registry contract the engines rely on, checked by
    import: SHORT_POLICIES -> fluid_params, Scenario.trace_fn ->
    TRACE_BUILDERS, register_engine tag -> REQUIRED_SERIES, OVERRIDE_SPEC
    keys -> real config fields / builder kwargs. A broken pairing today
    surfaces as a KeyError three layers away at run time; here it is a
    named finding at lint time."""

    id = "registry-parity"
    description = ("policies/scenarios/engines/override registries must "
                   "pairwise resolve")
    requires_import = True

    def _gather(self):
        import dataclasses
        import inspect

        import repro_torch.traces  # noqa: F401  (the getattr target of Scenario.trace)
        from repro_torch.core.cluster import SimConfig
        from repro_torch.exp.results import REQUIRED_SERIES
        from repro_torch.exp.runner import _ENGINES, OVERRIDE_SPEC
        from repro_torch.runtime.serving import ServingFleetConfig
        from repro_torch.sched import get_scenario, scenario_names
        from repro_torch.sched.policy import SHORT_POLICIES
        from repro_torch.workload.builders import TRACE_BUILDERS

        builder_params: Set[str] = set()
        for fn in TRACE_BUILDERS.values():
            for p in inspect.signature(fn).parameters.values():
                if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY):
                    builder_params.add(p.name)
        config_fields = {f.name for f in dataclasses.fields(SimConfig)}
        config_fields |= {f.name for f in
                          dataclasses.fields(ServingFleetConfig)}
        return dict(
            short_policies=dict(SHORT_POLICIES),
            fluid_exempt=FLUID_EXEMPT,
            scenarios={name: get_scenario(name).trace_fn
                       for name in scenario_names()},
            trace_builders=set(TRACE_BUILDERS),
            builder_params=builder_params,
            engines=set(_ENGINES),
            required_series=set(REQUIRED_SERIES),
            override_spec={name: (ov.trace_key, ov.sim_key)
                           for name, ov in OVERRIDE_SPEC.items()},
            config_fields=config_fields)

    def run(self, ctx: LintContext) -> List[Finding]:
        if ctx.file(RUNNER_REL) is None:
            return []  # fixture roots carry no registries
        return [Finding(rel, 1, self.id, msg)
                for rel, msg in check_parity(**self._gather())]

    def self_test(self):
        class WithFluid:
            def fluid_params(self):  # pragma: no cover - shape only
                return None

        class NoFluid:
            pass

        clean = dict(
            short_policies={"eagle": WithFluid, "manual": NoFluid},
            fluid_exempt={"manual"},
            scenarios={"coaster": "yahoo_like"},
            trace_builders={"yahoo_like"},
            builder_params={"n_servers", "horizon"},
            engines={"des"},
            required_series={"des", "fluid"},
            override_spec={"servers": ("n_servers", "n_servers")},
            config_fields={"n_servers"})
        ok0 = check_parity(**clean) == []
        seeded = dict(
            clean,
            fluid_exempt=set(),                       # NoFluid now naked
            scenarios={"coaster": "missing_like"},    # dangling trace_fn
            engines={"des", "mystery"},               # no REQUIRED_SERIES
            override_spec={"servers": ("bogus_key", "bogus_field")})
        problems = check_parity(**seeded)
        ok1 = len(problems) == 5
        return [("clean registries produce no findings", ok0,
                 "0 findings" if ok0 else f"{check_parity(**clean)}"),
                ("each seeded registry break is flagged", ok1,
                 f"{len(problems)} findings for 5 seeded breaks"
                 if ok1 else f"got {len(problems)}: {problems}")]


# ---------------------------------------------------------------- obs hygiene

#: attribute/variable names the guard contract applies to (the engines'
#: conventional recorder/tracer handles, None when recording is off)
_GUARDED_NAMES = {"recorder", "tracer"}


@register_rule
class ObsHygieneRule(Rule):
    """Recording is off by default: engines hold ``recorder=None`` /
    ``tracer=None`` and every call site must sit behind the ``is not
    None`` guard (the zero-cost-when-disabled contract in the obs
    docstrings). Accepted guard forms: an enclosing ``if``/ternary whose
    test contains ``<recv> is not None``, an earlier early-return
    ``if <recv> is None: return``, an ``assert <recv> is not None``, or a
    receiver constructed locally in the same scope."""

    id = "obs-hygiene"
    description = ("recorder/tracer call sites must sit behind the "
                   "`is not None` guard")

    @staticmethod
    def _receiver(node: ast.Call) -> Optional[ast.AST]:
        if not isinstance(node.func, ast.Attribute):
            return None
        recv = node.func.value
        if isinstance(recv, ast.Name) and recv.id in _GUARDED_NAMES:
            return recv
        if isinstance(recv, ast.Attribute) and recv.attr in _GUARDED_NAMES:
            return recv
        return None

    @staticmethod
    def _terminal(body: List[ast.stmt]) -> bool:
        return bool(body) and isinstance(
            body[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))

    def _guarded(self, sf: SourceFile, call: ast.Call,
                 recv_src: str) -> bool:
        parents = sf.parents()
        scope: Optional[ast.AST] = None
        node: ast.AST = call
        while node in parents:
            node = parents[node]
            if isinstance(node, (ast.If, ast.IfExp, ast.While)):
                if f"{recv_src} is not None" in ast.unparse(node.test):
                    return True
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Module)) and scope is None:
                scope = node
        if scope is None:
            return False
        for stmt in ast.walk(scope):
            if getattr(stmt, "lineno", 10**9) >= call.lineno:
                continue
            if isinstance(stmt, ast.If) \
                    and f"{recv_src} is None" in ast.unparse(stmt.test) \
                    and self._terminal(stmt.body):
                return True
            if isinstance(stmt, ast.Assert) \
                    and f"{recv_src} is not None" in ast.unparse(stmt.test):
                return True
            if isinstance(stmt, ast.Assign) \
                    and isinstance(stmt.value, ast.Call) \
                    and any(isinstance(t, ast.Name) and t.id == recv_src
                            for t in stmt.targets):
                return True
        return False

    def run(self, ctx: LintContext) -> List[Finding]:
        out: List[Finding] = []
        for sf in ctx.files:
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                recv = self._receiver(node)
                if recv is None:
                    continue
                recv_src = ast.unparse(recv)
                if not self._guarded(sf, node, recv_src):
                    out.append(sf.finding(
                        node, self.id,
                        f"unguarded {recv_src}.{node.func.attr}(...) — "
                        f"recording is off by default; wrap in "
                        f"`if {recv_src} is not None` (zero-cost-when-"
                        f"disabled contract)"))
        return out

    def self_test(self):
        ctx, (bad, clean) = fixture_context("obs_hygiene_bad.py",
                                            "obs_hygiene_clean.py")
        return [("seeded unguarded emits flagged",
                 *check_fixture(self, ctx, bad)),
                ("every accepted guard form stays clean",
                 *check_fixture(self, ctx, clean))]

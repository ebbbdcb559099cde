"""The port's linter and sanitizer (``repro_torch.analysis``), the twin of
``repro.analysis``.

Each copied file equals the reference's but for the import prefix and the
substitutions named in ``EDITS`` (the serving program the rules read is
``runtime/serving_torch.py``, its event-count stack the plain fleet
program's, the sanitizer's engines and its no-retrace assert the port's,
the README section the docs smoke reads the port's). All five rules run
over ``src/repro_torch`` with 0 findings, and each reads something: none
passes vacuously.
"""

from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
REF = SRC / "repro" / "analysis"
PORT = SRC / "repro_torch" / "analysis"

_SANITIZE_DOC = '''"""Runtime sanitizer: ``python -m repro_torch.analysis.sanitize --quick``.

Two dynamic invariants the AST linter cannot see:

1. **Tracer hygiene** — one quick scenario per engine with JAX's
   ``check_tracer_leaks`` debug mode on, so a tracer escaping a jitted
   scope (the classic "leaked trace" bug that static-shape discipline
   exists to prevent) fails loudly instead of surfacing as a cryptic
   error three layers away. Every run is re-validated against the
   RunResult schema on top.
2. **No retrace after warmup** — an identical back-to-back ``serving_jax``
   sweep must be a pure program-cache hit: the PR-7 ``obs/metrics``
   ``serving_jax.jit_cache_miss`` counter must not move on the second
   sweep and ``last_run_obs()["phase"]`` must report ``steady``. A miss
   here means something nondeterministic (or a swept value) leaked into
   ``FleetSpec`` and the whole cube-vs-pointwise speedup silently died.
'''
_SANITIZE_DOC_PORT = '''"""Runtime sanitizer: ``python -m repro_torch.analysis.sanitize --quick``.

Two dynamic invariants the AST linter cannot see:

1. **Run hygiene** — one quick scenario per engine (``des``, ``fluid``,
   ``serving``, ``serving_torch``), each run re-validated against the
   RunResult schema. JAX's ``check_tracer_leaks`` has no torch twin: an
   eager program has no traced scope a value could leak from, so the
   reference's tracer-leak check has nothing to check here.
2. **No retrace after warmup** — an identical back-to-back ``serving_torch``
   sweep must be a pure program-cache hit: the ``obs/metrics``
   ``serving_torch.jit_cache_miss`` counter (``_record_exec``) must not
   move on the second sweep and ``last_run_obs()["phase"]`` must report
   ``steady``. A miss here means something nondeterministic (or a swept
   value) leaked into ``FleetSpec`` and the whole cube-vs-pointwise
   speedup silently died.

The engines that run on a device (``fluid``, ``serving_torch``) run on
``--device``: ``cuda`` by default, which raises without a card as every
entry point does; ``--device cpu`` runs their plain versions.
'''

#: file -> the substitutions applied, in order, after the import prefix;
#: each ``old`` occurs exactly once when it is applied
EDITS = {
    "__init__.py": [
        ("AST linter over ``src/repro``", "AST linter over ``src/repro_torch``"),
        ("quick scenario\n                                          per engine under "
         "JAX tracer-leak\n                                          checking, plus a "
         "sweep_cube\n",
         "quick scenario\n                                          per engine, plus a "
         "sweep_cube\n"),
    ],
    "harvest.py": [
        ('SERVING_JAX_REL = "runtime/serving_jax.py"',
         '#: the serving program the traced-name harvest reads (the twin of\n'
         '#: ``runtime/serving_jax.py``)\n'
         'SERVING_JAX_REL = "runtime/serving_torch.py"\n'
         '#: where the plain fleet program stacks its per-tick event counts\n'
         'EV_COUNTS_REL = "kernels/serving_fleet/ref.py"'),
    ],
    "rules.py": [
        ("RUNNER_REL, SERVING_JAX_REL, dotted,",
         "RUNNER_REL, SERVING_JAX_REL,\n"
         "                                          EV_COUNTS_REL, dotted,"),
        ("        sjx = ctx.file(SERVING_JAX_REL)\n        if sjx is not None:\n"
         "            arity = harvest_ev_counts_arity(sjx)\n            if arity is None:\n"
         "                out.append(Finding(SERVING_JAX_REL, 1, self.id,",
         "        sjx = ctx.file(EV_COUNTS_REL)\n        if sjx is not None:\n"
         "            arity = harvest_ev_counts_arity(sjx)\n            if arity is None:\n"
         "                out.append(Finding(EV_COUNTS_REL, 1, self.id,"),
        ("                    SERVING_JAX_REL, arity[1], self.id,",
         "                    EV_COUNTS_REL, arity[1], self.id,"),
        ("repo_root = fixtures_root().parents[1]  # src/repro\n",
         "repo_root = fixtures_root().parents[1]  # src/repro_torch\n"),
    ],
    "lint.py": [
        ("# lint src/repro\n", "# lint src/repro_torch\n"),
        ('description="invariant linter for src/repro (see ROADMAP "',
         'description="invariant linter for src/repro_torch (see ROADMAP "'),
    ],
    "sanitize.py": [
        (_SANITIZE_DOC, _SANITIZE_DOC_PORT),
        ('DEFAULT_ENGINES = ("des", "fluid", "serving", "serving_jax")',
         'DEFAULT_ENGINES = ("des", "fluid", "serving", "serving_torch")\n'
         '#: the engines that take a ``device``\n'
         'DEVICE_ENGINES = ("fluid", "serving_torch")'),
        ('def _enable_leak_check() -> None:\n    import jax\n\n'
         '    jax.config.update("jax_check_tracer_leaks", True)\n\n\n', ''),
        ("                seed: int) -> List[str]:\n"
         '    """One scenario per engine under tracer-leak checking; returns',
         "                seed: int, device: str = \"cuda\") -> List[str]:\n"
         '    """One scenario per engine; returns'),
        ("            rr = run(scenario, engine=engine, quick=quick, seed=seed)",
         "            kw = {\"device\": device} if engine in DEVICE_ENGINES else {}\n"
         "            rr = run(scenario, engine=engine, quick=quick, seed=seed, **kw)"),
        ("f\"check_tracer_leaks ({time.perf_counter() - t0:.1f}s)\")",
         "f\"{device if engine in DEVICE_ENGINES else 'the host'} \"\n"
         "                  f\"({time.perf_counter() - t0:.1f}s)\")"),
        ("ran clean under \"\n", "ran clean on \"\n"),
        ("def check_no_retrace(scenario: str, *, quick: bool, seed: int) -> List[str]:\n"
         '    """Identical back-to-back serving_jax sweeps',
         "def check_no_retrace(scenario: str, *, quick: bool, seed: int,\n"
         "                     device: str = \"cuda\") -> List[str]:\n"
         '    """Identical back-to-back serving_torch sweeps'),
        ("from repro_torch.runtime import serving_jax\n",
         "from repro_torch.runtime import serving_torch\n"),
        ('snap.get("serving_jax.jit_cache_miss", 0),\n'
         '                snap.get("serving_jax.jit_cache_hit", 0))',
         'snap.get("serving_torch.jit_cache_miss", 0),\n'
         '                snap.get("serving_torch.jit_cache_hit", 0))'),
        ('    sweep(scenario, RETRACE_GRID, engine="serving_jax", quick=quick,\n'
         '          seed=seed)\n    miss_warm',
         '    sweep(scenario, RETRACE_GRID, engine="serving_torch", quick=quick,\n'
         '          seed=seed, device=device)\n    miss_warm'),
        ('    sweep(scenario, RETRACE_GRID, engine="serving_jax", quick=quick,\n'
         '          seed=seed)\n    miss_again',
         '    sweep(scenario, RETRACE_GRID, engine="serving_torch", quick=quick,\n'
         '          seed=seed, device=device)\n    miss_again'),
        ("phase = serving_jax.last_run_obs()", "phase = serving_torch.last_run_obs()"),
        ('print(f"ok   serving_jax: warm', 'print(f"ok   serving_torch: warm'),
        ('description="runtime sanitizer: engines under tracer-leak "\n'
         '                    "checking + serving_jax no-retrace assert")',
         'description="runtime sanitizer: every engine\'s RunResult "\n'
         '                    "+ serving_torch no-retrace assert")'),
        ('    ap.add_argument("--no-leak-check", action="store_true",\n'
         '                    help="skip jax_check_tracer_leaks (debug escape "\n'
         '                         "hatch; the retrace assert still runs)")\n',
         '    ap.add_argument("--device", default="cuda",\n'
         '                    help="device of the fluid and serving_torch engines "\n'
         '                         "(cuda by default; cpu runs their plain versions)")\n'),
        ("    if not args.no_leak_check:\n        _enable_leak_check()\n",
         "    from repro_torch.device import resolve_device\n\n"
         "    device = str(resolve_device(args.device))\n"),
        ("    failures = run_engines(args.scenario, engines, quick=args.quick,\n"
         "                           seed=args.seed)\n"
         '    if not args.skip_retrace and "serving_jax" in engines:\n'
         "        failures += check_no_retrace(args.scenario, quick=args.quick,\n"
         "                                     seed=args.seed)",
         "    failures = run_engines(args.scenario, engines, quick=args.quick,\n"
         "                           seed=args.seed, device=device)\n"
         '    if not args.skip_retrace and "serving_torch" in engines:\n'
         "        failures += check_no_retrace(args.scenario, quick=args.quick,\n"
         "                                     seed=args.seed, device=device)"),
    ],
    "docs_smoke.py": [
        ('"""Docs-freshness smoke: execute the README\'s fenced ``bash`` blocks.',
         '"""Docs-freshness smoke: execute the fenced ``bash`` blocks of the\n'
         'README\'s PyTorch/CUDA port section (``SECTION``).'),
        ("    (r\"-m\\s+repro\\.launch\\.smoke\", \"scenario catalog has its own CI job\"),\n"
         "    (r\"-m\\s+repro\\.analysis\\.sanitize\", \"sanitizer runs in scenario-smoke\"),\n",
         "    (r\"-m\\s+repro_torch\\.launch\\.smoke\", \"scenario catalog has its own CI job\"),\n"
         "    (r\"-m\\s+repro_torch\\.analysis\\.sanitize\", \"sanitizer runs in scenario-smoke\"),\n"
         "    (r\"chip_smoke|test_torch_gpu\", \"needs an H100\"),\n"),
        ("def extract_commands(md_text: str)",
         "#: the README section whose commands the port's smoke runs\n"
         "SECTION = \"## PyTorch/CUDA port\"\n\n\n"
         "def port_section(md_text: str) -> str:\n"
         "    \"\"\"The text of ``SECTION``, up to the next level-2 heading.\"\"\"\n"
         "    start = md_text.index(SECTION)\n"
         "    end = md_text.find(\"\\n## \", start + len(SECTION))\n"
         "    return md_text[start:] if end < 0 else md_text[start:end]\n\n\n"
         "def extract_commands(md_text: str)"),
        ("commands = extract_commands(md.read_text())",
         "commands = extract_commands(port_section(md.read_text()))"),
    ],
}
COPIES = ("core.py", "baseline.txt", "fixtures/determinism_bad.py",
          "fixtures/determinism_clean.py", "fixtures/obs_hygiene_bad.py",
          "fixtures/obs_hygiene_clean.py", "fixtures/static_shape_bad.py",
          "fixtures/schema_drift_tree/core/engine.py",
          "fixtures/schema_drift_tree/obs/events.py",
          "fixtures/schema_drift_tree/analysis/locks/event_types.lock",
          "locks/event_types.lock")
#: files the port keeps under another path (the fixture tree mirrors the
#: port's layout: its event-count stack lives in the plain fleet program)
MOVED = {"fixtures/schema_drift_tree/kernels/serving_fleet/ref.py":
         "fixtures/schema_drift_tree/runtime/serving_jax.py"}


def port_text(rel: str) -> str:
    """The reference file's text with the prefix and ``EDITS[rel]``."""
    want = re.sub(r"\brepro\.", "repro_torch.", (REF / MOVED.get(rel, rel)).read_text())
    for old, new in EDITS.get(rel, ()):
        assert want.count(old) == 1, (rel, old)
        want = want.replace(old, new)
    return want


def _run(*args, timeout=300):
    return subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          timeout=timeout, cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1"))


@pytest.mark.parametrize("rel", sorted(COPIES + tuple(EDITS) + tuple(MOVED)))
def test_copy_equals_reference_but_for_the_prefix_and_named_edits(rel):
    assert (PORT / rel).read_text() == port_text(rel)


def test_port_analysis_files_are_the_copies():
    got = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*")
           if p.is_file() and "__pycache__" not in p.parts}
    assert got == set(COPIES) | set(EDITS) | set(MOVED)


def test_lint_self_test_flags_every_fixture():
    out = _run("repro_torch.analysis.lint", "--self-test")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "FAIL" not in out.stdout
    rules = {line.split()[1].rstrip(":") for line in out.stdout.splitlines()
             if line.startswith("ok")}
    assert rules == {"determinism", "obs-hygiene", "registry-parity", "schema-drift",
                     "static-shape"}


def test_all_five_rules_over_the_port_find_nothing():
    out = _run("repro_torch.analysis.lint")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s) from 5 rule(s)" in out.stdout, out.stdout


def test_no_rule_passes_vacuously():
    """What each rule reads over ``src/repro_torch`` is there: the files
    the determinism and obs-hygiene rules walk, the traced names, the event
    schema with its lock, the event-count stack with one column a type and
    the engines that emit them, and the four engines' registries."""
    from repro_torch.analysis import harvest, rules
    from repro_torch.analysis.core import LintContext
    from repro_torch.analysis.lint import PACKAGE_ROOT

    ctx = LintContext.from_root(PACKAGE_ROOT)
    assert len(ctx.files) > 100
    assert {"threshold", "max_transient", "max_slots"} <= harvest.harvest_traced_names(ctx)
    types, _ = harvest.harvest_event_types(ctx.file(harvest.EVENTS_REL))
    assert len(types) == 10
    assert (PACKAGE_ROOT / harvest.LOCK_REL).read_text().split("\n", 2)[2].split() == types
    arity, _ = harvest.harvest_ev_counts_arity(ctx.file(harvest.EV_COUNTS_REL))
    assert arity == len(types)
    emitted = set()
    for rel in harvest.ENGINE_RELS:
        emitted |= harvest.harvest_emitted_types(ctx.file(rel), set(types))
    assert emitted == set(types)
    gathered = rules.RegistryParityRule()._gather()
    assert gathered["engines"] == {"des", "fluid", "serving", "serving_torch"}
    assert gathered["engines"] <= gathered["required_series"]
    assert len(gathered["scenarios"]) == 20 and gathered["short_policies"]
    assert sum(1 for sf in ctx.files for line in sf.lines
               if ".emit(" in line and "recorder" in line) > 0


def test_sanitize_on_the_cpu_exits_0():
    out = _run("repro_torch.analysis.sanitize", "--device", "cpu", "--quick")
    assert out.returncode == 0, out.stdout + out.stderr
    for engine in ("des", "fluid", "serving", "serving_torch"):
        assert f"ok   {engine}: serve_flash_crowd ran clean" in out.stdout, out.stdout
    assert "ok   serving_torch: warm identical sweep was a pure cache hit" in out.stdout
    assert "0 failure(s) (4 engine(s)" in out.stdout


def test_docs_smoke_lists_the_ports_commands():
    out = _run("repro_torch.analysis.docs_smoke", "--list", timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
    runs = [line for line in out.stdout.splitlines() if line.startswith("RUN")]
    assert runs and all("repro_torch" in line for line in runs), out.stdout
    assert any("repro_torch.analysis.lint" in line for line in runs)
    assert any("repro_torch.launch.dryrun" in line and "--trace" in line for line in runs)
    assert "-m repro." not in out.stdout

"""CLI driver: ``python -m repro_torch.analysis.lint``.

Exit code 0 means every invariant holds; any unsuppressed, unbaselined
finding (or a fixture self-test failure under ``--self-test``) exits 1 —
CI gates on it. Typical invocations::

    PYTHONPATH=src python -m repro_torch.analysis.lint              # lint src/repro_torch
    PYTHONPATH=src python -m repro_torch.analysis.lint --self-test  # fixture gate
    PYTHONPATH=src python -m repro_torch.analysis.lint --update-locks
    PYTHONPATH=src python -m repro_torch.analysis.lint --rules determinism,obs-hygiene

Suppress a single site with ``# lint: disable=<rule-id>`` on the line;
grandfather a finding by adding its ``path:rule:line`` signature to
``analysis/baseline.txt`` (committed empty — prefer fixing or suppressing
at the site, where the exception is visible in review).
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from typing import List, Optional, Sequence

from repro_torch.analysis import rules as _rules  # noqa: F401  (registers RULES)
from repro_torch.analysis.core import (Finding, LintContext, RULES, load_baseline)
from repro_torch.analysis.harvest import EVENTS_REL, LOCK_REL, harvest_event_types

#: the default lint root: the repro package this file lives in
PACKAGE_ROOT = pathlib.Path(__file__).resolve().parents[1]
BASELINE_REL = "analysis/baseline.txt"


def run_lint(root: pathlib.Path, *, rule_ids: Optional[Sequence[str]] = None,
             baseline: Optional[pathlib.Path] = None,
             ast_only: bool = False) -> List[Finding]:
    """Run the (selected) rules over ``root`` and return the findings that
    survive in-place suppressions and the baseline file."""
    ctx = LintContext.from_root(root)
    findings: List[Finding] = list(ctx.parse_findings)
    for rule_id, rule_cls in sorted(RULES.items()):
        if rule_ids is not None and rule_id not in rule_ids:
            continue
        if ast_only and rule_cls.requires_import:
            continue
        findings.extend(rule_cls().run(ctx))
    baseline_sigs = load_baseline(
        baseline if baseline is not None else root / BASELINE_REL)
    kept = []
    for f in findings:
        sf = ctx.file(f.path)
        if sf is not None and sf.is_suppressed(f.line, f.rule):
            continue
        if f.signature() in baseline_sigs:
            continue
        kept.append(f)
    return sorted(kept, key=lambda f: (f.path, f.line, f.rule))


def update_locks(root: pathlib.Path) -> pathlib.Path:
    """Regenerate ``analysis/locks/event_types.lock`` from the current
    ``EVENT_TYPES`` literal — the one sanctioned way to grow the schema."""
    ctx = LintContext.from_root(root)
    sf = ctx.file(EVENTS_REL)
    harvested = harvest_event_types(sf) if sf is not None else None
    if harvested is None:
        raise SystemExit(f"cannot harvest EVENT_TYPES from "
                         f"{root / EVENTS_REL}")
    names, _ = harvested
    path = root / LOCK_REL
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(
        "# append-only lock of obs.events.EVENT_TYPES (column index = "
        "on-disk schema).\n"
        "# regenerate ONLY when appending a type:  python -m "
        "repro_torch.analysis.lint --update-locks\n"
        + "".join(f"{n}\n" for n in names))
    return path


def run_self_tests(verbose: bool = True) -> int:
    """Every rule must flag its seeded-violation fixtures and stay quiet
    on its clean ones; a rule whose self-test crashes fails the gate."""
    failures = 0
    for rule_id, rule_cls in sorted(RULES.items()):
        try:
            cases = rule_cls().self_test()
        except Exception as exc:  # the gate must report, not crash
            failures += 1
            print(f"FAIL {rule_id}: self-test raised {exc!r}")
            continue
        for case, ok, detail in cases:
            if not ok:
                failures += 1
            if verbose or not ok:
                print(f"{'ok  ' if ok else 'FAIL'} {rule_id}: "
                      f"{case} ({detail})")
    return 0 if failures == 0 else 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="invariant linter for src/repro_torch (see ROADMAP "
                    "'repro/analysis')")
    ap.add_argument("--root", type=pathlib.Path, default=PACKAGE_ROOT,
                    help="package root to lint (default: the installed "
                         "repro package)")
    ap.add_argument("--rules", help="comma-separated rule ids to run "
                                    "(default: all)")
    ap.add_argument("--baseline", type=pathlib.Path,
                    help=f"baseline file (default: <root>/{BASELINE_REL})")
    ap.add_argument("--ast-only", action="store_true",
                    help="skip rules that import the repo (registry "
                         "parity) — pure-AST mode")
    ap.add_argument("--self-test", action="store_true",
                    help="run every rule against its seeded-violation "
                         "fixtures instead of linting")
    ap.add_argument("--update-locks", action="store_true",
                    help="regenerate analysis/locks/event_types.lock from "
                         "the current EVENT_TYPES")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule registry and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule_id, rule_cls in sorted(RULES.items()):
            print(f"{rule_id:16s} {rule_cls.description}")
        return 0
    if args.update_locks:
        print(f"wrote {update_locks(args.root)}")
        return 0
    if args.self_test:
        return run_self_tests()

    rule_ids = ([r.strip() for r in args.rules.split(",") if r.strip()]
                if args.rules else None)
    if rule_ids:
        unknown = set(rule_ids) - set(RULES)
        if unknown:
            print(f"unknown rule ids: {sorted(unknown)} "
                  f"(known: {sorted(RULES)})")
            return 2
    findings = run_lint(args.root, rule_ids=rule_ids,
                        baseline=args.baseline, ast_only=args.ast_only)
    for f in findings:
        print(f.render())
    n_rules = len(rule_ids) if rule_ids else len(RULES)
    print(f"{len(findings)} finding(s) from {n_rules} rule(s) "
          f"over {args.root}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())

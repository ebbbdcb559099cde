"""Static analysis & runtime sanitation for the repro codebase.

Every past cross-engine divergence bug violated a rule that was already
written down prose-only in ROADMAP (static-shape discipline, determinism,
append-only event schema, registry parity, guarded emit sites). This
package makes those rules machine-checkable and CI-gated:

  ``python -m repro_torch.analysis.lint``       AST linter over ``src/repro_torch``
  ``python -m repro_torch.analysis.lint --self-test``
                                          every rule must flag its seeded
                                          violation fixtures
  ``python -m repro_torch.analysis.sanitize``   runtime sanitizer: quick scenario
                                          per engine, plus a sweep_cube
                                          no-retrace-after-warmup assert

Rules are small visitor classes registered in :data:`~repro_torch.analysis.core.RULES`
(see ``rules.py``); findings carry ``file:line`` + rule id and can be
suppressed in place with ``# lint: disable=<rule-id>`` or grandfathered in
``analysis/baseline.txt`` (committed empty — keep it that way). The
append-only event schema is pinned by ``analysis/locks/event_types.lock``;
regenerate after appending a type with ``--update-locks``.
"""

# NOTE: lint.py / sanitize.py are imported lazily (``python -m ...``), not
# re-exported here — importing them at package level trips runpy's
# double-import warning when the module is also the __main__ entry point.
from repro_torch.analysis.core import (Finding, LintContext, Rule,  # noqa: F401
                                 RULES, register_rule)

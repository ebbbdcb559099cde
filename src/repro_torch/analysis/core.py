"""Rule framework for the invariant linter: parsed-source model, findings,
suppressions, baseline, and the pluggable ``RULES`` registry.

A rule is a class with an ``id``, a ``description``, a ``run(ctx)`` method
returning :class:`Finding` objects, and a ``self_test()`` returning
``(case, ok, detail)`` triples exercised by ``lint --self-test`` against
the seeded-violation fixtures in ``analysis/fixtures/``. Register with
``@register_rule`` — the CLI discovers rules through the registry only, so
a new rule is one class + one fixture, no driver changes.
"""

from __future__ import annotations

import ast
import pathlib
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple, Type

#: in-place suppression: ``some_call()  # lint: disable=determinism`` (comma
#: separated ids, or ``all`` to silence every rule on that line)
_SUPPRESS_RE = re.compile(r"#\s*lint:\s*disable=([A-Za-z0-9_\-, ]+)")

#: subtrees of the lint root that are never linted (the fixtures *are*
#: seeded violations; __pycache__ is not source)
EXCLUDE_PARTS = ("fixtures", "__pycache__")


@dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a source line."""

    path: str      # path relative to the lint root, posix separators
    line: int      # 1-indexed; 1 for whole-file/project findings
    rule: str      # rule id (also the suppression token)
    message: str

    def signature(self) -> str:
        """Stable identity used by the baseline file."""
        return f"{self.path}:{self.rule}:{self.line}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] {self.message} "
                f"(suppress with `# lint: disable={self.rule}`)")


class SourceFile:
    """A parsed module: text, AST, per-line suppression sets, parent map."""

    def __init__(self, root: pathlib.Path, path: pathlib.Path) -> None:
        self.path = path
        self.rel = path.relative_to(root).as_posix()
        self.text = path.read_text()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=str(path))
        self.suppressed: Dict[int, Set[str]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                self.suppressed[i] = {tok.strip() for tok in
                                      m.group(1).split(",") if tok.strip()}
        self._parents: Optional[Dict[ast.AST, ast.AST]] = None

    def parents(self) -> Dict[ast.AST, ast.AST]:
        """Child -> parent node map (built lazily, cached)."""
        if self._parents is None:
            self._parents = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    self._parents[child] = node
        return self._parents

    def is_suppressed(self, line: int, rule: str) -> bool:
        toks = self.suppressed.get(line, ())
        return rule in toks or "all" in toks

    def finding(self, node_or_line, rule: str, message: str) -> Finding:
        line = (node_or_line if isinstance(node_or_line, int)
                else getattr(node_or_line, "lineno", 1))
        return Finding(self.rel, int(line), rule, message)


class LintContext:
    """The lint root plus every parsed source file under it. Files that do
    not parse surface as ``parse-error`` findings instead of crashing the
    run (a syntax error must fail the gate, not the linter)."""

    def __init__(self, root: pathlib.Path, files: List[SourceFile],
                 parse_findings: List[Finding]) -> None:
        self.root = root
        self.files = files
        self.parse_findings = parse_findings
        self._by_rel = {sf.rel: sf for sf in files}
        self.cache: Dict[str, object] = {}  # cross-rule harvest cache

    @classmethod
    def from_root(cls, root: pathlib.Path) -> "LintContext":
        root = pathlib.Path(root).resolve()
        files: List[SourceFile] = []
        parse_findings: List[Finding] = []
        for path in sorted(root.rglob("*.py")):
            rel_parts = path.relative_to(root).parts
            if any(part in EXCLUDE_PARTS for part in rel_parts):
                continue
            try:
                files.append(SourceFile(root, path))
            except SyntaxError as exc:
                parse_findings.append(Finding(
                    path.relative_to(root).as_posix(),
                    int(exc.lineno or 1), "parse-error",
                    f"does not parse: {exc.msg}"))
        return cls(root, files, parse_findings)

    def file(self, rel: str) -> Optional[SourceFile]:
        return self._by_rel.get(rel)


class Rule:
    """Base class: subclass, set ``id``/``description``, implement
    ``run``; import-needing rules (registry parity) set
    ``requires_import`` so ``--ast-only`` can skip them."""

    id: str = "?"
    description: str = "?"
    requires_import: bool = False

    def run(self, ctx: LintContext) -> List[Finding]:
        raise NotImplementedError

    def self_test(self) -> List[Tuple[str, bool, str]]:
        raise NotImplementedError


#: rule id -> rule class; populated by @register_rule in rules.py
RULES: Dict[str, Type[Rule]] = {}


def register_rule(cls: Type[Rule]) -> Type[Rule]:
    if cls.id in RULES:
        raise ValueError(f"rule {cls.id!r} already registered")
    RULES[cls.id] = cls
    return cls


def load_baseline(path: pathlib.Path) -> Set[str]:
    """Grandfathered finding signatures (``path:rule:line`` per line);
    ``#`` comments and blank lines are ignored. Committed empty — the
    satellites fixed every pre-existing finding."""
    if not path.exists():
        return set()
    out: Set[str] = set()
    for line in path.read_text().splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            out.add(line)
    return out


def expected_bad_lines(sf: SourceFile) -> Set[int]:
    """Fixture convention: every line a rule must flag ends with a
    ``# BAD`` marker, so a fixture documents its own expected findings
    (end-anchored: prose mentions of the marker don't count)."""
    return {i for i, line in enumerate(sf.lines, start=1)
            if re.search(r"#\s*BAD\s*$", line)}


def check_fixture(rule: Rule, ctx: LintContext, sf: SourceFile
                  ) -> Tuple[bool, str]:
    """Run ``rule`` on a one-file fixture context and compare flagged lines
    against the fixture's ``# BAD`` markers (exact set match)."""
    got = {f.line for f in rule.run(ctx)
           if f.path == sf.rel and not sf.is_suppressed(f.line, f.rule)}
    want = expected_bad_lines(sf)
    if got == want:
        return True, f"{len(want)} seeded violations flagged"
    return False, (f"flagged lines {sorted(got)} != "
                   f"expected {sorted(want)}")


def fixtures_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent / "fixtures"


def fixture_context(*names: str) -> Tuple[LintContext, List[SourceFile]]:
    """A context rooted at ``analysis/fixtures`` restricted to ``names``
    (relative posix paths) — lets self-tests lint seeded-violation files
    that the normal run excludes."""
    root = fixtures_root()
    files = [SourceFile(root, root / name) for name in names]
    ctx = LintContext(root, files, [])
    return ctx, files

"""Docs-freshness smoke: execute the fenced ``bash`` blocks of the
README's PyTorch/CUDA port section (``SECTION``).

READMEs rot: a flag gets renamed, a module moves, and the quickstart breaks
silently while tests stay green. This tool closes that gap the same way the
rest of ``repro_torch.analysis`` closes invariant gaps — mechanically, in CI:

  * every fenced ```` ```bash ```` block of the target markdown file is
    parsed in document order; backslash continuations are joined, pure
    comment lines dropped, trailing ``  # why`` annotations stripped;
  * commands matching a **skip policy** are reported but not run — suites
    already gated by their own CI job (pytest, benchmarks, scenario smoke,
    sanitizer) and commands that cost minutes of real model decode. Skips
    are printed with their reason, never silent;
  * the rest run sequentially from the repo root with a per-command timeout
    (document order matters: the Perfetto ``--check`` command validates the
    trace an earlier command wrote).

Exit code is the gate: any executed command failing or timing out fails CI.

Usage: PYTHONPATH=src python -m repro_torch.analysis.docs_smoke
           [--file README.md] [--timeout 300] [--list]
"""

from __future__ import annotations

import argparse
import pathlib
import re
import subprocess
import sys
import time
from typing import List, Optional, Sequence, Tuple

ROOT = pathlib.Path(__file__).resolve().parents[3]

#: (pattern, reason) — matched against the full command line. These are
#: documented *as runnable* and stay in the README; they are skipped here
#: because they already gate CI elsewhere or take minutes by design.
SKIP_POLICY: List[Tuple[str, str]] = [
    (r"^pip\s+install", "dependency install, not a repo command"),
    (r"-m\s+pytest", "tier-1 suite runs in its own CI job"),
    (r"-m\s+benchmarks\.", "benchmark suite gated in the tier1 CI job"),
    (r"-m\s+repro_torch\.launch\.smoke", "scenario catalog has its own CI job"),
    (r"-m\s+repro_torch\.analysis\.sanitize", "sanitizer runs in scenario-smoke"),
    (r"chip_smoke|test_torch_gpu", "needs an H100"),
    (r"serve_multitenant|serve_bursty", "minutes of real model decode"),
]


#: the README section whose commands the port's smoke runs
SECTION = "## PyTorch/CUDA port"


def port_section(md_text: str) -> str:
    """The text of ``SECTION``, up to the next level-2 heading."""
    start = md_text.index(SECTION)
    end = md_text.find("\n## ", start + len(SECTION))
    return md_text[start:] if end < 0 else md_text[start:end]


def extract_commands(md_text: str) -> List[Tuple[int, str]]:
    """-> [(1-based line number of the command's first line, command)] from
    every fenced ```bash block, continuations joined, comments stripped."""
    out: List[Tuple[int, str]] = []
    in_bash = False
    pending: Optional[Tuple[int, str]] = None

    def flush():
        nonlocal pending
        if pending is not None:
            lineno, cmd = pending
            cmd = re.sub(r"\s+#\s.*$", "", cmd).strip()
            if cmd:
                out.append((lineno, cmd))
            pending = None

    for i, raw in enumerate(md_text.splitlines(), start=1):
        stripped = raw.strip()
        if stripped.startswith("```"):
            flush()
            in_bash = stripped[3:].strip() == "bash" and not in_bash
            continue
        if not in_bash:
            continue
        if not stripped or stripped.startswith("#"):
            flush()
            continue
        if pending is not None:  # previous line ended in a backslash
            lineno, prev = pending
            pending = None
            stripped = f"{prev} {stripped}"
            i = lineno
        if stripped.endswith("\\"):
            pending = (i, stripped[:-1].strip())
        else:
            pending = (i, stripped)
            flush()
    flush()
    return out


def skip_reason(cmd: str) -> Optional[str]:
    for pat, reason in SKIP_POLICY:
        if re.search(pat, cmd):
            return reason
    return None


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--file", default=str(ROOT / "README.md"))
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="per-command timeout in seconds")
    ap.add_argument("--list", action="store_true",
                    help="print the RUN/SKIP plan without executing")
    args = ap.parse_args(argv)

    md = pathlib.Path(args.file)
    commands = extract_commands(port_section(md.read_text()))
    if not commands:
        print(f"FAIL: no fenced bash commands found in {md}")
        return 1

    n_fail = n_run = n_skip = 0
    for lineno, cmd in commands:
        where = f"{md.name}:{lineno}"
        reason = skip_reason(cmd)
        if reason is not None:
            n_skip += 1
            print(f"SKIP {where}: {cmd}\n     ({reason})")
            continue
        if args.list:
            print(f"RUN  {where}: {cmd}")
            continue
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, shell=True, cwd=ROOT,
                                  capture_output=True, text=True,
                                  timeout=args.timeout)
            dt = time.perf_counter() - t0
            ok = proc.returncode == 0
        except subprocess.TimeoutExpired:
            dt, ok, proc = args.timeout, False, None
        n_run += 1
        n_fail += not ok
        print(f"{'pass' if ok else 'FAIL'} {where} [{dt:.1f}s]: {cmd}")
        if not ok:
            if proc is None:
                print(f"     timed out after {args.timeout:.0f}s")
            else:
                tail = (proc.stdout + proc.stderr).strip().splitlines()[-12:]
                for ln in tail:
                    print(f"     {ln}")
    if args.list:
        print(f"{len(commands) - n_skip} to run, {n_skip} skipped")
        return 0
    if n_fail:
        print(f"FAIL: {n_fail}/{n_run} README commands broken "
              f"({n_skip} skipped by policy)")
        return 1
    print(f"PASS: {n_run} README commands ran clean ({n_skip} skipped "
          f"by policy)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""First-party line-coverage report for the lzma_rs_tpu_torch package.

A copy of the JAX package's ``tools/coverage_report.py`` over the port's
package root: without coverage.py, it collects line events with
sys.monitoring (PEP 669, the machinery the coverage-guided fuzz tier of
``tests/test_torch_fuzz_mutation.py`` uses) while running the port's
tests, and reports per-module executed/executable line percentages.
Lines that run only on the card (the kernels' launches) show as missed
on a machine without one.

Usage (run by hand, from the repository's root; not part of tier-1):
    python -m lzma_rs_tpu_torch.tools.coverage_report [--min PCT]
        [pytest args...]

Default pytest args: the port's tests, ``tests/test_torch_*.py -q -m
"not slow"``. Exits non-zero when the tests fail or total coverage falls
below --min.

Executable lines are derived from each module's code objects
(``co_lines``), recursively over nested functions/classes — the same
definition coverage.py uses for statement coverage.
"""

from __future__ import annotations

import glob
import os
import sys

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG_ROOT)

_hits: dict[str, set[int]] = {}


def _on_line(code, line):
    fn = code.co_filename
    if "/lzma_rs_tpu_torch/" not in fn:
        return sys.monitoring.DISABLE
    _hits.setdefault(fn, set()).add(line)


def _executable_lines(path: str) -> set[int]:
    with open(path) as f:
        src = f.read()
    try:
        top = compile(src, path, "exec")
    except SyntaxError:
        return set()
    lines: set[int] = set()
    stack = [top]
    while stack:
        code = stack.pop()
        for _, _, ln in code.co_lines():
            if ln is not None:
                lines.add(ln)
        for const in code.co_consts:
            if hasattr(const, "co_lines"):
                stack.append(const)
    return lines


def main() -> int:
    """Run pytest under the line tracer and print the report."""
    sys.path.insert(0, REPO)
    args = sys.argv[1:]
    min_pct = 0.0
    if args and args[0] == "--min":
        min_pct = float(args[1])
        args = args[2:]
    if not args:
        args = sorted(glob.glob(os.path.join(REPO, "tests",
                                             "test_torch_*.py")))
        args += ["-q", "-m", "not slow"]

    mon = sys.monitoring
    tool = mon.COVERAGE_ID
    mon.use_tool_id(tool, "lzma_rs_tpu_torch-coverage")
    mon.register_callback(tool, mon.events.LINE, _on_line)
    mon.set_events(tool, mon.events.LINE)

    import pytest

    rc = pytest.main(args)

    mon.set_events(tool, 0)
    mon.free_tool_id(tool)

    rows = []
    tot_exec = tot_hit = 0
    for root, _dirs, files in os.walk(PKG_ROOT):
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            exe = _executable_lines(path)
            if not exe:
                continue
            hit = _hits.get(path, set()) & exe
            rel = os.path.relpath(path, os.path.dirname(PKG_ROOT))
            rows.append((rel, len(hit), len(exe)))
            tot_exec += len(exe)
            tot_hit += len(hit)

    width = max(len(r[0]) for r in rows) if rows else 20
    for rel, hit, exe in rows:
        print(f"{rel:<{width}}  {hit:>5}/{exe:<5}  {100 * hit / exe:5.1f}%")
    total_pct = 100 * tot_hit / max(tot_exec, 1)
    print(f"{'TOTAL':<{width}}  {tot_hit:>5}/{tot_exec:<5}  "
          f"{total_pct:5.1f}%")

    if rc != 0:
        return int(rc)
    if total_pct < min_pct:
        print(f"coverage {total_pct:.1f}% below gate {min_pct:.1f}%")
        return 3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

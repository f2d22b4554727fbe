#!/usr/bin/env python3
"""Where a pytest run's seconds went, from its JUnit file; or two runs'.

    python3 port_test_times.py RUN.xml              # one run
    python3 port_test_times.py PARENT.xml CHANGE.xml  # and CHANGE / PARENT

A JUnit file is what ``pytest --junitxml=FILE`` writes. A case's seconds
are its setup, call and teardown (pytest's default ``junit_duration_report``),
so a module fixture's cost falls on the first case that asks for it; under
``pytest-xdist`` they are a worker's seconds. Prints:

- the run's wall seconds (the test suite's ``time``);
- the summed seconds of the port's files (``tests/test_torch_port_*.py``)
  and of the rest, and the count of cases;
- the seconds of each port file, heaviest first;
- the 20 heaviest cases, wherever they are.

With two files each figure also has the second run's and the ratio,
second over first; a file or case in one run only shows a dash for the
other. It reads the files and nothing else; the way to measure the suite
from a cold XLA:CPU compile cache is in README.md (the port's section).
"""

from __future__ import annotations

import sys
import xml.etree.ElementTree as ET

PORT_PREFIX = "test_torch_port_"
TOP_CASES = 20


def load(path: str) -> dict:
    """{'wall': seconds, 'cases': {id: seconds}} of one JUnit file; a
    case's id is ``file::name``, its file the module of its class name
    (``tests.test_x`` -> ``test_x``)."""
    root = ET.parse(path).getroot()
    suites = [root] if root.tag == "testsuite" else list(root.iter("testsuite"))
    wall = sum(float(s.get("time", 0.0)) for s in suites)
    cases = {}
    for case in root.iter("testcase"):
        module = case.get("classname", "").split(".")
        name = module[-1] if len(module) == 1 else module[1]
        cases[f"{name}::{case.get('name')}"] = float(case.get("time", 0.0))
    return {"wall": wall, "cases": cases}


def summary(run: dict) -> dict:
    """The run's wall, its port and other seconds, and seconds by port file."""
    files, port, rest = {}, 0.0, 0.0
    for case, secs in run["cases"].items():
        name = case.split("::")[0]
        if name.startswith(PORT_PREFIX):
            files[name] = files.get(name, 0.0) + secs
            port += secs
        else:
            rest += secs
    return {"wall": run["wall"], "port": port, "rest": rest, "cases": len(run["cases"]),
            "files": files}


def _cell(x) -> str:
    return f"{'-':>9}" if x is None else f"{x:9.1f}"


def _ratio(a, b) -> str:
    return "" if a is None or b is None or a == 0 else f"{b / a:7.3f}"


def report(runs: list[dict]) -> list[str]:
    """The lines to print for one run or two (parent, change)."""
    sums = [summary(r) for r in runs]
    two = len(runs) == 2
    head = "  run 1  " + ("    run 2    2/1" if two else "")
    lines = [head]

    def row(label, values):
        a = values[0]
        b = values[1] if two else None
        lines.append(_cell(a) + (f" {_cell(b)} {_ratio(a, b)}" if two else "") + f"  {label}")

    row("wall seconds", [s["wall"] for s in sums])
    row("port files' seconds", [s["port"] for s in sums])
    row("other files' seconds", [s["rest"] for s in sums])
    row("all files' seconds", [s["port"] + s["rest"] for s in sums])
    lines.append("cases: " + " / ".join(str(s["cases"]) for s in sums))
    lines.append("seconds by port file:")
    names = set().union(*(s["files"] for s in sums))
    for name in sorted(names, key=lambda n: -sums[0]["files"].get(n, 0.0)):
        row(name, [s["files"].get(name) for s in sums])
    lines.append(f"the {TOP_CASES} heaviest cases of run 1:")
    for case in sorted(runs[0]["cases"], key=lambda c: -runs[0]["cases"][c])[:TOP_CASES]:
        row(case, [r["cases"].get(case) for r in runs])
    if two:
        lines.append(f"the {TOP_CASES} heaviest cases of run 2:")
        for case in sorted(runs[1]["cases"], key=lambda c: -runs[1]["cases"][c])[:TOP_CASES]:
            row(case, [r["cases"].get(case) for r in runs])
    return lines


def main(argv: list[str]) -> int:
    if len(argv) not in (1, 2):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    for line in report([load(p) for p in argv]):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

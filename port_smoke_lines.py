#!/usr/bin/env python3
"""The check lines of two ``chip_smoke.py`` logs, side by side.

    python3 port_smoke_lines.py BEFORE.log AFTER.log

A check line is a line that ``chip_smoke.py`` prints for a check or a timed
row: every line but its JSON lines, its progress lines (``... done at ...``,
the build's total), the card's and the library's lines and the
interpreter's warnings and tracebacks. Its key is its label (the text
before its first ``": "``, which names the shape) and every limit it states
(``limit ...``, ``limits ...``, ``bar ...``), measured decimals replaced by
``#`` and the kernels' namespace names made the same across builds (an
anonymous namespace's name changes with each compilation). Prints the
count of check lines in each log and each key of BEFORE that AFTER lacks
(as often as it lacks it); exits 1 if there is one.
"""

from __future__ import annotations

import collections
import re
import sys

_SKIP = re.compile(r"^(\{|\s|Traceback|torch \d|kernels built in |phase \d+.* done at |"
                   r"NVIDIA |\w*Warning|warnings\.warn)")
# _ZN45_GLOBAL__N__113304e6_12_int8_conv_cu_b1e5feea9dw_kernel... and, for a
# source built as units, _ZN5int8k9dw_kernel...: both int8_conv's namespace
_ANON = re.compile(r"_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]{8}")
_NAMED = {"_ZN5int8k": "_ZN<int8_conv>", "_ZN5bneck": "_ZN<fused_bottleneck>",
          "_ZN6invres": "_ZN<fused_inv_residual>"}
_DECIMAL = re.compile(r"\d+\.\d+(?:e[-+]?\d+)?")
_LIMIT = re.compile(r"\b(?:limits?|bars?)\b[^;)]*")


def check_key(line: str):
    """The key of a check line, or None for another line."""
    line = line.rstrip("\n")
    if not line or _SKIP.match(line):
        return None
    line = _ANON.sub(lambda m: f"_ZN<{m.group(1)}>", line)
    for named, common in _NAMED.items():
        line = line.replace(named, common)
    label = line.split(": ", 1)[0]
    limits = tuple(_LIMIT.findall(line))
    return _DECIMAL.sub("#", label), limits


def check_lines(path: str) -> collections.Counter:
    with open(path, errors="replace") as f:
        return collections.Counter(k for k in map(check_key, f) if k is not None)


def main() -> int:
    before, after = (check_lines(p) for p in sys.argv[1:3])
    missing = before - after
    print(f"{sys.argv[1]}: {sum(before.values())} check lines; {sys.argv[2]}: "
          f"{sum(after.values())}; lines of the first without a counterpart in the second: "
          f"{sum(missing.values())}")
    for (label, limits), n in sorted(missing.items()):
        print(f"  missing x{n}: {label}" + (f" {list(limits)}" if limits else ""))
    return 1 if missing else 0


if __name__ == "__main__":
    sys.exit(main())

"""Share of the program's training pace in which the device ran nothing, in
%: 1 - (device busy time a step: the union of the device's spans in the
traced window over its steps) / (the device clock's time a step over an
untraced stretch of as many steps, CUDA events). The profiler's own host
cost, which slows the traced window's launches, stays out of it."""


def read(rec):
    if "steps" not in rec or not rec.get("pace_us") or not rec.get("busy_us"):
        return None
    return 100.0 * (1.0 - (rec["busy_us"] / rec["steps"])
                    / (rec["pace_us"] / rec["pace_units"]))

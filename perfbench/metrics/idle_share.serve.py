"""Share of the program's serving pace in which the device ran nothing, in
%: 1 - (device busy time a request: the union of the device's spans in the
traced window over its requests) / (the device clock's time a request over
an untraced stretch of as many requests, CUDA events). The profiler's own
host cost, which slows the traced window's launches, stays out of it."""


def read(rec):
    if "requests" not in rec or not rec.get("pace_us") or not rec.get("busy_us"):
        return None
    return 100.0 * (1.0 - (rec["busy_us"] / rec["requests"])
                    / (rec["pace_us"] / rec["pace_units"]))

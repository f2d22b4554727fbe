"""Device milliseconds a request spent in the focuser's backbone: the
device spans launched inside the ``focus`` ranges the traced run opens
around ``model.focuser.features``."""


def read(rec):
    busy = rec.get("range_busy_us", {}).get("focus")
    if "requests" not in rec or not busy:
        return None
    return busy / 1e3 / rec["requests"]

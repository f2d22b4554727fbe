"""Device milliseconds a request spent in the glancer's backbone: the
device spans launched inside the ``glance`` ranges the traced run opens
around ``model.glancer.features``."""


def read(rec):
    busy = rec.get("range_busy_us", {}).get("glance")
    if "requests" not in rec or not busy:
        return None
    return busy / 1e3 / rec["requests"]

"""Device milliseconds a training step spent from the step's ``classify``
mark to its ``backward`` mark (the backward pass), launch-attributed."""


def read(rec):
    busy = rec.get("range_busy_us", {}).get("backward")
    if "steps" not in rec or not busy:
        return None
    return busy / 1e3 / rec["steps"]

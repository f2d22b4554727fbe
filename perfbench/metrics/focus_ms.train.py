"""Device milliseconds a training step spent from the step's ``extract``
mark to its ``focus`` mark (the focuser's forward), launch-attributed."""


def read(rec):
    busy = rec.get("range_busy_us", {}).get("focus")
    if "steps" not in rec or not busy:
        return None
    return busy / 1e3 / rec["steps"]

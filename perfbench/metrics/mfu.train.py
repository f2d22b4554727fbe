"""The program's training rate, over an untraced stretch of as many steps as
are traced (the device's clock, CUDA events), times the reference's FLOPs
a video of the step (the frozen glance's forward, the trained part's
forward and backward), over the card's peak in the configuration's
precision, in %."""

from perfbench import peaks


def read(rec):
    if "steps" not in rec or not rec.get("pace_us") or "flops_per_video" not in rec:
        return None
    rate = rec["pace_units"] * rec["batch"] / (rec["pace_us"] / 1e6)
    return 100.0 * rec["flops_per_video"] * rate / peaks.FLOPS[rec["precision"]]

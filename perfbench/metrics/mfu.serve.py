"""The program's serving rate, over an untraced stretch of as many requests
as are traced (the device's clock, CUDA events), times the reference's
FLOPs a video, over the card's peak in the configuration's precision, in %."""

from perfbench import peaks


def read(rec):
    if "requests" not in rec or not rec.get("pace_us") or "flops_per_video" not in rec:
        return None
    rate = rec["pace_units"] * rec["batch"] / (rec["pace_us"] / 1e6)
    return 100.0 * rec["flops_per_video"] * rate / peaks.FLOPS[rec["precision"]]

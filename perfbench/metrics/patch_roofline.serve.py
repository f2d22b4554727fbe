"""The patch-extraction kernel's share of its roofline, in %: the bytes the
traced window's extractions must move (each patch element of every request
read once and written once, at the frames' element size) over the card's
memory bandwidth, divided by the device time of the kernel's launches. The
bound counts the requests' work, so the share stays the same however many
launches an implementation splits an extraction into."""

from perfbench import peaks


def read(rec):
    times = [d for name, ds in rec.get("kernels", {}).items() if "patch_kernel" in name
             for d in ds]
    if not times or "patch" not in rec or "requests" not in rec:
        return None
    bound_us = rec["requests"] * rec["patch"] / peaks.BYTES_PER_S * 1e6
    return 100.0 * bound_us / sum(times)

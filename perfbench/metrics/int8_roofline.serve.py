"""The int8 products' share of their roofline, in %: the least time of one
forward's int8 units (each max(bytes / 3.35 TB/s, operations / 1979 TOP/s),
int8 inputs and weights read once, int8 outputs written once) times the
traced requests, over the device time of the int8 kernels' launches
(``csrc/int8_conv.cu``, namespace ``int8k``: ``conv_kernel``, its
``splitk_finish``, ``dw_kernel``)."""

KERNELS = ("int8k::conv_kernel<", "int8k::splitk_finish", "int8k::dw_kernel")


def read(rec):
    times = [d for name, ds in rec.get("kernels", {}).items()
             if name.removeprefix("void ").startswith(KERNELS) for d in ds]
    if not times or "int8_bound_us" not in rec:
        return None
    return 100.0 * rec["requests"] * rec["int8_bound_us"] / sum(times)

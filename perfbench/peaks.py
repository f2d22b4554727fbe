"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W power limit): the denominators of every roofline and
utilization share the benchmark reports."""

FLOPS = {"bfloat16": 989e12, "int8": 1979e12}
BYTES_PER_S = 3.35e12

"""The kernels' build commands (adafocus_torch/ops/_kernels.py), on the CPU.

The CUDA sources compile only where ``nvcc`` is (the card's machine); what
is held here is the plan: one ``nvcc`` a source into its library, and a
source of ``PARTS`` compiled as one object a unit (its macro set to the
unit, ``-c`` without ``-shared``) and linked with every object into the one
library that the source's hash names; each such source's units cover each
kernel instance its entry points launch, once.
"""

import re

import pytest

from adafocus_torch.ops import _kernels


@pytest.mark.parametrize("name", sorted(_kernels.SIGNATURES))
def test_build_commands_of_each_source(name):
    out = "/build/lib.so"
    compiles, link = _kernels._commands("nvcc", name, out)
    src = str(_kernels.CSRC / f"{name}.cu")
    if name not in _kernels.PARTS:
        assert link is None
        assert compiles == [(["nvcc", *_kernels.NVCC_FLAGS, "-o", out, src], None)]
        return
    macro, units = _kernels.PARTS[name]
    assert len(compiles) == units
    objs = []
    for p, (cmd, obj) in enumerate(compiles):
        assert cmd[-4:] == ["-c", "-o", obj, src] and f"-D{macro}={p}" in cmd
        assert "-shared" not in cmd
        assert [f for f in cmd[1:] if f != f"-D{macro}={p}"][:-4] == [
            f for f in _kernels.NVCC_FLAGS if f != "-shared"]
        objs.append(obj)
    assert len(set(objs)) == units
    assert link == ["nvcc", *_kernels.NVCC_FLAGS, "-o", out, *objs]


def test_int8_units_cover_every_instance_once():
    """csrc/int8_conv.cu's units: p < 8 the GEMM instance (BN, NC) = (32 (p %
    4 + 1), p / 4 + 1), 8 to 10 the depthwise slab 16 << (p - 8), 11 the
    entry points; each instance the entry points launch in exactly one."""
    macro, units = _kernels.PARTS["int8_conv"]
    src = (_kernels.CSRC / "int8_conv.cu").read_text()
    assert f"{macro} == {units - 1}" in src
    gemm = [(32 * (p % 4 + 1), p // 4 + 1) for p in range(8)]
    assert sorted(gemm) == sorted((bn, nc) for nc in (1, 2) for bn in (32, 64, 96, 128))
    assert [16 << (p - 8) for p in range(8, 11)] == [16, 32, 64]
    for bn in (32, 64, 96, 128):
        assert f"case {bn}: return launch_conv<{bn}, NC>(a, stream);" in src
    for cs in (16, 32, 64):
        assert f"launch_dw<{cs}>(a, s)" in src
    assert "template cudaError_t launch_conv<32 * (INT8_CONV_PART % 4 + 1), " \
           "INT8_CONV_PART / 4 + 1>(" in src
    assert "template cudaError_t launch_dw<(16 << (INT8_CONV_PART - 8))>(" in src


def test_library_name_hashes_source_headers_and_flags(tmp_path, monkeypatch):
    """The library's name changes with its source, a shared header or the
    flags, and with nothing else (the units are the source's own)."""
    (tmp_path / "k.cu").write_text("// a\n")
    (tmp_path / "h.cuh").write_text("// h\n")
    monkeypatch.setattr(_kernels, "CSRC", tmp_path)
    first = _kernels.library_path("k")
    assert _kernels.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// h2\n")
    second = _kernels.library_path("k")
    (tmp_path / "k.cu").write_text("// b\n")
    third = _kernels.library_path("k")
    monkeypatch.setattr(_kernels, "NVCC_FLAGS", _kernels.NVCC_FLAGS + ("-lineinfo",))
    assert len({first, second, third, _kernels.library_path("k")}) == 4


def _array(src: str, name: str) -> list:
    body = re.search(name + r"\[\d+\] = \{([^}]*)\}", src).group(1)
    return [v.strip() for v in body.split(",")]


@pytest.mark.parametrize("name", sorted(_kernels.PARTS))
def test_units_of_each_source(name):
    """Each source built as units: the last unit is the entry points'; the
    fused sources' unit tables name each bf16 instance their dispatch
    launches, once."""
    macro, units = _kernels.PARTS[name]
    src = (_kernels.CSRC / f"{name}.cu").read_text()
    assert f"#if {macro} == {units - 1}" in src
    if name == "fused_bottleneck":
        pairs = list(zip(map(int, _array(src, "kUnitBn2")), _array(src, "kUnitWide")))
        assert len(pairs) == units - 2 == len(set(pairs))
        cases = re.findall(r"integral_constant<int, (\d+)>\{\}, (true|false)_type", src)
        assert sorted((int(b), w) for b, w in cases) == sorted(pairs)
    elif name == "fused_inv_residual":
        bnp = list(map(int, _array(src, "kUnitBnp")))
        assert len(bnp) == units - 2 == len(set(bnp))
        assert sorted(map(int, re.findall(r"integral_constant<int, (\d+)>\{\}\)", src))) == \
            sorted(bnp)

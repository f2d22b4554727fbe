"""``port_test_times.py`` on a small JUnit file written here: the wall
seconds, the port's and the other files' sums, seconds by port file, the
heaviest cases, and with two files each figure's ratio, second over first."""

import subprocess
import sys

import pytest

import port_test_times as ptt
from tests.test_torch_port_gfv import ROOT

# (class name, case, seconds): a port file of two cases (one parametrised,
# one of a class), another port file, and a file of the JAX package's
PARENT = [("tests.test_torch_port_a", "test_x[1]", 10.0),
          ("tests.test_torch_port_a.TestY", "test_y", 5.5),
          ("tests.test_torch_port_b", "test_z", 2.0),
          ("tests.test_quant", "test_q", 7.25)]
CHANGE = [("tests.test_torch_port_a", "test_x[1]", 4.0),
          ("tests.test_torch_port_a.TestY", "test_y", 5.5),
          ("tests.test_torch_port_b", "test_z", 1.0),
          ("tests.test_torch_port_c", "test_new", 0.5),
          ("tests.test_quant", "test_q", 7.25)]


def _junit(path, cases, wall):
    body = "".join(f'<testcase classname="{c}" name="{n}" time="{t}" />' for c, n, t in cases)
    path.write_text('<?xml version="1.0" encoding="utf-8"?><testsuites name="pytest tests">'
                    f'<testsuite name="pytest" errors="0" failures="0" skipped="0" '
                    f'tests="{len(cases)}" time="{wall}">{body}</testsuite></testsuites>')
    return str(path)


def test_one_run_sums_files_and_cases(tmp_path):
    run = ptt.load(_junit(tmp_path / "p.xml", PARENT, 20.5))
    assert run["wall"] == 20.5
    assert run["cases"]["test_torch_port_a::test_x[1]"] == 10.0
    s = ptt.summary(run)
    assert (s["port"], s["rest"], s["cases"]) == (17.5, 7.25, 4)
    assert s["files"] == {"test_torch_port_a": 15.5, "test_torch_port_b": 2.0}
    lines = ptt.report([run])
    assert "     20.5  wall seconds" in lines
    assert "     17.5  port files' seconds" in lines
    assert "      7.2  other files' seconds" in lines
    files = lines.index("seconds by port file:")
    assert lines[files + 1:files + 3] == ["     15.5  test_torch_port_a",
                                          "      2.0  test_torch_port_b"]
    top = lines.index(f"the {ptt.TOP_CASES} heaviest cases of run 1:")
    assert lines[top + 1] == "     10.0  test_torch_port_a::test_x[1]"
    assert lines[top + 2] == "      7.2  test_quant::test_q"


def test_two_runs_give_ratios(tmp_path):
    parent = _junit(tmp_path / "p.xml", PARENT, 20.0)
    change = _junit(tmp_path / "c.xml", CHANGE, 15.0)
    lines = ptt.report([ptt.load(parent), ptt.load(change)])
    assert "     20.0      15.0   0.750  wall seconds" in lines
    assert "     17.5      11.0   0.629  port files' seconds" in lines
    assert "cases: 4 / 5" in lines
    assert "      2.0       1.0   0.500  test_torch_port_b" in lines
    assert "        -       0.5   test_torch_port_c" in lines     # a new file
    assert "     10.0       4.0   0.400  test_torch_port_a::test_x[1]" in lines
    # the script prints the same lines, and refuses three files
    out = subprocess.run([sys.executable, str(ROOT / "port_test_times.py"), parent, change],
                         capture_output=True, text=True, check=True).stdout
    assert out.splitlines() == lines
    assert ptt.main([parent, change, parent]) == 2


@pytest.mark.parametrize("root_tag", ["testsuites", "testsuite"])
def test_reads_either_root(tmp_path, root_tag):
    path = _junit(tmp_path / "p.xml", PARENT, 3.0)
    if root_tag == "testsuite":   # pytest's older layout: the suite is the root
        text = open(path).read()
        text = text.replace('<testsuites name="pytest tests">', "").replace("</testsuites>", "")
        open(path, "w").write(text)
    assert ptt.load(path)["wall"] == 3.0 and len(ptt.load(path)["cases"]) == 4

"""The benchmark's files: the manifest and every file it names load by
name and keep the contract's characters; the per-layer metrics' cells
report what they move; nothing under perfbench imports JAX or the JAX
package (the reference nothing of the program either); run.py refuses to
run without a card or without the program beside it."""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from perfbench import common, judge  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = common.manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = {"config": {"name", "source", "file", "reduced", "why"},
        "workload": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}


def test_manifest_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for kind, entries in (("config", BENCH["configs"]), ("workload", BENCH["workloads"]),
                          ("end_to_end", BENCH["end_to_end"]),
                          ("per_layer", BENCH["per_layer"])):
        for e in entries:
            assert set(e) <= KEYS[kind], (kind, e)
            assert set(e) >= KEYS[kind] - {"workloads"}, (kind, e)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert os.path.getsize(os.path.join(common.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[section]:
            assert NAME.match(e["name"]), e["name"]
            names.append((section, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
            if "better" in e:
                assert e["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
    metrics = [n for s, n in names if s in ("end_to_end", "per_layer")]
    assert len(set(metrics)) == len(metrics)
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load_by_name(name):
    cell = common.cell(name, BENCH)
    assert cell["traffic"]["driver"] in ("serve", "train")
    limits = judge.limits(name)
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    e2e = common.end_to_end_metrics(BENCH, name)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert common.per_layer_metrics(BENCH, name)


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("perfbench/") and c["file"] not in files
        files.add(c["file"])
        data = common.load_json(os.path.join(common.ROOT, c["file"]))
        assert data["reduced"] == c["reduced"] == []
        assert data["source"] == c["source"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    read = common.metric_reader(metric)
    assert read({}) is None            # nothing to read: no value, never 0
    for cell in m["workloads"]:
        assert cell in CELLS
        assert m["moves"] in {e["name"] for e in common.end_to_end_metrics(BENCH, cell)}


def test_forbidden_modules_compares_whole_names():
    assert common.forbidden_modules(["adafocus_torch", "adafocus_torch.models", "jaxtyping",
                                     "flaxen"]) == []
    assert common.forbidden_modules(["jaxlib.xla_client", "adafocus_tpu.ops", "torch"]) == \
        ["adafocus_tpu", "jaxlib"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_sources_import_no_jax():
    for dirpath, _, files in os.walk(common.HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tops = {m.split(".", 1)[0] for m in _imports(path)}
            assert not tops & set(common.FORBIDDEN), path
            if os.path.basename(dirpath) == "reference":
                assert "adafocus_torch" not in tops, path
            text = open(path).read()
            assert "import_module(\"jax" not in text and "__import__(\"jax" not in text


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py"] + args, cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, **(env or {})))


def test_run_refuses_without_a_card():
    out = _run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
               common.ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(os.path.join(common.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(common.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
               tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    # past the look for a card, the run stops at the program's import
    probe = ("import sys, torch; sys.path.insert(0, '.'); from perfbench import run; "
             f"run.measure({CELLS[0]!r}, 1, 1.0, False, torch.device('cpu'))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "adafocus_torch" in out.stderr

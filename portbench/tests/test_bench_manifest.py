"""The manifest's form, every cell's files, a cell and a metric added as
files alone, and the import check."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_names_and_units():
    m = _manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in m["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for metric in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(metric["unit"]), metric["unit"]
        assert metric["better"] in ("lower", "higher")
    e2e = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in e2e
    for metric in m["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    for metric in m["per_layer"]:
        assert metric["moves"] in e2e and "\n" not in metric["layer"]
    assert 1 <= m["run_seconds"] <= 51 and m["paths"] == ["portbench"]
    assert len(json.dumps(m)) < 64 * 1024


def test_every_cell_resolves_to_its_files():
    m = _manifest()
    for w in m["workloads"]:
        cell = run.resolve(w["name"], ROOT)
        assert cell.config["n_sites"] > 0
        assert run.driver_class(cell, ROOT).__name__ == "Driver"
        assert cell.readers and all(p.is_file() for p in cell.readers.values())
        reported = {x["name"] for x in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert all(x["moves"] in reported for x in cell.per_layer)
    for c in m["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])


def test_a_cell_and_a_metric_added_as_files_are_found(tiny_root):
    m = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench = tiny_root / "portbench"
    (bench / "metrics" / "jobs_run.py").write_text(
        "def read(name, window):\n    return float(len(window.records))\n")
    (bench / "workloads" / "second-window.json").write_text(
        (bench / "workloads" / "ensemble-window.json").read_text())
    m["workloads"].append({"name": "second-window", "config": "tiny-ensemble",
                           "traffic": "tiny-jobs", "chips": 1, "why": "added"})
    m["per_layer"].append({"name": "jobs_run.second", "unit": "jobs",
                           "better": "higher", "source": "program_counter",
                           "layer": "ensemble and period loop",
                           "moves": "chain_periods_per_s",
                           "workloads": ["second-window"]})
    m["end_to_end"][0]["workloads"].append("second-window")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(m))
    cell = run.resolve("second-window", tiny_root)
    assert set(cell.readers) == {"jobs_run.second"}
    r = run.execute("second-window", 7, 0.1, True, device="cpu",
                    root=tiny_root)
    assert r["correct"] and r["metrics"]["jobs_run.second"]["value"] >= 1


def test_jax_check_compares_whole_top_level_names(monkeypatch):
    for name in ("timecrystal_tpu_torch", "timecrystal_tpu_torch.ops",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert "timecrystal_tpu" not in run.jax_loaded()
    assert "jax" not in run.jax_loaded()
    monkeypatch.setitem(sys.modules, "timecrystal_tpu.ops", sys)
    assert "timecrystal_tpu" in run.jax_loaded()


def test_a_run_loads_no_jax():
    code = ("import sys, torch; sys.modules.pop('jax', None)\n"
            "from portbench import run, control, work, trace\n"
            "from portbench.reference import tebd\n"
            "cell = run.resolve('ensemble-window'); run.driver_class(cell)\n"
            "cell = run.resolve('drive-diagram'); run.driver_class(cell)\n"
            "import timecrystal_tpu_torch.analysis.phase_diagram\n"
            "print(run.jax_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_neither_jax_nor_the_jax_package():
    for path in (ROOT / "portbench").rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in run.JAX_MODULES, (path, mod)


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        for mod in _imports(path):
            assert not mod.startswith("timecrystal_tpu"), (path, mod)


def test_without_a_card_the_command_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "ensemble-window", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""

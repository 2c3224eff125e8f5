"""pytest settings of the benchmark's own tests (``portbench/tests``).

Tests that need a CUDA card carry the ``card`` marker and decide inside
the test whether one is present; here they skip with the reason."""

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one "
        "(run on the card: python3 -m pytest portbench/tests -m card)")


def _tiny(root: Path) -> Path:
    """A copy of the benchmark under ``root`` whose two cells keep their
    names, drivers, readers and limits but run tiny configurations (L=8),
    which the CPU holds."""
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = root / "portbench" / "configs"
    e = json.loads((cfg / "ki-L40-chi256.json").read_text())
    e.update(n_sites=8, chi_max=16)
    (cfg / "tiny-ensemble.json").write_text(json.dumps(e))
    d = json.loads((cfg / "ki-L16-drive.json").read_text())
    d.update(n_sites=8, n_periods=12, n_eps=3, n_h=2, chi_pad=8)
    (cfg / "tiny-drive.json").write_text(json.dumps(d))
    t = json.loads((root / "portbench" / "traffic" / "staged-jobs.json").read_text())
    t["params"].update(realizations=4, periods=6, chi_start=4, chunk_periods=2)
    (root / "portbench" / "traffic" / "tiny-jobs.json").write_text(json.dumps(t))
    m["configs"] += [
        {"name": "tiny-ensemble", "source": "tests", "reduced": ["n_sites", "chi_max"],
         "file": "portbench/configs/tiny-ensemble.json", "why": "CPU tests"},
        {"name": "tiny-drive", "source": "tests", "reduced": ["n_sites"],
         "file": "portbench/configs/tiny-drive.json", "why": "CPU tests"}]
    for w in m["workloads"]:
        if w["name"] == "ensemble-window":
            w.update(config="tiny-ensemble", traffic="tiny-jobs")
        elif w["name"] == "drive-diagram":
            w.update(config="tiny-drive")
    (root / "BENCHMARK.json").write_text(json.dumps(m, indent=1))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return _tiny(tmp_path)

"""The benchmark of timecrystal_tpu_torch: one cell, one run, one process.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the package.  The run loads the
cell named in ``BENCHMARK.json`` with its files (``portbench/workloads/
<cell>.json``, its configuration ``portbench/configs/<config>.json``, its
traffic ``portbench/traffic/<traffic>.json`` and that traffic's driver
``portbench/drivers/<driver>.py``), builds the inputs from the seed, warms
the cell's own shapes up, runs whole jobs back to back until ``--seconds``
have passed (the last job started runs to its end), checks the outputs of
a sample of the window's jobs against the plain reference, and prints one
JSON line last.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics, each read by
``portbench/metrics/<name>.py`` (or the reader of the name's part before
its first dot).  Without a CUDA card it exits 3 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from portbench import trace as T
from portbench import work

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
JAX_MODULES = ("jax", "jaxlib", "flax", "timecrystal_tpu")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A cell with what the manifest and its files say of it."""

    name: str
    entry: dict                 # its entry in BENCHMARK.json's workloads
    spec: dict                  # portbench/workloads/<name>.json
    config: dict                # its configuration file
    traffic: dict               # portbench/traffic/<traffic>.json
    end_to_end: list            # the manifest's metric entries it reports
    per_layer: list
    readers: dict = field(default_factory=dict)   # per-layer name -> path


def _reader_path(root: Path, name: str) -> Path | None:
    metrics = root / "portbench" / "metrics"
    for stem in (name, name.split(".", 1)[0]):
        if (metrics / f"{stem}.py").is_file():
            return metrics / f"{stem}.py"
    return None


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the manifest under ``root``, with its files;
    raises KeyError or FileNotFoundError naming what is missing."""
    manifest = _json(root / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    spec = _json(root / "portbench" / "workloads" / f"{name}.json")
    traffic = _json(root / "portbench" / "traffic" / f"{entry['traffic']}.json")

    def mine(metric):
        return name in metric.get("workloads", [name])

    e2e = [m for m in manifest["end_to_end"] if mine(m)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if mine(m) and m["moves"] in e2e_names]
    cell = Cell(name, entry, spec, _json(root / cfg["file"]), traffic, e2e,
                layer)
    for m in layer:
        path = _reader_path(root, m["name"])
        if path is None:
            raise FileNotFoundError(f"no reader for per-layer metric "
                                    f"{m['name']} under portbench/metrics")
        cell.readers[m["name"]] = path
    driver = root / "portbench" / "drivers" / f"{traffic['driver']}.py"
    if not driver.is_file():
        raise FileNotFoundError(f"no driver {driver}")
    return cell


def driver_class(cell: Cell, root: Path = ROOT):
    path = root / "portbench" / "drivers" / f"{cell.traffic['driver']}.py"
    return _load_module(path, f"portbench_driver_{cell.traffic['driver']}").Driver


def seed_words(seed: int) -> list:
    """A seed as non-negative 32-bit words for numpy's SeedSequence (any
    whole number, negative ones too)."""
    s = int(seed) % (1 << 64)
    return [s & 0xFFFFFFFF, s >> 32]


def jax_loaded() -> list:
    """Top-level module names of JAX or the JAX package in sys.modules,
    compared whole (``timecrystal_tpu_torch`` is not ``timecrystal_tpu``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in JAX_MODULES)


@dataclass
class Window:
    """What the readers of per-layer metrics read."""

    seconds: float
    records: list
    peak: dict | None
    trace: dict = field(default_factory=dict)   # busy_s, kernel_s, ...
    counters: dict = field(default_factory=dict)

    def total(self, key: str) -> float:
        return float(sum(r.get(key, 0.0) for r in self.records))


def compare(cell: Cell, drv, n_jobs: int, precision: str = "complex128") -> dict:
    """The check: the cell driver's sample of ``n_jobs`` jobs against the plain
    reference in ``precision``; each number with the cell's limit."""
    items = drv.sample(n_jobs)
    nums = drv.numbers(drv.outputs(items), drv.reference(items, precision))
    limits = cell.spec["check"]["limits"]
    return {k: {"value": v, "limit": float(limits[k])} for k, v in nums.items()}


def _read_metric(path: Path, name: str, window: Window):
    mod = _load_module(path, f"portbench_metric_{path.stem.replace('.', '_')}")
    return mod.read(name, window)


def _build_seconds() -> float | None:
    """nvcc's wall time for the kernel library this process loaded (0 when
    it was already built in the checkout), or None when none was loaded."""
    from timecrystal_tpu_torch.ops import cuda_build

    got = cuda_build._LOADED.get("jacobi_sweep")
    return None if got is None else float(got[1].seconds)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def _program_counters(device) -> dict:
    """Kernel 1's calls and the device counter of its sweeps (read outside
    the window: reading the counter syncs)."""
    import torch
    from timecrystal_tpu_torch.ops import jacobi_svd

    out = {"sv_calls": jacobi_svd.CUDA_SV_CALLS}
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
        out["sweeps"] = int(jacobi_svd.sweep_counter(torch.device("cuda", index)))
    return out


def execute(name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", root: Path = ROOT) -> dict:
    """One run of the cell ``name``: the result object of the run's last
    line.  ``device`` 'cpu' runs the same path without a card (tests)."""
    import torch

    t_start = T.process_start_s()
    cell = resolve(name, root)
    dev = torch.device(device)
    spans = T.Spans()
    with spans.span("setup"):
        drv = driver_class(cell, root)(cell, seed_words(seed), dev)
        drv.warmup()
        if dev.type == "cuda":
            torch.cuda.synchronize()
    setup_s = time.time() - t_start
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    records, prof, syncs = [], {}, {}
    before = _program_counters(dev) if trace else {}
    with spans.span("window"):
        stack = contextlib.ExitStack()
        if trace and dev.type == "cuda":
            stack.enter_context(T.device_activity(prof))
            stack.enter_context(T.sync_count(syncs))
        t0_ns = time.time_ns()
        t0 = time.perf_counter()
        i = 0
        while i == 0 or time.perf_counter() - t0 < seconds:
            with spans.span("job"):
                records.append(drv.job(i, spans))
            i += 1
        if dev.type == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        t1_ns = time.time_ns()
        stack.close()
    after = _program_counters(dev) if trace else {}

    peak_bytes = 0
    if dev.type == "cuda":
        peak_bytes = torch.cuda.max_memory_allocated(dev)
        torch.cuda.empty_cache()
    found = jax_loaded()
    if found:
        raise SystemExit(f"JAX was loaded in this process: {found}")

    check = compare(cell, drv, len(records))
    correct = all(v["value"] <= v["limit"] for v in check.values())
    window = Window(window_s, records, work.peaks(kind))
    window.counters = {k: after[k] - before[k] for k in after}
    if "syncs" in syncs:
        window.counters["syncs"] = syncs["syncs"]
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": kind, "count": 1, "memory_peak_bytes": int(peak_bytes)}
    result = {"correct": bool(correct), "attempted": len(records),
              "failed": int(sum(1 for r in records if not r.get("ok", True)))}
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"].endswith("_per_s"):
                value = window.total(m["name"][:-len("_per_s")]) / window_s
            else:
                raise ValueError(f"no rule for end-to-end metric {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        if prof.get("events") is not None:
            window.trace = T.summarize(prof["events"], t0_ns, t1_ns, spans)
            device_info["busy_s"] = window.trace["busy_s"]
            device_info["window_s"] = (t1_ns - t0_ns) / 1e9
            window.trace["window_s"] = device_info["window_s"]
        for m in cell.per_layer:
            value = _read_metric(cell.readers[m["name"]], m["name"], window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if window.trace:
            result["breakdown"] = {"device_ops": window.trace["device_ops"],
                                   "idle_gaps": window.trace["idle_gaps"]}
    result["metrics"] = metrics
    result["device"] = device_info
    result["check"] = check
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch

    # one host thread for torch's CPU ops: the cells are paced by one
    # Python thread's launches, and idle worker threads made runs of one
    # seed differ by up to 6% (1.8% with one thread, PERF.md)
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 3
    need = int(resolve(args.workload).entry.get("chips", 1))
    if torch.cuda.device_count() < need:
        print(f"the cell needs {need} cards, {torch.cuda.device_count()} "
              "present", file=sys.stderr)
        return 3
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    found = jax_loaded()
    if found:
        print(f"JAX was loaded in this process: {found}", file=sys.stderr)
        return 4
    build_s = _build_seconds()
    if build_s is not None:
        print(f"setup_s holds the kernel library's nvcc build: {build_s!r} s "
              "(0: built by an earlier run in this checkout)", file=sys.stderr)
    limit = _power_limit()
    if limit:
        result["device"]["name_and_power_limit"] = limit
        print(f"card and power limit: {limit}", file=sys.stderr)
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The cell ``steady-chi256`` without the card (a tiny copy on the CPU: L=8,
chi=8, two chains settled 6 periods, 2-period jobs): a sound
run is correct, traced and untraced; the program broken underneath is
not; the TF32 control is not; the new readers give None without data; and
one short window on the card."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import control, run

CELL = "steady-chi256"
ROOT = Path(__file__).resolve().parents[2]
READERS = ("polar_share_pct.steady", "core_sweeps_per_call.steady",
           "topk_svd_roofline_pct.steady", "step_mfu_pct.steady",
           "k1_core_roofline_pct.steady")


@pytest.fixture
def steady_root(tiny_root):
    """``tiny_root`` with the cell on a tiny configuration and traffic."""
    bench = tiny_root / "portbench"
    cfg = json.loads((bench / "configs" / "ki-L40-chi256-steady.json").read_text())
    cfg.update(n_sites=8, chi_max=8, realizations=2)
    cfg["settle"] = dict(cfg["settle"], periods=6, chunk_periods=2)
    (bench / "configs" / "tiny-steady.json").write_text(json.dumps(cfg))
    t = json.loads((bench / "traffic" / "steady-chunks.json").read_text())
    t["params"].update(chunk_periods=2, chunks=1)
    (bench / "traffic" / "tiny-chunks.json").write_text(json.dumps(t))
    m = json.loads((tiny_root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tiny-steady", "source": "tests",
                         "reduced": ["n_sites", "chi_max"], "why": "CPU tests",
                         "file": "portbench/configs/tiny-steady.json"})
    for w in m["workloads"]:
        if w["name"] == CELL:
            w.update(config="tiny-steady", traffic="tiny-chunks")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(m, indent=1))
    return tiny_root


@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct(steady_root, trace):
    r = run.execute(CELL, 2 ** 31 + 4321, 0.2, bool(trace), device="cpu",
                    root=steady_root)
    assert r["correct"], r["check"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["check"]) == {"sz", "echo", "sigma", "sigma_head",
                                "kept_gap"}
    if trace:
        # the CPU has no device trace, no peaks and no sweep count (the
        # twin counts none): the reader of the program's stage times reads,
        # the others do not
        assert set(r["metrics"]) == {"polar_share_pct.steady"}
        assert 0 < r["metrics"]["polar_share_pct.steady"]["value"] < 100
    else:
        assert set(r["metrics"]) == {"chain_periods_per_s", "setup_s"}
    json.dumps(r)


def _half_rows(fn):
    """evolve_floquet_scan whose traces of the second half of the chains
    are copies of the first half's."""
    def evolve(*args, **kwargs):
        import torch

        psi, tr = fn(*args, **kwargs)
        R = tr["sz_sites"].shape[0]
        return psi, {k: torch.cat([v[: R // 2], v[: R // 2]])[:R]
                     for k, v in tr.items()}
    return evolve


def _plant(monkeypatch, fault):
    from timecrystal_tpu_torch.dynamics import tebd
    from timecrystal_tpu_torch.ops import csvd, jacobi_svd

    if fault == "state_unchanged":
        step, calls = tebd.floquet_period_merged, {"n": 0}

        def every_second(state, gates, tp):
            # every compared chunk (2 periods) holds one such period
            calls["n"] += 1
            if calls["n"] % 2 == 0:
                return state, state.lam.new_zeros(state.lead)
            return step(state, gates, tp)
        monkeypatch.setattr(tebd, "floquet_period_merged", every_second)
    elif fault == "half_rows":
        monkeypatch.setattr(tebd, "evolve_floquet_scan",
                            _half_rows(tebd.evolve_floquet_scan))
    elif fault == "tf32_theta":
        from portbench.reference.tebd import tf32_round

        core = jacobi_svd.jacobi_core
        monkeypatch.setattr(csvd, "jacobi_core",
                            lambda theta, k, **kw: core(tf32_round(theta), k, **kw))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_rows", "tf32_theta"])
def test_a_broken_program_is_not_correct(steady_root, monkeypatch, fault):
    _plant(monkeypatch, fault)
    r = run.execute(CELL, 99, 0.2, False, device="cpu", root=steady_root)
    assert not r["correct"], r["check"]


def test_the_control_is_not_correct(steady_root):
    limits = json.loads((steady_root / "portbench" / "workloads" /
                         f"{CELL}.json").read_text())["check"]["limits"]
    rows = list(control.readings(CELL, [3, 4], {3}, 2, device="cpu",
                                 root=steady_root, emit=lambda r: None,
                                 witness_seeds={3}, diagnose=True))
    progs = [r for r in rows if r["side"] == "program"]
    ctl = next(r for r in rows if r["side"] == "control")
    assert all(p[k] <= v for p in progs for k, v in limits.items()), progs
    assert any(ctl[k] > v for k, v in limits.items()), ctl
    # the settle reached the cap, and the second seed reused its state
    assert progs[0]["cap_from_period"] == progs[1]["cap_from_period"] == 0
    assert progs[0]["sigma_cap_mid_min"] > 0


def test_the_check_samples_the_kept_job(steady_root):
    import torch

    cell = run.resolve(CELL, steady_root)
    drv = run.driver_class(cell, steady_root)(cell, run.seed_words(7),
                                              torch.device("cpu"))
    for i in range(6):
        drv.job(i, control._NoSpans())
        assert drv.kept[0] == drv.sample(i + 1)[0][0]
    (j, a), (_, b) = drv.sample(6)
    assert a < cell.config["realizations"] // 2 <= b
    # the same seed draws the same sample, another seed may not
    again = run.driver_class(cell, steady_root)(cell, run.seed_words(7),
                                                torch.device("cpu"))
    assert again.sample(6) == drv.sample(6)
    draws = {tuple(run.driver_class(cell, steady_root)(
        cell, run.seed_words(s), torch.device("cpu")).sample(6))
        for s in range(2 ** 31, 2 ** 31 + 12)}
    assert len(draws) > 1


@pytest.mark.parametrize("name", READERS)
def test_the_new_readers_give_none_without_data(name):
    path = run._reader_path(run.ROOT, name)
    assert path is not None and path.stem == name.split(".")[0]
    empty = run.Window(1.0, [], {"float32_flops": 6.7e13,
                                 "memory_bytes_per_s": 3.35e12})
    assert run._read_metric(path, name, empty) is None
    # a program without the spans and counters: records without their keys
    bare = run.Window(1.0, [{"chain_periods": 160, "nominal_svd_s": 0.1}],
                      empty.peak)
    assert run._read_metric(path, name, bare) is None


def test_the_readers_read_the_records():
    rec = {"topk_polar_w_s": 1.0, "topk_polar_z_s": 1.0, "topk_core_s": 0.5,
           "topk_sweeps_s": 1.0, "topk_v_polish_s": 0.5, "topk_calls": 4.0,
           "topk_core_sweeps": 36.0, "nominal_svd_s": 0.04,
           "nominal_ops": 6.7e11, "k1_core_ops": 6.7e11,
           "k1_core_bytes": 3.35e9}
    w = run.Window(2.0, [rec, rec], {"float32_flops": 6.7e13,
                                     "memory_bytes_per_s": 3.35e12})
    w.trace = {"kernel_s": {"jacobi_sv_cluster_kernel<float>": 1.5,
                            "jacobi_sv_smem_kernel<float>": 0.5,
                            "sm80_xmma_gemm_cf32cf32": 3.0}}
    got = {n: run._read_metric(run._reader_path(run.ROOT, n), n, w)
           for n in READERS}
    assert got["polar_share_pct.steady"] == pytest.approx(75.0)
    assert got["core_sweeps_per_call.steady"] == pytest.approx(9.0)
    assert got["topk_svd_roofline_pct.steady"] == pytest.approx(1.0)
    # 1.34e12 operations over 2 s at 6.7e13 a second
    assert got["step_mfu_pct.steady"] == pytest.approx(1.0)
    # max(1.34e12 / 6.7e13, 6.7e9 / 3.35e12) = 0.02 s over kernel 1's 2 s
    assert got["k1_core_roofline_pct.steady"] == pytest.approx(1.0)
    # bytes-bound: the memory rate's time is the least
    w.records = [dict(rec, k1_core_bytes=3.35e11)] * 2
    assert run._read_metric(run._reader_path(run.ROOT, READERS[4]),
                            READERS[4], w) == pytest.approx(10.0)


def test_core_sweep_work_by_hand():
    from portbench import core_work

    # k = 2: one pair, an inner product (2 complex multiply-adds, 16) and
    # the rotation of 2 x 2 entries (10 each, 40)
    assert core_work.sweep_ops(2) == 56.0
    # k = 256: 32640 pairs of 28 x 256 operations
    assert core_work.sweep_ops(256) == 32640 * 28 * 256
    assert core_work.sweep_bytes(4, 8) == 256.0
    w = core_work.sweeps_work(312 * 10.0, 256, 8)
    assert w["ops"] == pytest.approx(3120 * 32640 * 28 * 256)
    assert w["bytes"] == pytest.approx(3120 * 2 * 256 * 256 * 8)


def test_the_cpu_records_no_core_sweeps(steady_root):
    """Kernel 1's sweep counter counts on a card only: on the CPU a job's
    record has the call count and stage times but no sweep count."""
    import torch

    cell = run.resolve(CELL, steady_root)
    drv = run.driver_class(cell, steady_root)(cell, run.seed_words(5),
                                              torch.device("cpu"))
    rec = drv.job(0, control._NoSpans())
    assert rec["topk_calls"] > 0 and rec["topk_sweeps_s"] > 0
    assert not {"topk_core_sweeps", "k1_core_ops", "k1_core_bytes"} & set(rec)


@pytest.mark.card
@pytest.mark.parametrize("trace", [1])
def test_a_short_window_on_the_card_is_correct(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures the card only")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELL, "--seed",
         "2147483677", "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["check"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert set(READERS) <= set(r["metrics"])
    assert 0 < r["metrics"]["topk_svd_roofline_pct.steady"]["value"] <= 100
    assert 0 < r["metrics"]["k1_core_roofline_pct.steady"]["value"] <= 100
    assert r["metrics"]["core_sweeps_per_call.steady"]["value"] >= 1
    assert np.isfinite(r["metrics"]["device_idle_pct.steady"]["value"])

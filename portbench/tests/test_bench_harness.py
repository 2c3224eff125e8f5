"""Whole runs without the card (the CPU, tiny configurations): a sound run
is correct; the program broken underneath is not; the control is not."""

import json

import numpy as np
import pytest

from portbench import control, run

CELLS = ("ensemble-window", "drive-diagram")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct(tiny_root, cell, trace):
    r = run.execute(cell, 2 ** 31 + 12345, 0.2, bool(trace), device="cpu",
                    root=tiny_root)
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "check"
    m = json.loads((tiny_root / "BENCHMARK.json").read_text())
    if trace:
        assert set(r["metrics"]) <= {x["name"] for x in m["per_layer"]}
    else:
        assert "setup_s" in r["metrics"] and len(r["metrics"]) == 2
        assert all(v["value"] > 0 for v in r["metrics"].values())
    json.dumps(r)


def _every_third(fn):
    calls = {"n": 0}

    def step(state, gates, tp):
        calls["n"] += 1
        if calls["n"] % 3 == 0:
            return state, state.lam.new_zeros(state.lead)
        return fn(state, gates, tp)
    return step


def _half_rows(fn, rows_arg):
    def evolve(*args, **kwargs):
        args = list(args)
        R = len(args[0])
        cut = [a[: R // 2] if i in rows_arg else a for i, a in enumerate(args)]
        if "thetas" in kwargs and kwargs["thetas"] is not None:
            kwargs["thetas"] = kwargs["thetas"][: R // 2]
        out = fn(*cut, **kwargs)
        tr, rest = (out[0], out[1:]) if isinstance(out, tuple) else (out, None)
        tr = {k: np.concatenate([v, v])[:R] for k, v in tr.items()}
        return (tr, *rest) if rest is not None else tr
    return evolve


def _plant(monkeypatch, fault, cell):
    from timecrystal_tpu_torch.analysis import phase_diagram
    from timecrystal_tpu_torch.dynamics import tebd
    from timecrystal_tpu_torch.parallel import sweep

    if fault == "state_unchanged":
        name = "floquet_period_merged" if cell == "ensemble-window" else "floquet_period"
        monkeypatch.setattr(tebd, name, _every_third(getattr(tebd, name)))
    elif fault == "half_batch":
        if cell == "ensemble-window":
            monkeypatch.setattr(sweep, "evolve_batch_auto",
                                _half_rows(sweep.evolve_batch_auto, (0, 1)))
        else:
            monkeypatch.setattr(phase_diagram, "evolve_batch",
                                _half_rows(phase_diagram.evolve_batch, (0, 1)))
    elif fault == "answer_altered":
        measure = tebd._measure

        def altered(*a, **k):
            out = measure(*a, **k)
            out["sz_sites"] = out["sz_sites"].clone()
            out["sz_sites"][..., 0] += 5e-3
            return out
        monkeypatch.setattr(tebd, "_measure", altered)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_a_broken_program_is_not_correct(tiny_root, monkeypatch, cell, fault):
    _plant(monkeypatch, fault, cell)
    r = run.execute(cell, 99, 0.2, False, device="cpu", root=tiny_root)
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny_root, cell):
    limits = json.loads((tiny_root / "portbench" / "workloads" /
                         f"{cell}.json").read_text())["check"]["limits"]
    rows = list(control.readings(cell, [3], {3}, 2, device="cpu",
                                 root=tiny_root, emit=lambda r: None,
                                 witness_seeds={3}, diagnose=True))
    prog = next(r for r in rows if r["side"] == "program")
    ctl = next(r for r in rows if r["side"] == "control")
    wit = next(r for r in rows if r["side"] == "witness")
    assert all(prog[k] <= v for k, v in limits.items()), prog
    assert any(ctl[k] > v for k, v in limits.items()), ctl
    assert all(wit[k] <= v for k, v in limits.items() if k != "score"), wit
    if cell == "drive-diagram":
        # the eps = 0 row stays a product state: every row is compared
        n = json.loads((tiny_root / "portbench" / "configs" /
                        "tiny-drive.json").read_text())["n_periods"]
        assert prog["rows_max"] == n + 1 and prog["points_whole"] >= 2
        assert 0 < prog["rows_min"] <= prog["rows_median"] <= n + 1


def test_an_altered_score_is_not_correct(tiny_root, monkeypatch):
    from timecrystal_tpu_torch.analysis import phase_diagram

    a2t = phase_diagram.extract_subharmonic_amplitude
    monkeypatch.setattr(phase_diagram, "extract_subharmonic_amplitude",
                        lambda *a, **k: a2t(*a, **k) + 1e-6)
    r = run.execute("drive-diagram", 99, 0.2, False, device="cpu",
                    root=tiny_root)
    assert r["check"]["sz"]["value"] <= r["check"]["sz"]["limit"]
    assert r["check"]["score"]["value"] > r["check"]["score"]["limit"]
    assert not r["correct"]


def test_every_seed_orders_the_same_pool(tiny_root):
    import torch

    cell = run.resolve("ensemble-window", tiny_root)
    cls = run.driver_class(cell, tiny_root)

    def drv(seed):
        return cls(cell, run.seed_words(seed), torch.device("cpu"))

    a, b = drv(2 ** 31 + 7), drv(2 ** 31 + 8)
    pool = int(cell.traffic["params"]["pool"])
    assert np.array_equal(a.order, drv(2 ** 31 + 7).order)
    assert not np.array_equal(a.order, b.order)
    assert sorted(a.order) == list(range(pool))
    # the same pool entry holds the same fields whatever the seed
    j = int(np.argmax(a.order == b.order[3]))
    assert np.array_equal(a.fields(j), b.fields(3))
    assert np.array_equal(a.fields(5), a.fields(5 + pool))
    assert not np.array_equal(a.fields(5), a.fields(6))
    assert np.all(np.abs(a.fields(5)) <= float(cell.config["h_max"]))

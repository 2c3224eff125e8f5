"""The port's application layer against the JAX package: the correlation
trace of the Floquet drivers, the DTC scorer, the config parser, Figures
A-D, the phase and drive grids, and the CLI.

Inputs come from numpy seeds and go through both packages.  Tolerances:
complex128 against float64 to 1e-8 (the fixtures' gate) for the correlation
trace, identical to 1e-12 for the numpy scorer, and complex64 against the
JAX package's float32 to 1e-4 for the figure and grid runs (both evolve the
same rank-1 theta = pi dynamics with LAPACK splits on the CPU; their traces
differ by float32 rounding, ~1e-6).
"""

import logging
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timecrystal_tpu.analysis import detection as jdet
from timecrystal_tpu.analysis import figures as jfig
from timecrystal_tpu.analysis import phase_diagram as jpd
from timecrystal_tpu.core import mps as jmps
from timecrystal_tpu.core.truncate import TruncParams as JTruncParams
from timecrystal_tpu.dynamics import tebd as jtebd
from timecrystal_tpu.models import kicked_ising as jki
from timecrystal_tpu.parallel import sweep as jsw
from timecrystal_tpu.utils.config import read_parameters as jread
from timecrystal_tpu_torch import main as tmain
from timecrystal_tpu_torch.analysis import detection as tdet
from timecrystal_tpu_torch.analysis import figures as tfig
from timecrystal_tpu_torch.analysis import phase_diagram as tpd
from timecrystal_tpu_torch.core import mps as tmps
from timecrystal_tpu_torch.core import observables as tobs
from timecrystal_tpu_torch.core.truncate import TruncParams
from timecrystal_tpu_torch.dynamics import tebd as ttebd
from timecrystal_tpu_torch.models import kicked_ising as tki
from timecrystal_tpu_torch.parallel import sweep as tsw
from timecrystal_tpu_torch.utils.config import read_parameters as tread


REPO = Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "config.txt")
C128, C64 = torch.complex128, torch.complex64
L8, SITE = 8, 3
PARAMS = {"J": 1.0, "CHI_MAX": 32, "SVD_MIN": 1e-12, "SVD_CUTOFF": 1e-7,
          "RANDOM_SEED": 42, "T_DRIVE": 2.0}
F32_TOL = 1e-4


def _close(a, b, tol, what=""):
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                               rtol=0, atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# correlation_site
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frame", ["strict", "merged"])
def test_correlation_site_of_evolve_floquet_scan_matches_jax(frame):
    """zz_corr [n, L] of an entangling L=8 run, both frames, and every other
    trace unchanged by the option."""
    kw = dict(J=1.0, h_disorder=0.4, tau=1.0, disorder_seed=3, theta=0.9 * np.pi,
              chi=8)
    jm = jki.KickedIsingModel(L8, dtype=jnp.float64, **kw)
    tm = tki.KickedIsingModel(L8, dtype=C128, device="cpu", **kw)
    jpsi = jmps.create_initial_state(L8, "neel", chi=8, dtype=jnp.float64)
    tpsi = tmps.create_initial_state(L8, "neel", chi=8, dtype=C128, device="cpu")
    jtp = JTruncParams(svd_min=1e-12, svd_method="native")
    ttp = TruncParams(svd_min=1e-12, svd_method="native")
    _, jtr = jtebd.evolve_floquet_scan(jpsi, jm.gates, 6, jtp, frame=frame,
                                       correlation_site=SITE)
    psi, ttr = ttebd.evolve_floquet_scan(tpsi, tm.gates, 6, ttp, frame=frame,
                                         correlation_site=SITE)
    _, plain = ttebd.evolve_floquet_scan(tpsi, tm.gates, 6, ttp, frame=frame)
    assert ttr["zz_corr"].shape == (6, L8)
    _close(ttr["zz_corr"], jtr["zz_corr"], 1e-8)
    _close(ttr["zz_corr"][-1], tobs.zz_correlation_profile(psi, SITE), 1e-8)
    for k in plain:
        assert torch.equal(plain[k], ttr[k]), k


def test_correlation_site_of_evolve_floquet_traces_matches_jax():
    """CustomFloquet.evolve_floquet_traces: the stored rows with the t=0 row
    of _initial_observables, measured in-loop every 2 periods."""
    kw = dict(J=1.0, h_disorder=0.3, tau=1.0, disorder_seed=4, theta=0.85 * np.pi,
              chi=8)
    jm = jki.KickedIsingModel(L8, dtype=jnp.float64, **kw)
    tm = tki.KickedIsingModel(L8, dtype=C128, device="cpu", **kw)
    jpsi = jmps.create_initial_state(L8, "neel", chi=8, dtype=jnp.float64)
    tpsi = tmps.create_initial_state(L8, "neel", chi=8, dtype=C128, device="cpu")
    for m in (2,):
        jtr, _, _ = jtebd.CustomFloquet(jm, JTruncParams(svd_min=1e-12)) \
            .evolve_floquet_traces(jpsi, 4, measure_every=m, correlation_site=0)
        ttr, _, _ = ttebd.CustomFloquet(tm, TruncParams(svd_min=1e-12)) \
            .evolve_floquet_traces(tpsi, 4, measure_every=m, correlation_site=0)
        assert set(ttr) == set(jtr)
        _close(ttr["zz_corr"], jtr["zz_corr"], 1e-8)
        _close(ttr["zz_corr"][0], tobs.zz_correlation_profile(tpsi, 0), 0)


@pytest.mark.parametrize("staged", [False, True])
def test_correlation_site_of_the_ensembles_matches_jax(staged):
    """evolve_batch (t=0 row from zz_correlation_profile) and the staged
    evolve_batch_auto (t=0 row in closed form) at L=8, three realizations."""
    rng = np.random.default_rng(12)
    h, taus = rng.uniform(-0.3, 0.3, (3, L8)), np.array([1.0, 1.1, 1.2])
    basis = jsw._basis_indices(L8, "neel")
    kw = dict(L=L8, chi=8, n_periods=5, theta=0.9 * np.pi, dtype="float64")
    jspec = jsw.SweepSpec(tp=JTruncParams(svd_min=1e-12, svd_method="native"), **kw)
    tspec = tsw.SweepSpec(tp=TruncParams(svd_min=1e-12, svd_method="native"), **kw)
    if staged:
        jtr, _ = jsw.evolve_batch_auto(jnp.asarray(h), jnp.asarray(taus), basis,
                                       jspec, chi_start=4, chunk_periods=2,
                                       correlation_site=SITE)
        ttr, _ = tsw.evolve_batch_auto(h, taus, basis, tspec, chi_start=4,
                                       chunk_periods=2, correlation_site=SITE,
                                       device="cpu")
    else:
        jtr = jsw.evolve_batch(jnp.asarray(h), jnp.asarray(taus),
                               jnp.asarray(basis), jspec, correlation_site=SITE)
        ttr = tsw.evolve_batch(h, taus, basis, tspec, correlation_site=SITE,
                               device="cpu")
    assert set(ttr) == set(jtr)
    assert ttr["zz_corr"].shape == (3, 6, L8)
    for k in jtr:
        _close(ttr[k], np.asarray(jtr[k]), 1e-8, k)
    psi0 = tmps.create_initial_state(L8, "neel", chi=8, dtype=C128, device="cpu")
    _close(ttr["zz_corr"][:, 0], np.broadcast_to(
        tobs.zz_correlation_profile(psi0, SITE).numpy(), (3, L8)), 0)


# ---------------------------------------------------------------------------
# config and detection (numpy copies)
# ---------------------------------------------------------------------------

def test_read_parameters_matches_jax(tmp_path):
    cfg = tmp_path / "params.txt"
    cfg.write_text("# c\nJ = 1\nTAU = 0.5  # t\nH = [0.1, 0.2]\nN = [1, 2]\n"
                   "F = png,pdf\nM = 1.5, 2.5\nS = neel\nE = []\nX = 1e-7\n")
    for path in (str(cfg), CONFIG):
        assert tread(path) == jread(path)
    with pytest.raises(FileNotFoundError, match="nope.txt"):
        tread(str(tmp_path / "nope.txt"))


def _grid_traces(seed, P=6, n=81):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    alt = np.cos(np.pi * t)[None, :]
    amp = rng.uniform(0, 0.5, (P, 1))
    le = np.clip(0.5 + amp * alt + 0.05 * rng.normal(size=(P, n)), 0, 1)
    le[1, 7] = np.nan                        # a failed point
    chi = rng.integers(1, 6, (P, n))
    hs, Ts = rng.uniform(0, 0.8, P), rng.uniform(0.8, 4.0, P)
    return {"loschmidt_echo": le, "max_chi": chi}, hs, Ts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_grid_matches_jax(seed):
    traces, hs, Ts = _grid_traces(seed)
    periods = Ts.copy()
    times = np.arange(81)[None, :] * periods[:, None]
    ours = tdet.score_grid(traces, times, hs, Ts, periods)
    ref = jdet.score_grid(traces, times, hs, Ts, periods)
    assert [r["success"] for r in ours] == [r["success"] for r in ref]
    assert any(r["dtc_score_raw"] > 0 for r in ref), "no point scores"
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k], 1e-12, k)


# ---------------------------------------------------------------------------
# Figures A-D and the grids
# ---------------------------------------------------------------------------

SIMS = {
    "A": ("simulate_perfect_dtc", dict(n_sites=8, n_periods=24)),
    "B": ("simulate_disordered_dtc", dict(n_sites=8, n_periods=24)),
    "C": ("simulate_dephasing_dtc", dict(n_sites=8, n_periods=24)),
    "D": ("simulate_multi_site_dtc", dict(n_periods=24)),
}


@pytest.mark.parametrize("key", sorted(SIMS))
def test_figure_simulations_match_jax(key):
    """complex64 on the CPU against the JAX package's float32, to
    F32_TOL: the traces, the times, and Figure A's spectral peak at w/2."""
    name, kw = SIMS[key]
    ours = getattr(tfig, name)(PARAMS, device="cpu", dtype=C64, **kw)
    ref = getattr(jfig, name)(PARAMS, **kw)
    np.testing.assert_array_equal(ours[0], ref[0])
    for a, b in zip(ours[1:], ref[1:]):
        _close(a, b, F32_TOL)
    if key == "A":
        f, p = tobs.calculate_fourier_spectrum(ours[0], ours[1], 4.0)
        assert abs(f[np.argmax(p)] - 0.5) < 0.05
    if key == "D":
        assert len(ours[1]) == len(tfig.FIGURE_SITES)


def test_auto_runs_log_their_info(caplog):
    """evolve_floquet_auto logs its info dict at DEBUG level (the record's
    ``run_info``): the chi a figure reached, which the figures' return
    values do not carry.  One record per run, equal to the returned info."""
    kw = dict(n_sites=L8, J=1.0, h_disorder=0.3, tau=1.0, disorder_seed=3,
              theta=0.8 * np.pi, device="cpu", dtype=C64)
    with caplog.at_level(logging.DEBUG, logger=ttebd.__name__):
        _, _, info, _ = ttebd.evolve_floquet_auto(kw, "neel", 8,
                                                  {"chi_max": 16}, chi_start=4)
        tfig.simulate_perfect_dtc(PARAMS, n_sites=L8, n_periods=4,
                                  device="cpu", dtype=C64)
    logged = [r.run_info for r in caplog.records if hasattr(r, "run_info")]
    assert len(logged) == 2 and logged[0] is info
    assert info["chi_escalations"] and info["chi_pad_used"] > 4
    assert logged[1]["n_periods"] == 4 and len(logged[1]["bond_dimensions"]) == 5


def test_sweep_phase_grid_matches_jax(monkeypatch):
    """A 2 x 2 sub-grid of the phase diagram (L=16, cut from 80 periods to
    40 in both packages' GRID_HARDCODED, a depth at which the points score
    as DTCs): records and traces against the JAX package's float32 run."""
    for grid in (tpd.GRID_HARDCODED, jpd.GRID_HARDCODED):
        monkeypatch.setitem(grid, "n_periods", 40)
    hv, Tv = [0.1, 0.6], [1.5, 3.5]
    ours = tpd.sweep_phase_grid(hv, Tv, PARAMS, device="cpu", dtype=C64)
    ref = jpd.sweep_phase_grid(hv, Tv, PARAMS)
    np.testing.assert_array_equal(ours["hs"], ref["hs"])
    for k in ref["traces"]:
        _close(ours["traces"][k], ref["traces"][k], F32_TOL, k)
    assert any(r["A2T"] > 0.1 for r in ref["records"])
    for a, b in zip(ours["records"], ref["records"]):
        for k in b:
            _close(a[k], b[k], F32_TOL, k)
    rec = tpd.calculate_phase_point(0.1, 1.5, PARAMS, device="cpu", dtype=C64)
    _close(rec["A2T"], ours["records"][0]["A2T"], F32_TOL)


def test_sweep_drive_grid_matches_jax_and_chunks_bit_exactly():
    """3 eps x 2 h at n_sites=8, 16 periods, one program (chunk_size=0),
    against the JAX package's float32 run; chunks of 4 points give the
    one-program result bit for bit (LAPACK splits on the CPU)."""
    eps, hv = [0.0, 0.1, 0.3], [0.2, 0.6]
    kw = dict(n_sites=8, n_periods=16)
    ours = tpd.sweep_drive_grid(eps, hv, PARAMS, chunk_size=0, device="cpu",
                                dtype=C64, **kw)
    ref = jpd.sweep_drive_grid(eps, hv, PARAMS, chunk_size=0, **kw)
    for k in ("A2T", "subharmonic_weight"):
        assert ours[k].shape == (3, 2)
        _close(ours[k], ref[k], F32_TOL, k)
    for k in ref["traces"]:
        _close(ours["traces"][k], ref["traces"][k], F32_TOL, k)
    chunked = tpd.sweep_drive_grid(eps, hv, PARAMS, chunk_size=4, device="cpu",
                                   dtype=C64, **kw)
    for k in ours["traces"]:
        np.testing.assert_array_equal(chunked["traces"][k], ours["traces"][k])
    assert chunked["records"] == ours["records"]


# ---------------------------------------------------------------------------
# The CLI and the options that are not ported
# ---------------------------------------------------------------------------

def test_cli_help_runs():
    out = subprocess.run([sys.executable, "-m", "timecrystal_tpu_torch", "--help"],
                         capture_output=True, text=True, cwd=REPO, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr
    for flag in ("--phase-only", "--figures-only", "--drive-diagram",
                 "--range-diagram", "--memory-diagram", "--cpu", "--config"):
        assert flag in out.stdout


def test_cli_figures_only_on_the_cpu_writes_the_eight_files(tmp_path,
                                                            monkeypatch):
    """main --cpu --figures-only with the simulations cut to n_sites=8 and
    24 periods (Figure D: 24 periods): the eight A-D files in ./figures."""
    sims = {n: getattr(tfig, n) for n, _ in SIMS.values()}
    for name, kw in SIMS.values():
        monkeypatch.setattr(tfig, name, lambda *a, _f=sims[name], _kw=kw, **k:
                            _f(*a, **_kw, **k))
    monkeypatch.chdir(tmp_path)
    tmain.main(["--cpu", "--figures-only", "--config", CONFIG])
    for stem in tfig.FILES.values():
        for ext in ("png", "pdf"):
            assert (tmp_path / "figures" / f"{stem}.{ext}").stat().st_size > 0


def test_cli_without_cpu_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(["--figures-only", "--config", CONFIG])
    assert tmain.run_device(True) == ("cpu", C128)


def test_memory_diagram_raises_naming_its_item(tmp_path):
    """--memory-diagram runs (tests/test_torch_open_system.py renders it),
    and so does its ``mesh`` now: the figure's scans over a two-device CPU
    mesh (three rows a leg, one padded) return the unsharded results bit
    for bit."""
    from timecrystal_tpu_torch.analysis import memory as tmem

    kw = dict(gammas=[0.05], L=4, n_periods=4, chi=4, n_realizations=1,
              n_trajectories=3, eps_values=[0.0, 0.1], device="cpu",
              dtype=C128)
    _, ref = tmem.generate_memory_figure(PARAMS, out_dir=str(tmp_path / "a"),
                                         **kw)
    _, out = tmem.generate_memory_figure(
        PARAMS, out_dir=str(tmp_path / "b"),
        mesh=tsw.BatchMesh(("cpu", "cpu")), **kw)
    for res_ref, res in ((ref, out), (ref["eps_scan"], out["eps_scan"])):
        for k, v in res_ref.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(res[k], v, err_msg=k)


def _grid_pair(which, tmp_path):
    """(plain run, run with the option) of a grid cut to L=6, 4 periods."""
    hv, Tv = [0.0, 0.2, 0.4], [1.6, 2.0]
    if which == "drive":
        kw = dict(n_sites=6, n_periods=4, chi_pad=8, device="cpu", dtype=C128)
        return (tpd.sweep_drive_grid(hv, Tv, PARAMS, **kw),
                tpd.sweep_drive_grid(hv, Tv, PARAMS, **kw,
                                     mesh=tsw.BatchMesh(("cpu",) * 4)))
    kw = dict(chi_pad=8, device="cpu", dtype=C128)
    opt = ({"mesh": "auto"} if which == "auto" else
           {"checkpoint_dir": str(tmp_path / "ck"), "chunk_size": 2})
    return (tpd.sweep_phase_grid(hv, Tv, PARAMS, **kw),
            tpd.sweep_phase_grid(hv, Tv, PARAMS, **kw, **opt))


@pytest.mark.parametrize("call,item", [
    ("auto", "Scale-out"), ("drive", "Scale-out"), ("checkpoint", "Utilities"),
], ids=["<lambda>-Scale-out0", "<lambda>-Scale-out1", "<lambda>-Utilities"])
def test_unported_grid_options_raise(call, item, tmp_path, monkeypatch):
    """The grids' options, ported now: ``mesh='auto'`` on the CPU is no
    mesh; the drive grid over a four-device CPU mesh (six points, two
    padded); the phase grid's ``checkpoint_dir`` (three chunks of two).
    Each gives the plain run's traces bit for bit."""
    monkeypatch.setattr(tpd, "GRID_HARDCODED",
                        dict(tpd.GRID_HARDCODED, n_sites=6, n_periods=4))
    ref, out = _grid_pair(call, tmp_path)
    for k in ref["traces"]:
        np.testing.assert_array_equal(out["traces"][k], ref["traces"][k],
                                      err_msg=k)
    if call == "checkpoint":
        from timecrystal_tpu_torch.utils.checkpoint import SweepCheckpointer

        assert SweepCheckpointer(str(tmp_path / "ck")).completed_chunks() \
            == {0, 1, 2}

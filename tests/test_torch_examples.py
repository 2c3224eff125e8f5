"""The port's example entry points (``timecrystal_tpu_torch.examples``)
against the JAX package's own API calls with the same arguments, at small
sizes on the CPU: complex128 against float64, the inputs from numpy seeds
(disorder fields passed to both packages).

- ``quickstart``: the single chain, the staged ensemble, the correlator map
  and its S(k, omega), the interaction range to 1e-8; the memory section
  draws its trajectories' noise from a numpy seed and the JAX package from
  its own key stream, so it is held to JAX at gamma = 0 (no noise) to 1e-8
  (the bare-qubit T2 anchor is tested with the memory module).
- ``phase_diagram_hires``: a 3 x 2 grid (L=8, 40 periods) against JAX
  ``sweep_phase_grid`` in float64 (A2T to 1e-6, the same verdicts); the
  chunked, checkpointed run equals one program bit for bit (LAPACK splits
  on the CPU); the figures are written.
- ``multihost_demo``: two Gloo ranks (this file run as a script is one
  rank) equal one process bit for bit; the ensemble (its fields drawn from
  the torch generator) equals JAX ``evolve_batch`` in float64 to 1e-8.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timecrystal_tpu.analysis import detection as jdet
from timecrystal_tpu.analysis import memory as jmem
from timecrystal_tpu.analysis import phase_diagram as jpd
from timecrystal_tpu.core import observables as jobs
from timecrystal_tpu.core.mps import create_initial_state as jax_state
from timecrystal_tpu.core.truncate import TruncParams as JTruncParams
from timecrystal_tpu.dynamics import tebd as jtebd
from timecrystal_tpu.models import long_range as jlr
from timecrystal_tpu.models.kicked_ising import KickedIsingModel as JModel
from timecrystal_tpu.parallel import sweep as jsw
from timecrystal_tpu_torch.analysis import phase_diagram as tpd
from timecrystal_tpu_torch.examples import multihost_demo as tmd
from timecrystal_tpu_torch.examples import phase_diagram_hires as thr
from timecrystal_tpu_torch.examples import quickstart as tqs
from timecrystal_tpu_torch.models.kicked_ising import draw_disorder_batch
from timecrystal_tpu_torch.utils.config import read_parameters

REPO = Path(__file__).resolve().parents[1]
CPU = dict(device="cpu", dtype=torch.complex128)
TOL = 1e-8
L, CHI, N, R = 8, 16, 20, 2
THETA = 0.97 * np.pi
DEMO_SIZE = dict(L=6, chi=8, n_periods=6, n_realizations=4)
RANK_TIMEOUT = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs beside other worker processes on shared cores; torch's
    default intra-op thread pool would oversubscribe them and spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(seed):
    return np.random.default_rng(seed).uniform(-0.3, 0.3, (R, L))


def _close(a, b, tol, what=""):
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                               rtol=0, atol=tol, err_msg=what)


def _jax_spec(**kw):
    return jsw.SweepSpec(L=L, theta=THETA, dtype="float64",
                         tp=JTruncParams(chi_max=0, svd_min=1e-7), **kw)


def test_quickstart_single_chain_matches_jax():
    """CustomFloquet at L=8, chi=16, 20 periods: every trace, A2T and the
    stringent score to 1e-8."""
    ours = tqs.single_chain(L=L, chi=CHI, n_periods=N, **CPU)
    m = JModel(n_sites=L, J=1.0, h_disorder=0.3, tau=1.0, disorder_seed=42,
               chi=CHI, theta=THETA, dtype=jnp.float64)
    tr, times, _ = jtebd.CustomFloquet(
        m, JTruncParams(chi_max=CHI, svd_min=1e-7)).evolve_floquet_traces(
        jax_state(L, "neel", chi=CHI, dtype=jnp.float64), n_periods=N)
    for k in tr:
        _close(ours["traces"][k], tr[k], TOL, k)
    _close(ours["times"], times, 0.0)
    _close(ours["a2t"], jobs.extract_subharmonic_amplitude(
        np.asarray(times), tr["staggered_magnetization"], 2.0), TOL)
    _close(ours["dtc_score"], jdet.stringent_dtc_detection(
        tr["loschmidt_echo"], times, 2.0), TOL)
    assert int(np.max(tr["max_chi"])) > 4


def test_quickstart_ensemble_matches_jax():
    """evolve_batch_auto (chi from 16, chunks of 10 merged periods, no cap
    method on the CPU) with the same fields: traces and A2T to 1e-8."""
    h = _fields(0)
    ours = tqs.ensemble(R=R, L=L, chi=CHI, n_periods=N, h_fields=h, **CPU)
    taus = jnp.full((R,), 1.0)
    tr, info = jsw.evolve_batch_auto(
        jnp.asarray(h), taus, jnp.asarray(jsw._basis_indices(L, "neel")),
        _jax_spec(chi=CHI, n_periods=N, frame="merged"), chi_start=16,
        chunk_periods=10, cap_svd_method=None)
    for k in tr:
        _close(ours["traces"][k], tr[k], TOL, k)
    _close(ours["a2t"], jsw.ensemble_a2t(tr, taus), TOL)
    assert ours["info"]["chi_pad_used"] == info["chi_pad_used"]


def test_quickstart_correlator_map_matches_jax():
    """evolve_batch with correlation_site and two_time_anchor: the maps and
    the two-time map's S(k, omega) to 1e-8, the same peak."""
    h, site = _fields(1), 4
    ours = tqs.correlator_map(R=R, L=L, chi=CHI, n_periods=N, site=site,
                              h_fields=h, **CPU)
    tr = jsw.evolve_batch(jnp.asarray(h), jnp.full((R,), 1.0),
                          jnp.asarray(jsw._basis_indices(L, "neel")),
                          _jax_spec(chi=CHI, n_periods=N),
                          correlation_site=site, two_time_anchor=site)
    for k in tr:
        _close(ours["traces"][k], tr[k], TOL, k)
    c2t = np.asarray(tr["zz2t_re"]).mean(axis=0)
    freqs, ks, S = jobs.dynamic_structure_factor(
        np.arange(1, c2t.shape[0]) * 2.0, c2t[1:])
    _close(ours["freqs"], freqs, 1e-15)
    _close(ours["ks"], ks, 1e-15)
    _close(ours["S"], S, TOL, "S")
    fi, ki = np.unravel_index(int(np.argmax(np.asarray(S))), np.shape(S))
    assert (ours["peak_k"], ours["peak_f"]) == (ks[ki], freqs[fi])


def test_quickstart_interaction_range_matches_jax():
    """scan_interaction_range (TDVP) at L=4, chi=4, 10 periods (the fewest
    at which the A2T recipe has a bin at f_drive / 2), one realization of
    the power-law chain: A2T to 1e-8."""
    kw = dict(L=4, chi=4, n_periods=10, n_realizations=1)
    ours = tqs.interaction_range(alphas=(1.5,), **kw, **CPU)
    ref = jlr.scan_interaction_range([1.5], h_disorder=0.25, tau=2.0,
                                     theta=THETA, substeps=2,
                                     dtype=jnp.float64, **kw)
    assert ours["alphas"] == ref["alphas"]
    for k in ("a2t", "a2t_std", "a2t_all", "fit_rel_err"):
        _close(ours[k], ref[k], TOL, k)
    assert ours["a2t"][0] > 0.5


def test_quickstart_memory_lifetime_against_jax():
    """scan_memory_lifetime at L=6, chi=8, eps=0.04, 8 trajectories: at
    gamma = 0 the channel is noiseless, so the stored bit's envelope equals
    the JAX package's stochastic scan (float64, any key) sign-corrected by
    its memory_envelope, to 1e-8, with the same fitted lifetime, and the
    bare qubit keeps <sx> = 1; at gamma = 0.05 (noise from a numpy seed,
    not JAX's key stream) both decay."""
    import jax

    from timecrystal_tpu.dynamics import open_system as jos
    from timecrystal_tpu.models.kicked_ising import make_floquet_gates

    Lm, chi, n = 6, 8, 40
    ours = tqs.memory_lifetime(gammas=(0.0, 0.05), L=Lm, n_periods=n,
                               n_trajectories=8, chi=chi, **CPU)
    np.random.seed(42)
    h = np.random.uniform(-0.3, 0.3, Lm)
    gates = make_floquet_gates(1.0, jnp.asarray(h), 1.0,
                               theta=(1.0 - 0.04) * np.pi, dtype=jnp.float64)
    psi0 = jax_state(Lm, "neel", chi=chi, dtype=jnp.float64)
    _, _, tr = jos._evolve_stochastic_scan(
        psi0, gates, jax.random.PRNGKey(0), 0.0, n,
        JTruncParams(chi_max=0, svd_min=1e-7))
    signs = np.where(np.arange(Lm) % 2 == 0, 1.0, -1.0)
    env = jmem.memory_envelope((np.asarray(tr["sz_sites"]) * signs).mean(-1))
    times = 2.0 * np.arange(1, n + 1)
    _close(ours["times"], times, 0.0)
    _close(ours["envelope"][0], env, TOL, "envelope at gamma 0")
    _close(ours["tau_bit"][0], jmem.fit_memory_lifetime(times, env), 1e-6)
    _close(ours["sx_coherence"][0], np.ones(n), 1e-12)
    assert ours["t2_qubit"][0] == np.inf and ours["t2_analytic"][1] == 10.0
    assert ours["tau_bit"][1] < ours["tau_bit"][0]
    assert ours["sx_coherence"][1, -1] < 0.5


def test_quickstart_main_prints_every_section(monkeypatch, capsys):
    """main --cpu runs the five sections in order and prints the JAX
    script's summary (the sections cut to a tiny size here)."""
    small = dict(single_chain=dict(L=6, chi=8, n_periods=8),
                 ensemble=dict(R=2, L=6, chi=8, n_periods=4),
                 correlator_map=dict(R=2, L=6, chi=8, n_periods=20, site=3),
                 interaction_range=dict(alphas=(None,), L=4, chi=4,
                                        n_periods=4, n_realizations=1),
                 memory_lifetime=dict(L=4, n_periods=8, n_trajectories=2,
                                      chi=4))
    for name, kw in small.items():
        fn = getattr(tqs, name)
        monkeypatch.setattr(tqs, name, lambda _f=fn, _kw=kw, **k: _f(**_kw, **k))
    tqs.main(["--cpu"])
    out = capsys.readouterr().out
    for line in ("subharmonic A2T:", "ensemble of 2 disorder realizations",
                 "S(k, omega) peak", "alpha = inf (NN)", "bare-qubit T2"):
        assert line in out, out


def test_examples_without_cpu_need_a_card(monkeypatch):
    """Without --cpu every example stops when there is no CUDA device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (tqs.main, thr.main, tmd.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])


@pytest.fixture(scope="module")
def small_grid():
    """(params, the port's one-program grid): config.txt cut to a 3 x 2 scan
    of L=8 chains at 40 periods (both packages' GRID_HARDCODED), and JAX's
    SweepSpec in float64, for this module's grid tests."""
    with pytest.MonkeyPatch.context() as mp:
        for grid in (tpd.GRID_HARDCODED, jpd.GRID_HARDCODED):
            mp.setitem(grid, "n_periods", 40)
            mp.setitem(grid, "n_sites", 8)
        mp.setattr(jpd, "SweepSpec", lambda *a, **k: jsw.SweepSpec(
            *a, **dict(k, dtype="float64")))
        params = dict(read_parameters(str(REPO / "config.txt")),
                      H_SCAN_POINTS=3, T_SCAN_POINTS=2)
        yield params, thr.hires_grid(params, checkpoint_dir="", **CPU)


def test_hires_grid_matches_jax(small_grid):
    """hires_grid as one program against JAX sweep_phase_grid on the same
    axes: A2T to 1e-6, the same success at every point."""
    params, ours = small_grid
    hv, Tv = thr.grid_axes(params)
    ref = jpd.sweep_phase_grid(hv, Tv, params)
    assert ours["A2T"].shape == (2, 3)
    _close([r["A2T"] for r in ours["sweep"]["records"]],
           [r["A2T"] for r in ref["records"]], 1e-6, "A2T")
    assert ([r["success"] for r in ours["sweep"]["records"]]
            == [r["success"] for r in ref["records"]])
    assert ours["success"].sum() == sum(r["success"] for r in ref["records"])


def test_hires_chunked_run_equals_one_program(small_grid, tmp_path):
    """Chunks of 2 points under a checkpoint directory give the one-program
    grid bit for bit; a second call resumes from the chunks on disk; the
    figures are written."""
    params, one = small_grid
    ck = str(tmp_path / "ckpt")
    chunked = thr.hires_grid(params, chunk_size=2, checkpoint_dir=ck, **CPU)
    assert len([f for f in os.listdir(ck) if f.startswith("chunk")]) == 3
    again = thr.hires_grid(params, chunk_size=2, checkpoint_dir=ck, **CPU)
    for res in (chunked, again):
        np.testing.assert_array_equal(res["A2T"], one["A2T"])
        np.testing.assert_array_equal(res["success"], one["success"])
        for k, v in one["sweep"]["traces"].items():
            np.testing.assert_array_equal(res["sweep"]["traces"][k], v, k)
    paths = thr.render(one, str(tmp_path / "figs"), dpi=50)
    assert [Path(p).name for p in paths] == ["phase_diagram_hires.png",
                                             "phase_diagram_hires.pdf"]
    assert all(os.path.getsize(p) > 0 for p in paths)


def _demo_rank(rank: int, port: int, out: str) -> None:
    """One of the demo's two Gloo ranks at DEMO_SIZE on the CPU; rank 0
    saves its traces and A2T."""
    torch.set_num_threads(1)
    res = tmd.rank_main(rank, 2, port, **DEMO_SIZE, **CPU)
    if rank == 0:
        np.savez(os.path.join(out, "rank0.npz"), a2t=res["a2t"],
                 **res["traces"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_multihost_demo_two_gloo_ranks_equal_one_process(tmp_path):
    """rank_main in two processes (the tests/test_torch_scaleout.py
    pattern): rank 0's traces and A2T over the two ranks equal one
    process's bit for bit."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port),
                               str(tmp_path)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    assert "cluster up: 2 processes, 2 global devices (gloo)" in logs[0]
    ref = tmd.demo_ensemble(**DEMO_SIZE, **CPU)
    got = np.load(tmp_path / "rank0.npz")
    np.testing.assert_array_equal(got["a2t"], ref["a2t"])
    for k, v in ref["traces"].items():
        np.testing.assert_array_equal(got[k], v, k)


def test_multihost_demo_matches_jax(capsys):
    """demo_ensemble's fields (a torch.Generator seeded 7) through JAX
    evolve_batch in float64 and its A2T: traces and A2T to 1e-8; the
    summary names the ensemble."""
    ours = tmd.demo_ensemble(**DEMO_SIZE, **CPU)
    R, Ls, n = (DEMO_SIZE[k] for k in ("n_realizations", "L", "n_periods"))
    h = draw_disorder_batch(torch.Generator().manual_seed(7), R, Ls, 0.3)
    spec = jsw.SweepSpec(L=Ls, chi=DEMO_SIZE["chi"], n_periods=n, theta=THETA,
                         tp=JTruncParams(chi_max=DEMO_SIZE["chi"], svd_min=1e-7),
                         dtype="float64")
    tr = jsw.evolve_batch(jnp.asarray(h.numpy()), jnp.full((R,), 1.0),
                          jnp.asarray(jsw._basis_indices(Ls, "neel")), spec)
    for k in tr:
        _close(ours["traces"][k], tr[k], TOL, k)
    times = 2.0 * np.arange(n + 1)
    _close(ours["a2t"], [jobs.extract_subharmonic_amplitude(
        times, np.asarray(s), 2.0) for s in tr["staggered_magnetization"]],
        TOL, "A2T")
    tmd.report(ours)
    out = capsys.readouterr().out
    assert f"ensemble: {R} realizations x {n} periods, L={Ls}" in out
    assert "subharmonic A2T: mean" in out


if __name__ == "__main__":
    _demo_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])

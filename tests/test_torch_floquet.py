"""The port's Floquet path: golden traces, frames, the staged evolution, and
parity of the gates and the periodic boundary with the JAX package.

Everything runs in complex128 on the CPU.  The golden fixtures
(tests/golden/*.npz) were generated by the JAX package's float64 path and
checked against the exact statevector oracle at 1e-8; the port is held to
the same 1e-8.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timecrystal_tpu.core import mps as jmps
from timecrystal_tpu.core import observables as jobs
from timecrystal_tpu.core.truncate import TruncParams as JTruncParams
from timecrystal_tpu.models import kicked_ising as jki
from timecrystal_tpu_torch import convert
from timecrystal_tpu_torch.core import mps as tmps
from timecrystal_tpu_torch.core import observables as tobs
from timecrystal_tpu_torch.core.truncate import TruncParams
from timecrystal_tpu_torch.dynamics import tebd
from timecrystal_tpu_torch.models import kicked_ising as tki


GOLDEN = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "golden",
                                       "*.npz")))
IDS = [os.path.basename(p)[:-4] for p in GOLDEN]
C128 = torch.complex128


def _golden_run(path, method, n_periods=None):
    with np.load(path) as z:
        L, chi, n = int(z["L"]), int(z["chi"]), int(z["n"])
        tau, theta, hf = float(z["tau"]), float(z["theta"]), z["h_fields"]
        sz_ref, le_ref = z["sz_sites"], z["loschmidt_echo"]
    n = n if n_periods is None else n_periods
    m = tki.KickedIsingModel(L, 1.0, float(np.max(np.abs(hf))), tau,
                             h_fields=hf, theta=theta, chi=chi, dtype=C128,
                             device="cpu")
    psi0 = tmps.create_initial_state(L, "neel", chi=chi, dtype=C128,
                                     device="cpu")
    tp = TruncParams.reference_hot_path()._replace(svd_method=method)
    tr, times, _ = tebd.CustomFloquet(m, tp).evolve_floquet_traces(psi0, n)
    return tr, sz_ref[:n + 1], le_ref[:n + 1]


@pytest.mark.parametrize("path", GOLDEN, ids=IDS)
def test_golden_trace_native(path):
    tr, sz_ref, le_ref = _golden_run(path, "native")
    np.testing.assert_allclose(tr["sz_sites"], sz_ref, rtol=0, atol=1e-8)
    np.testing.assert_allclose(tr["loschmidt_echo"], le_ref, rtol=0, atol=1e-8)


# periods of each fixture run through the Jacobi twin.  The exact-pi
# fixtures (rank-1 dynamics) hold 1e-8 over their whole length; 10 periods
# keep the test cheap.  The entangling fixture holds 1e-8 through period 3
# only: from period 4 the float64 Jacobi path leaves it by up to 1.7e-4 --
# and so does the JAX package's own 'jacobi' path, digit for digit --
# because reference_hot_path's svd_min=1e-14 keeps singular values whose
# V columns the V-free Jacobi resolves only to eps * sigma_max / sigma.
JACOBI_PERIODS = {"clean_L10": 10, "disordered_L12": 10, "entangling_L10": 3}


@pytest.mark.parametrize("path", GOLDEN, ids=IDS)
def test_golden_trace_jacobi_twin(path):
    n = JACOBI_PERIODS[os.path.basename(path)[:-4]]
    tr, sz_ref, le_ref = _golden_run(path, "jacobi", n)
    np.testing.assert_allclose(tr["sz_sites"], sz_ref, rtol=0, atol=1e-8)
    np.testing.assert_allclose(tr["loschmidt_echo"], le_ref, rtol=0, atol=1e-8)


def _entangling_model(L=8, chi=16, bc="open"):
    hf = tki.draw_disorder_reference(L, 0.3, 5)
    return tki.KickedIsingModel(L, 1.0, 0.3, 1.0, h_fields=hf, bc=bc,
                                theta=0.9 * np.pi, chi=chi, dtype=C128,
                                device="cpu")


def test_strict_and_merged_frames_agree():
    """sz and LE are exact in the half-step frame (H is z-diagonal), so the
    two frames agree to rounding: 1e-12.  The merged frame's final state is
    mapped back through H^{-1} and equals the strict one."""
    m = _entangling_model()
    psi0 = tmps.create_initial_state(m.n_sites, "neel", chi=m.chi,
                                     dtype=C128, device="cpu")
    tp = TruncParams(svd_min=1e-14, svd_method="native")
    ps, ts = tebd.evolve_floquet_scan(psi0, m.gates, 6, tp, frame="strict")
    pm, tm = tebd.evolve_floquet_scan(psi0, m.gates, 6, tp, frame="merged")
    for k in ("sz_sites", "loschmidt_echo"):
        np.testing.assert_allclose(tm[k].numpy(), ts[k].numpy(), rtol=0,
                                   atol=1e-12)
    np.testing.assert_allclose(tmps.to_statevector(pm),
                               tmps.to_statevector(ps), rtol=0, atol=1e-12)
    assert float(ts["trunc_err_boundary"]) == 0.0


def test_sparse_measurement_matches_dense():
    """measure_every=m samples the dense trace (trunc_err included)."""
    m = _entangling_model(L=6, chi=8)
    psi0 = tmps.create_initial_state(6, "neel", chi=8, dtype=C128, device="cpu")
    tp = TruncParams(svd_min=1e-14, svd_method="native")
    _, dense = tebd.evolve_floquet_scan(psi0, m.gates, 6, tp)
    _, sparse = tebd.evolve_floquet_scan(psi0, m.gates, 6, tp,
                                         measure_every=3, measure_phase=0)
    for k in tebd.TRACE_KEYS:
        np.testing.assert_allclose(sparse[k].numpy(), dense[k].numpy()[[0, 3]],
                                   rtol=0, atol=1e-13)
    # zero periods: empty traces of the right shapes, as a length-0 scan
    _, empty = tebd.evolve_floquet_scan(psi0, m.gates, 0, tp)
    assert empty["sz_sites"].shape == (0, 6)
    assert empty["entropies"].shape == (0, 7)


def test_staged_matches_fixed_chi():
    """evolve_floquet_auto escalates 4 -> 8 -> 16 and its traces equal the
    fixed chi=16 run: a staged chunk re-runs whenever it discards more than
    1e-20 of weight (float64), so the two differ by far less than 1e-9."""
    L, chi = 8, 16
    hf = tki.draw_disorder_reference(L, 0.3, 5)
    kw = dict(n_sites=L, J=1.0, h_disorder=0.3, tau=1.0, h_fields=hf,
              theta=0.9 * np.pi, dtype=C128, device="cpu")
    tp = TruncParams(svd_min=1e-12, svd_method="native")
    for frame in ("strict", "merged"):
        tr, times, info, _ = tebd.evolve_floquet_auto(
            kw, "neel", 12, tp, chi_start=4, chi_limit=chi, chunk_periods=4,
            frame=frame)
        assert info["chi_escalations"], "the ladder must be exercised"
        m = tki.KickedIsingModel(chi=chi, **kw)
        psi0 = tmps.create_initial_state(L, "neel", chi=chi, dtype=C128,
                                         device="cpu")
        ref, _, _ = tebd.CustomFloquet(m, tp).evolve_floquet_traces(psi0, 12)
        for k in ("sz_sites", "loschmidt_echo", "staggered_magnetization"):
            np.testing.assert_allclose(tr[k], ref[k], rtol=0, atol=1e-9)
        assert len(times) == 13


@pytest.mark.parametrize("theta,bc", [(np.pi, "open"), (0.9 * np.pi, "open"),
                                      (0.9 * np.pi, "periodic")])
def test_gates_match_jax(theta, bc):
    """Analytic gates from the same fields: float64 cos/sin on both sides
    (1e-15)."""
    hf = tki.draw_disorder_reference(6, 0.3, 9)
    np.testing.assert_array_equal(hf, jki.draw_disorder_reference(6, 0.3, 9))
    gj = jki.make_floquet_gates(1.0, jnp.asarray(hf), 1.2, theta=theta,
                                dtype=jnp.float64, bc=bc)
    gt = tki.make_floquet_gates(1.0, torch.as_tensor(hf), 1.2, theta=theta,
                                dtype=C128, bc=bc)
    got = convert.gates_to_numpy(gt)
    np.testing.assert_allclose(got["bond_re"], np.asarray(gj.bond_gates.re), atol=1e-15)
    np.testing.assert_allclose(got["bond_im"], np.asarray(gj.bond_gates.im), atol=1e-15)
    np.testing.assert_allclose(got["kick_re"], np.asarray(gj.kick.re), atol=1e-15)
    np.testing.assert_allclose(got["kick_im"], np.asarray(gj.kick.im), atol=1e-15)
    if bc == "periodic":
        np.testing.assert_allclose(got["boundary_im"],
                                   np.asarray(gj.boundary_gate.im), atol=1e-15)


def test_periodic_period_matches_jax():
    """One periodic-chain period (boundary bond through the swap network)
    from one state carried across: statevectors equal to 1e-10 (float64
    LAPACK on both sides)."""
    L, chi = 4, 4
    hf = tki.draw_disorder_reference(L, 0.3, 2)
    gj = jki.make_floquet_gates(1.0, jnp.asarray(hf), 1.0, theta=0.9 * np.pi,
                                dtype=jnp.float64, bc="periodic")
    psi_j = jmps.create_initial_state(L, "neel", chi=chi, dtype=jnp.float64)
    out_j, err_j = jki.floquet_period(psi_j, gj, JTruncParams(svd_method="native"))
    gt = tki.make_floquet_gates(1.0, torch.as_tensor(hf), 1.0,
                                theta=0.9 * np.pi, dtype=C128, bc="periodic")
    psi_t = tmps.create_initial_state(L, "neel", chi=chi, dtype=C128,
                                      device="cpu")
    out_t, err_t = tki.floquet_period(psi_t, gt, TruncParams(svd_method="native"))
    np.testing.assert_allclose(tmps.to_statevector(out_t),
                               jmps.to_statevector(out_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(float(err_t), float(err_j), atol=1e-12)


def test_observables_match_jax():
    rng = np.random.default_rng(4)
    times = np.arange(40) * 2.0
    series = np.cos(np.pi * np.arange(40)) + 0.1 * rng.normal(size=40)
    assert tobs.extract_subharmonic_amplitude(times, series, 2.0) == \
        jobs.extract_subharmonic_amplitude(times, series, 2.0)
    sz = rng.normal(size=(3, 5, 6))
    a = tobs.add_derived_magnetization({"sz_sites": sz}, 6)
    b = jobs.add_derived_magnetization({"sz_sites": sz}, 6)
    np.testing.assert_array_equal(a["staggered_magnetization"],
                                  b["staggered_magnetization"])
    np.testing.assert_array_equal(
        tobs.staggered_signs(6, torch.float64, device="cpu").numpy(),
        np.asarray(jobs.staggered_signs(6, jnp.float64)))


def test_unported_options_raise(tmp_path):
    """Every option is ported.  evolve_floquet_auto's checkpoint_dir: a run
    through it, and a second call that only loads it, give the plain run's
    traces bit for bit (kill and resume: tests/test_torch_checkpoint.py).
    with_states is
    ported: it adds the measured states on the host, the last of them the
    final state (and the merged frame refuses it, as in the JAX package).
    correlation_site is ported: it adds zz_corr, the last row of which is
    zz_correlation_profile of the final state."""
    m = _entangling_model(L=4, chi=4)
    psi0 = tmps.create_initial_state(4, "neel", chi=4, dtype=C128, device="cpu")
    psi, tr = tebd.evolve_floquet_scan(psi0, m.gates, 2, TruncParams(),
                                       with_states=True)
    assert tr["states"].B.shape == (2,) + psi0.B.shape
    assert torch.equal(tr["states"].B[-1], psi.B)
    with pytest.raises(ValueError, match="merged"):
        tebd.evolve_floquet_scan(psi0, m.gates, 2, TruncParams(),
                                 with_states=True, frame="merged")
    psi, tr = tebd.evolve_floquet_scan(psi0, m.gates, 2, TruncParams(),
                                       correlation_site=1)
    assert tr["zz_corr"].shape == (2, 4)
    np.testing.assert_allclose(tr["zz_corr"][-1].numpy(),
                               tobs.zz_correlation_profile(psi, 1).numpy(),
                               rtol=0, atol=1e-12)
    mk = dict(n_sites=4, J=1.0, h_disorder=0.3, tau=1.0, disorder_seed=3,
              theta=0.9 * np.pi, device="cpu", dtype=C128)
    ref = tebd.evolve_floquet_auto(mk, "neel", 4, chi_start=2,
                                   chunk_periods=2)[0]
    for _ in range(2):
        out = tebd.evolve_floquet_auto(mk, "neel", 4, chi_start=2,
                                       chunk_periods=2,
                                       checkpoint_dir=str(tmp_path))[0]
        for k in ref:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)

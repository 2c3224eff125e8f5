"""Parity of the port's TDVP (dynamics/tdvp.py) with the JAX package.

Both packages evolve one state under one MPO (built in numpy by the JAX
package and carried over with ``convert.mpo_from_numpy``), in float64 /
complex128 on the CPU, with the JAX side's 'native' (LAPACK) splits.  The
comparison is through gauge-invariant quantities: sigma^z per site, the
Loschmidt echo, the bond entropies and |<psi_jax|psi_port>|^2.

Tolerances: 1e-10 with the port's 'native' splits (the two packages run
the same float64 algorithm; ~1e-15 measured), 1e-8 with the port's
'jacobi' twin (a different SVD of the same theta: its Schmidt vectors agree
to ~eps / gap).  Sizes: L = 6, chi = 8 (full rank, no truncation), dt = 0.1.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

import jax.numpy as jnp

from timecrystal_tpu.core import mps as jmps
from timecrystal_tpu.core import observables as jobs
from timecrystal_tpu.dynamics import tdvp as jtdvp
from timecrystal_tpu_torch import convert
from timecrystal_tpu_torch.core import mps as tmps
from timecrystal_tpu_torch.core import observables as tobs
from timecrystal_tpu_torch.core.truncate import TruncParams
from timecrystal_tpu_torch.dynamics import tdvp as ttdvp
from timecrystal_tpu_torch.models.kicked_ising import KickedIsingModel

C128 = torch.complex128
L, CHI, DT = 6, 8, 0.1


@pytest.fixture(scope="module")
def mpos():
    jm = jtdvp.spin_chain_mpo(L, Jz=1.0, hx=0.6, hz=0.2, dtype=jnp.float64)
    return jm, convert.mpo_from_numpy(np.asarray(jm.W.re), np.asarray(jm.W.im),
                                      device="cpu")


@pytest.fixture(scope="module")
def jax_two_site(mpos):
    """The JAX package's two-site run: 3 steps from the Neel state."""
    eng = jtdvp.TDVPEvolution(mpos[0], dt=DT, max_chi=CHI)
    psi0 = jmps.create_initial_state(L, "neel", chi=CHI, dtype=jnp.float64)
    states, _, info = eng.evolve(psi0, total_time=3 * DT)
    return states, info


def _port(psi_j):
    return convert.mps_from_numpy(np.asarray(psi_j.B.re), np.asarray(psi_j.B.im),
                                  np.asarray(psi_j.lam), device="cpu")


def _assert_same_state(psi_j, psi_t, tol):
    pj = _port(psi_j)
    np.testing.assert_allclose(tobs.sz_sites(psi_t).numpy(),
                               np.asarray(jobs.sz_sites(psi_j)), rtol=0, atol=tol)
    np.testing.assert_allclose(tmps.entanglement_entropy(psi_t).numpy(),
                               np.asarray(jmps.entanglement_entropy(psi_j)),
                               rtol=0, atol=tol)
    fid = float(tobs.calculate_loschmidt_echo(pj, psi_t))
    assert abs(fid - 1.0) < tol, fid


def test_mpo_builders_match_jax(mpos):
    jm, tm = mpos
    port = ttdvp.spin_chain_mpo(L, Jz=1.0, hx=0.6, hz=0.2, dtype=C128,
                                device="cpu")
    assert torch.equal(port.W, tm.W) and port.Dw == jm.Dw == 3
    np.testing.assert_array_equal(convert.mpo_to_numpy(port)[0],
                                  np.asarray(jm.W.re))
    h = np.array([0.1, -0.2, 0.3, 0.05])
    ji = jtdvp.ising_fields_mpo(4, 1.0, h, dtype=jnp.float64)
    ti = ttdvp.ising_fields_mpo(4, 1.0, h, dtype=C128, device="cpu")
    np.testing.assert_array_equal(ti.W.numpy().real, np.asarray(ji.W.re))
    np.testing.assert_array_equal(ti.W.numpy().imag, np.asarray(ji.W.im))


@pytest.mark.parametrize("svd_method,tol", [("native", 1e-10), ("jacobi", 1e-8)])
def test_two_site_evolve_matches_jax(mpos, jax_two_site, svd_method, tol):
    states_j, info_j = jax_two_site
    eng = ttdvp.TDVPEvolution(mpos[1], dt=DT, max_chi=CHI,
                              trunc_params={"svd_method": svd_method},
                              device="cpu")
    psi0 = tmps.create_initial_state(L, "neel", chi=CHI, dtype=C128,
                                     device="cpu")
    states_t, times, info_t = eng.evolve(psi0, total_time=3 * DT)
    assert len(states_t) == len(states_j) == 4
    np.testing.assert_allclose(times, [0.0, 0.1, 0.2, 0.3], atol=1e-15)
    for pj, pt in zip(states_j[1:], states_t[1:]):
        _assert_same_state(pj, pt, tol)
        le_j = float(jobs.calculate_loschmidt_echo(states_j[0], pj))
        le_t = float(tobs.calculate_loschmidt_echo(psi0, pt))
        assert abs(le_t - le_j) < tol
    assert info_t["bond_dimensions"] == info_j["bond_dimensions"]
    assert info_t["max_chi_reached"] == info_j["max_chi_reached"] > 1
    assert info_t["algorithm"] == "TDVP (two_site)"
    assert abs(info_t["truncation_errors"] - info_j["truncation_errors"]) < tol


def test_single_site_step_matches_jax(mpos, jax_two_site):
    """From the entangled two-site state (full occupied rank), two
    single-site steps of TDVPEvolution on both sides."""
    psi_j = jax_two_site[0][-1]
    psi_t = _port(psi_j)
    eng_j = jtdvp.TDVPEvolution(mpos[0], dt=DT, tdvp_type="single_site")
    eng_t = ttdvp.TDVPEvolution(mpos[1], dt=DT, tdvp_type="single_site",
                                device="cpu")
    for _ in range(2):
        psi_j, _ = eng_j.step(psi_j)
        psi_t, err = eng_t.step(psi_t)
    assert float(err) == 0.0
    _assert_same_state(psi_j, psi_t, 1e-10)
    np.testing.assert_allclose(psi_t.lam.numpy(), np.asarray(psi_j.lam),
                               rtol=0, atol=1e-10)


def test_lanczos_matches_dense_expm():
    """exp(-i dt H) v against scipy's expm on a random Hermitian H (n = 24,
    Krylov dimension 20): 1e-8, the JAX package's own bound.  An eigenvector
    start breaks down after one step; the masked result is exactly
    exp(-i dt lambda) v (1e-12)."""
    rng = np.random.default_rng(3)
    n = 24
    H = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    H = (H + H.conj().T) / 2
    v = rng.normal(size=n) + 1j * rng.normal(size=n)
    Ht = torch.as_tensor(H)
    mv = lambda x: (Ht @ x.reshape(n)).reshape(x.shape)   # noqa: E731
    for dt in (0.05, 0.3):
        got = ttdvp.lanczos_expm_apply(mv, torch.as_tensor(v.reshape(n, 1, 1)),
                                       dt, 20, sign=-1.0)
        ref = scipy.linalg.expm(-1j * dt * H) @ v
        assert np.max(np.abs(got.numpy().reshape(n) - ref)) < 1e-8, dt
    w, V = np.linalg.eigh(H)
    got = ttdvp.lanczos_expm_apply(mv, torch.as_tensor(V[:, 3]), 0.2, 6,
                                   sign=+1.0)
    np.testing.assert_allclose(got.numpy(), np.exp(0.2j * w[3]) * V[:, 3],
                               atol=1e-12)


def test_floquet_via_tdvp_matches_port_gates():
    """TDVPFloquetEvolution (two-site, full rank, fine dt) realizes the same
    period as the port's gate path (KickedIsingModel.floquet_step): the Ising half-step
    is diagonal, and the MPO carries the gate path's doubled interior
    fields.  |<gate|tdvp>|^2 within 1e-8 of 1 (the JAX package's bound)."""
    m = KickedIsingModel(L, 1.0, 0.3, 0.8, disorder_seed=4, chi=CHI,
                         dtype=C128, device="cpu")
    psi0 = tmps.create_initial_state(L, "neel", chi=CHI, dtype=C128,
                                     device="cpu")
    tp = TruncParams(svd_min=1e-14, svd_method="native")
    psi_gate = m.floquet_step(psi0, tp)
    tfe = ttdvp.TDVPFloquetEvolution(m, dt=0.2, max_chi=CHI, device="cpu")
    eff = m.h_fields.copy()
    eff[1:-1] *= 2.0
    assert torch.equal(tfe.mpo.W, ttdvp.ising_fields_mpo(
        L, 1.0, eff, dtype=C128, device="cpu").W)
    psi_tdvp = tfe.evolve_floquet_period(psi0)
    assert abs(float(tobs.calculate_loschmidt_echo(psi_gate, psi_tdvp)) - 1) < 1e-8
    out = tfe.benchmark_vs_tebd([4], n_periods=1)
    assert set(out) == {"tebd_times", "tdvp_times", "tebd_chi_max",
                        "tdvp_chi_max", "speedup", "error"}
    assert out["error"][4] < 1e-8


def test_entry_points_refuse_what_they_do_not_run():
    with pytest.raises(ValueError):
        ttdvp.TDVPEvolution(None, tdvp_type="three_site", device="cpu")
    mpo = ttdvp.spin_chain_mpo(4, dtype=C128, device="cpu")
    batch = tmps.product_state(np.zeros((2, 4), np.int32), chi=2, dtype=C128,
                               device="cpu")
    with pytest.raises(ValueError, match="one chain"):
        ttdvp.tdvp2_step(batch, mpo, DT, 4, TruncParams())
    m = KickedIsingModel(4, 1.0, 0.3, 0.8, bc="periodic", chi=4, dtype=C128,
                         device="cpu")
    with pytest.raises(NotImplementedError):
        ttdvp.TDVPFloquetEvolution(m, device="cpu")

"""Parity of the port's long-range kicked-Ising model (models/long_range.py)
with the JAX package and with the dense diagonal-phase oracle.

The power-law fit is host numpy on both sides, so it and the FSM MPO must
agree to 1e-12.  ``LongRangeKickedIsing.evolve`` at L = 6, chi = 8 (full
rank), 4 periods, complex128 on the CPU: port against JAX traces at 1e-8
(the same float64 TDVP; ~1e-15 measured) and against
``tests/exact_reference.long_range_floquet_unitary`` on the fitted
couplings at 1e-8 (at full rank with a diagonal H_z the integrator is
exact up to Lanczos accuracy; ~1e-15 measured).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.exact_reference import (long_range_floquet_unitary, neel_indices,
                                   product_statevector, sz_expectations)
from timecrystal_tpu.core import mps as jmps
from timecrystal_tpu.models import long_range as jlr
from timecrystal_tpu_torch.core import mps as tmps
from timecrystal_tpu_torch.models import long_range as tlr

C128 = torch.complex128
L, CHI, ALPHA, TAU, N = 6, 8, 1.3, 0.4, 4


def _oracle(h_fields, couplings, n_periods, theta=np.pi):
    U = long_range_floquet_unitary(L, couplings, h_fields, TAU, theta=theta)
    psi = product_statevector(neel_indices(L))
    psi0 = psi.copy()
    sz, le = [sz_expectations(psi, L)], [1.0]
    for _ in range(n_periods):
        psi = U @ psi
        sz.append(sz_expectations(psi, L))
        le.append(abs(np.vdot(psi0, psi)) ** 2)
    return np.asarray(sz), np.asarray(le)


@pytest.mark.parametrize("alpha", [0.5, 1.5, 3.0, None])
def test_fit_and_fsm_mpo_match_jax(alpha):
    if alpha is not None:
        cj, lj, rj = jlr.fit_power_law_exponentials(alpha, 11, n_exp=12)
        ct, lt, rt = tlr.fit_power_law_exponentials(alpha, 11, n_exp=12)
        np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-12 * np.abs(cj).max())
        np.testing.assert_array_equal(lt, lj)
        assert abs(rt - rj) < 1e-12
    np.testing.assert_allclose(tlr.fitted_couplings(12, 1.3, alpha),
                               jlr.fitted_couplings(12, 1.3, alpha), atol=1e-12)
    np.testing.assert_array_equal(tlr.power_law_couplings(12, 1.3, alpha),
                                  jlr.power_law_couplings(12, 1.3, alpha))
    h = np.random.default_rng(3).uniform(-0.4, 0.4, L)
    mj, ej = jlr.long_range_ising_mpo(L, 1.0, alpha, h, n_exp=10,
                                      dtype=jnp.float64)
    mt, et = tlr.long_range_ising_mpo(L, 1.0, alpha, h, n_exp=10, dtype=C128,
                                      device="cpu")
    assert mt.Dw == mj.Dw and abs(et - ej) < 1e-12
    np.testing.assert_allclose(mt.W.numpy().real, np.asarray(mj.W.re), atol=1e-12)
    np.testing.assert_allclose(mt.W.numpy().imag, np.asarray(mj.W.im), atol=1e-12)


def test_fsm_mpo_input_checks():
    SZ = np.diag([1.0, -1.0])
    with pytest.raises(ValueError):
        tlr.build_fsm_mpo(4, [(1.0, 0.5, SZ, SZ)], [SZ] * 3, device="cpu")
    with pytest.raises(ValueError):
        tlr.fit_power_law_exponentials(-1.0, 32)


def test_evolve_matches_jax_and_the_dense_oracle():
    jm = jlr.LongRangeKickedIsing(L, 1.0, 0.3, TAU, alpha=ALPHA,
                                  disorder_seed=42, chi=CHI, substeps=2,
                                  dtype=jnp.float64)
    tr_j, times_j, _ = jm.evolve(
        jmps.create_initial_state(L, "neel", chi=CHI, dtype=jnp.float64), N)
    tm = tlr.LongRangeKickedIsing(L, 1.0, 0.3, TAU, alpha=ALPHA,
                                  disorder_seed=42, chi=CHI, substeps=2,
                                  dtype=C128, device="cpu")
    np.testing.assert_array_equal(tm.h_fields, jm.h_fields)
    tr_t, times_t, info = tm.evolve(
        tmps.create_initial_state(L, "neel", chi=CHI, dtype=C128,
                                  device="cpu"), N)
    np.testing.assert_allclose(times_t, times_j, atol=1e-15)
    for k in ("sz_sites", "magnetization", "staggered_magnetization",
              "loschmidt_echo"):
        np.testing.assert_allclose(tr_t[k], np.asarray(tr_j[k]), rtol=0,
                                   atol=1e-8, err_msg=k)
    sz, le = _oracle(tm.h_fields, tlr.fitted_couplings(L, 1.0, ALPHA), N)
    np.testing.assert_allclose(tr_t["sz_sites"], sz, rtol=0, atol=1e-8)
    np.testing.assert_allclose(tr_t["loschmidt_echo"], le, rtol=0, atol=1e-8)
    assert info["fit_rel_err"] < 1e-3
    assert info["algorithm"] == "TDVP (two_site) long-range Floquet"


def test_jacobi_twin_period_matches_the_oracle():
    """The chip's route -- two-site splits through the V-accumulating
    Jacobi twin -- with a generalized kick, two periods.  Against the
    'native' splits: 1e-8 (a different SVD of the same thetas; 6e-15
    measured).  Against the oracle: 2e-5, because theta != pi leaves a
    genuine TDVP splitting error (3.1e-6 measured here; the JAX package
    bounds it at 5e-5 over 5 periods, tests/test_long_range.py)."""
    theta = 0.92 * np.pi
    tm = tlr.LongRangeKickedIsing(L, 1.0, 0.2, TAU, alpha=2.0,
                                  disorder_seed=7, theta=theta, chi=CHI,
                                  substeps=2, dtype=C128, device="cpu")
    psi = tmps.create_initial_state(L, "neel", chi=CHI, dtype=C128,
                                    device="cpu")
    native, jac = psi, psi
    for _ in range(2):
        native = tm.floquet_step(native)
        jac = tm.floquet_step(jac, {"svd_method": "jacobi"})
    assert tm._engine.trunc_params.svd_method == "auto"   # override undone
    sz_n = tmps.expectation_one_site(native, torch.as_tensor(
        np.diag([1.0, -1.0]), dtype=C128)).real.numpy()
    sz_j = tmps.expectation_one_site(jac, torch.as_tensor(
        np.diag([1.0, -1.0]), dtype=C128)).real.numpy()
    np.testing.assert_allclose(sz_j, sz_n, rtol=0, atol=1e-8)
    sz, _ = _oracle(tm.h_fields, tlr.fitted_couplings(L, 1.0, 2.0), 2,
                    theta=theta)
    np.testing.assert_allclose(sz_j, sz[-1], rtol=0, atol=2e-5)


def test_scan_interaction_range():
    """The interaction-range scan: A2T stays on the DTC plateau for the
    exact pi kick at every range, including the nearest-neighbor limit."""
    out = tlr.scan_interaction_range([1.5, None], L=L, n_periods=10,
                                     n_realizations=1, chi=CHI, substeps=1,
                                     dtype=C128, device="cpu")
    assert out["a2t"].shape == (2,) and out["a2t_all"].shape == (2, 1)
    assert np.all(out["a2t"] > 0.9)
    assert out["fit_rel_err"][1] == 0.0 and out["fit_rel_err"][0] > 0.0

"""The rest of the port's TEBD layer against the JAX package: the gate
helpers, ``KickedIsingModel.evolve`` / ``get_hamiltonian_terms`` /
``calculate_phase_diagram_point``, the state history of
``CustomFloquet.evolve_floquet``, the two-time correlator (its own function
and ``evolve_batch``'s ``two_time_anchor``), the generic Suzuki-Trotter
TEBD and the imaginary-time ground state.

Same inputs on both sides, the port in complex128 on the CPU, the JAX
package in float64; LAPACK ('auto' on the CPU) in both.  Traces and states
to 1e-8, ground-state energies to 1e-7 with the same convergence flags.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from tests.exact_reference import _kron_at
from timecrystal_tpu.core import gates as jgates
from timecrystal_tpu.core.mps import create_initial_state as jax_state
from timecrystal_tpu.core.mps import to_statevector as jax_vector
from timecrystal_tpu.core.truncate import TruncParams as JTruncParams
from timecrystal_tpu.dynamics import ground_state as jgs
from timecrystal_tpu.dynamics import tebd as jtebd
from timecrystal_tpu.models.kicked_ising import KickedIsingModel as JModel
from timecrystal_tpu.parallel import sweep as jsw
from timecrystal_tpu_torch.core import gates as tgates
from timecrystal_tpu_torch.core.mps import create_initial_state, to_statevector
from timecrystal_tpu_torch.core.truncate import TruncParams
from timecrystal_tpu_torch.dynamics import ground_state as tgs
from timecrystal_tpu_torch.dynamics import tebd as ttebd
from timecrystal_tpu_torch.models.kicked_ising import KickedIsingModel
from timecrystal_tpu_torch.parallel import sweep as tsw

C128 = torch.complex128
TOL = 1e-8


def _models(L=8, chi=16, theta=0.9 * np.pi, bc="open", seed=5):
    kw = dict(J=1.0, h_disorder=0.3, tau=1.1, bc=bc, disorder_seed=seed,
              theta=theta, chi=chi)
    return (JModel(L, dtype=jnp.float64, **kw),
            KickedIsingModel(L, dtype=C128, device="cpu", **kw))


def _states(L=8, chi=16):
    return (jax_state(L, "neel", chi=chi, dtype=jnp.float64),
            create_initial_state(L, "neel", chi=chi, dtype=C128, device="cpu"))


def _vec_err(jpsi, tpsi):
    """max |d| of the two states' dense vectors (gauge-free)."""
    return float(np.max(np.abs(np.asarray(jax_vector(jpsi))
                               - to_statevector(tpsi))))


def test_gate_helpers_match_jax():
    """Pauli constants, the dense bond Hamiltonian, expm at a real and an
    imaginary time, and the intended gate set."""
    for name in ("SIGMA_X", "SIGMA_Y", "SIGMA_Z", "SIGMA_I"):
        np.testing.assert_array_equal(getattr(tgates, name), getattr(jgates, name))
    H = tgates.two_site_hamiltonian(0.7, 0.3, -0.2)
    np.testing.assert_array_equal(H, jgates.two_site_hamiltonian(0.7, 0.3, -0.2))
    for t in (0.4, -0.3j):
        np.testing.assert_allclose(tgates.expm_two_site(H, t),
                                   np.asarray(jgates.expm_two_site(H, t)),
                                   rtol=0, atol=1e-14)
    a = tgates.create_time_evolution_gates(1.0, 0.4, 0.8, 6)
    b = jgates.create_time_evolution_gates(1.0, 0.4, 0.8, 6)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-14)


@pytest.mark.parametrize("bc,theta", [("open", np.pi),
                                      ("periodic", 0.9 * np.pi)])
def test_hamiltonian_terms_match_jax(bc, theta):
    jm, tm = _models(L=5, chi=4, theta=theta, bc=bc)
    a, b = tm.get_hamiltonian_terms(), jm.get_hamiltonian_terms()
    assert set(a) == set(b) and len(a["ising_gates"]) == len(b["ising_gates"])
    np.testing.assert_array_equal(a["h_fields"], b["h_fields"])
    np.testing.assert_allclose(a["pi_pulse"], b["pi_pulse"], rtol=0, atol=TOL)
    for x, y in zip(a["ising_gates"], b["ising_gates"]):
        np.testing.assert_allclose(x, y, rtol=0, atol=TOL)


def test_calculate_phase_diagram_point_matches_jax():
    """The record, with the reference's unit-spaced subharmonic bins kept."""
    jm, tm = _models()
    jp, tp = _states()
    a = tm.calculate_phase_diagram_point(tp, n_steps=10)
    b = jm.calculate_phase_diagram_point(jp, n_steps=10)
    assert set(a) == set(b)
    for k in b:
        assert abs(a[k] - b[k]) < TOL, (k, a[k], b[k])


@pytest.mark.parametrize("m,n", [(1, 6), (2, 6), (4, 6)])
def test_evolve_floquet_states_match_jax(m, n):
    """with_states through CustomFloquet.evolve_floquet: measure_every 1, 2
    (in-loop storage) and 4 (does not divide: every period stored, then
    subsampled); states on the host, equal as vectors."""
    jm, tm = _models()
    jp, tp = _states()
    js, jt, jinfo = jtebd.CustomFloquet(jm, JTruncParams(svd_min=1e-12)) \
        .evolve_floquet(jp, n, measure_every=m)
    ts, tt, tinfo = ttebd.CustomFloquet(tm, TruncParams(svd_min=1e-12)) \
        .evolve_floquet(tp, n, measure_every=m)
    assert tt == jt and len(ts) == len(js)
    assert tinfo["bond_dimensions"] == jinfo["bond_dimensions"]
    assert max(tinfo["bond_dimensions"]) > 1, "the kick must entangle"
    assert all(s.device.type == "cpu" for s in ts)
    assert max(_vec_err(a, b) for a, b in zip(js, ts)) < TOL


def test_kicked_ising_evolve_fetches_in_chunks():
    """KickedIsingModel.evolve: every period's state on the host, equal to
    the JAX package's, and the fetch chunk changes nothing."""
    jm, tm = _models(L=6, chi=8)
    jp, tp = _states(L=6, chi=8)
    js, jt = jm.evolve(jp, 5)
    ts, tt = tm.evolve(tp, 5, fetch_every=2)
    ts1, _ = tm.evolve(tp, 5)
    assert tt == jt and len(ts) == len(js) == 6
    assert max(_vec_err(a, b) for a, b in zip(js, ts)) < TOL
    for a, b in zip(ts, ts1):
        assert torch.equal(a.B, b.B) and torch.equal(a.lam, b.lam)


@pytest.mark.parametrize("frame", ["strict", "merged"])
def test_evolve_two_time_zz_matches_jax(frame):
    """psi and sz_3 psi as one pair, truncated at chi_max 4: zz2t, psi's
    max_chi, psi's plus phi's trunc_err and the boundary error, to 1e-8."""
    jm, tm = _models()
    jp, tp = _states()
    tp_j = JTruncParams(chi_max=4, svd_min=1e-12)
    _, jtr = jtebd.evolve_two_time_zz(jp, jm.gates, 6, tp_j, anchor=3,
                                      frame=frame, measure_every=2)
    psi, ttr = ttebd.evolve_two_time_zz(tp, tm.gates, 6, TruncParams(
        chi_max=4, svd_min=1e-12), anchor=3, frame=frame, measure_every=2)
    assert set(ttr) == set(jtr) and psi.lead == ()
    for k in jtr:
        np.testing.assert_allclose(ttr[k].numpy(), np.asarray(jtr[k]), rtol=0,
                                   atol=TOL, err_msg=k)
    assert float(ttr["trunc_err"].max()) > 1e-6, "chi_max 4 must truncate"


@pytest.mark.parametrize("frame", ["strict", "merged"])
def test_evolve_batch_two_time_anchor_matches_jax(frame):
    """evolve_batch(two_time_anchor=3) at L=8: zz2t_re / zz2t_im with the
    t=0 row, and every other trace psi's."""
    rng = np.random.default_rng(3)
    R, L = 2, 8
    h, taus = rng.uniform(-0.3, 0.3, (R, L)), np.array([1.0, 1.2])
    basis = jsw._basis_indices(L, "neel")
    kw = dict(L=L, chi=8, n_periods=5, theta=0.9 * np.pi, dtype="float64",
              frame=frame)
    tj = jsw.evolve_batch(jnp.asarray(h), jnp.asarray(taus), jnp.asarray(basis),
                          jsw.SweepSpec(tp=JTruncParams(svd_min=1e-12), **kw),
                          two_time_anchor=3)
    tt = tsw.evolve_batch(h, taus, basis,
                          tsw.SweepSpec(tp=TruncParams(svd_min=1e-12), **kw),
                          two_time_anchor=3, device="cpu")
    assert set(tt) == set(tj)
    for k in tj:
        assert tt[k].shape == np.asarray(tj[k]).shape, k
        np.testing.assert_allclose(tt[k], np.asarray(tj[k]), rtol=0, atol=TOL,
                                   err_msg=k)
    assert tt["zz2t_re"].shape == (R, 6, L)


def _dense_H(model, L):
    H = np.zeros((2**L, 2**L), dtype=complex)
    for b in range(L - 1):
        H += _kron_at(model.bond_H[b].reshape(4, 4), [b, b + 1], L)
    return H


def test_tebd_evolution_matches_dense_and_jax():
    """Order-2 Trotter on a transverse-field chain: the final state against
    the dense expm (Trotter error ~ dt^2 T) and every stored state against
    the JAX package's to 1e-8; the traces path against the states path;
    the info, benchmark and Suzuki-Trotter contracts."""
    L, chi = 6, 16
    kw = dict(Jz=1.0, hx=0.6, hz=0.2)
    jnn, tnn = jtebd.spin_chain_model(L, **kw), ttebd.spin_chain_model(L, **kw)
    np.testing.assert_array_equal(tnn.bond_H, jnn.bond_H)
    jp, tp = _states(L, chi)
    trunc = {"svd_min": 1e-14}
    js, jt, jinfo = jtebd.TEBDEvolution(jnn, dt=0.05, max_chi=chi,
                                        trunc_params=trunc).evolve(jp, 0.5)
    eng = ttebd.TEBDEvolution(tnn, dt=0.05, max_chi=chi, trunc_params=trunc)
    ts, tt, tinfo = eng.evolve(tp, 0.5)
    assert tt == jt and tinfo["n_steps"] == jinfo["n_steps"] == 10
    assert set(tinfo) == set(jinfo)
    assert max(_vec_err(a, b) for a, b in zip(js, ts)) < TOL
    assert abs(tinfo["truncation_errors"] - jinfo["truncation_errors"]) < TOL
    np.testing.assert_allclose(tinfo["entanglement_entropies"][-1],
                               jinfo["entanglement_entropies"][-1], atol=TOL)
    vec = scipy.linalg.expm(-1j * _dense_H(tnn, L) * tt[-1]) @ to_statevector(tp)
    assert abs(abs(np.vdot(vec, to_statevector(ts[-1]))) - 1.0) < 1e-3

    traces, info = eng.evolve_traces(tp, 0.5)
    np.testing.assert_allclose(traces["entropies"][-1],
                               tinfo["entanglement_entropies"][-1], atol=1e-10)
    assert info["n_steps"] == 10
    out = eng.benchmark_performance(tp, n_steps=2)
    assert set(out) == {"wall_time", "steps_per_second", "final_bond_dim",
                        "memory_usage", "truncation_error"}
    terms = {"zz": np.kron(np.diag([1., -1.]), np.diag([1., -1.])),
             "single_site_terms": np.eye(2)}
    g = eng.suzuki_trotter_gates(terms, 0.1)
    assert len(g) == 1
    np.testing.assert_allclose(g[0], scipy.linalg.expm(-1j * 0.1 * terms["zz"]),
                               atol=1e-12)


@pytest.mark.parametrize("kw", [dict(Jz=1.0, hx=0.7),
                                dict(Jx=1.0, Jy=1.0, Jz=1.0)],
                         ids=["tfim", "heisenberg"])
def test_find_ground_state_matches_jax(kw):
    """L=8, chi=16, the dt ladder (0.1, 0.01, 1e-3) from the same numpy-seeded
    Haar product start: energies to 1e-7 and the same convergence flags."""
    _, Ej, ij = jgs.find_ground_state(jtebd.spin_chain_model(8, **kw), chi=16,
                                      dtype=jnp.float64)
    _, Et, it = tgs.find_ground_state(ttebd.spin_chain_model(8, **kw), chi=16,
                                      dtype=C128, device="cpu")
    assert abs(Et - Ej) < 1e-7, (Et, Ej)
    assert abs(it["energy_extrapolated"] - ij["energy_extrapolated"]) < 1e-7
    assert it["converged"] == ij["converged"] and all(it["converged"])
    assert it["n_steps"] == ij["n_steps"]


def test_no_refusal_names_the_ported_items():
    """The items this slice ports appear in no refusal of the port."""
    from pathlib import Path

    import timecrystal_tpu_torch

    root = Path(timecrystal_tpu_torch.__file__).parent
    for path in root.rglob("*.py"):
        text = path.read_text()
        assert "'The rest of tebd.py'" not in text, path
        assert "'Other dynamics'" not in text, path

"""Parity of the port's batched two-site update with the JAX package.

One entangled state is made by the JAX package (float64 pairs), carried to
the port with ``timecrystal_tpu_torch.convert`` (complex128), and both
packages apply the same gates.  Lambdas and discarded weights are
gauge-invariant and compared directly; B tensors are compared through the
dense statevector (the SVD's per-column phase is a gauge freedom).

Tolerance 1e-10: float64 on both sides; the two LAPACK calls (numpy via
jax vs torch) agree to ~1e-14, and the Jacobi paths to ~1e-13
(test_torch_jacobi.py); 1e-10 leaves room for the eps/gap amplification
of near-degenerate Schmidt values without hiding any algebra mistake,
which shows at O(1e-2) and above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timecrystal_tpu.core import mps as jmps
from timecrystal_tpu.core import truncate as jtr
from timecrystal_tpu.models import kicked_ising as jki
from timecrystal_tpu.ops.cpx import C
from timecrystal_tpu_torch import convert
from timecrystal_tpu_torch.core import mps as tmps
from timecrystal_tpu_torch.core import truncate as ttr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs beside other worker processes on shared cores; torch's
    default intra-op thread pool would oversubscribe them and spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-10
L, CHI = 6, 8


def _jax_state():
    """Neel at chi=8 after two entangling periods (theta = 0.9 pi)."""
    hf = jki.draw_disorder_reference(L, 0.3, 3)
    g = jki.make_floquet_gates(1.0, jnp.asarray(hf), 0.9, theta=0.9 * np.pi,
                               dtype=jnp.float64)
    tp = jtr.TruncParams(svd_method="native")
    psi = jmps.create_initial_state(L, "neel", chi=CHI, dtype=jnp.float64)
    for _ in range(2):
        psi, _ = jki.floquet_period(psi, g, tp)
    return psi


def _random_gates(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(L - 1):
        q, _ = np.linalg.qr(rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4)))
        out.append(q.reshape(2, 2, 2, 2))
    return np.stack(out)


def _to_port(psi):
    return convert.mps_from_numpy(np.asarray(psi.B.re), np.asarray(psi.B.im),
                                  np.asarray(psi.lam), device="cpu")


@pytest.mark.parametrize("start", [0, 1])
@pytest.mark.parametrize("chi_max", [0, 3])
def test_apply_bond_gates_matches_jax(start, chi_max):
    """Both parities, untruncated and truncated to chi_max=3 (real
    discarded weight, renormalized)."""
    psi_j = _jax_state()
    G = _random_gates(start + 10 * chi_max)
    tp = dict(chi_max=chi_max, svd_min=1e-12, svd_method="native")
    out_j, err_j = jtr.apply_bond_gates(
        psi_j, C(jnp.asarray(G.real), jnp.asarray(G.imag)), start,
        jtr.TruncParams(**tp))
    out_t, err_t = ttr.apply_bond_gates(
        _to_port(psi_j), torch.as_tensor(G), start, ttr.TruncParams(**tp))
    np.testing.assert_allclose(out_t.lam.numpy(), np.asarray(out_j.lam),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(float(err_t), float(err_j), rtol=0, atol=TOL)
    if chi_max:
        assert float(err_t) > 1e-6          # the truncation is real
    np.testing.assert_allclose(tmps.to_statevector(out_t),
                               jmps.to_statevector(out_j), rtol=0, atol=TOL)


def test_apply_bond_gates_jacobi_matches_jax():
    """The 'jacobi' method on both sides: the port's torch twin against the
    Pallas kernel in interpret mode (n = 2 chi = 16)."""
    psi_j = _jax_state()
    G = _random_gates(7)
    tp = dict(svd_min=1e-12, svd_method="jacobi")
    out_j, err_j = jtr.apply_bond_gates(
        psi_j, C(jnp.asarray(G.real), jnp.asarray(G.imag)), 1,
        jtr.TruncParams(**tp))
    out_t, err_t = ttr.apply_bond_gates(
        _to_port(psi_j), torch.as_tensor(G), 1, ttr.TruncParams(**tp))
    np.testing.assert_allclose(out_t.lam.numpy(), np.asarray(out_j.lam),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(tmps.to_statevector(out_t),
                               jmps.to_statevector(out_j), rtol=0, atol=TOL)


@pytest.mark.parametrize("start", [0, 1])
def test_batched_matches_single_bond(start):
    """apply_bond_gates (batched) and apply_single_bond_gate
    (bond_update_core) duplicate the update algebra on purpose; this pins
    them together.  Same arithmetic, different batching: 1e-13."""
    psi = _to_port(_jax_state())
    G = torch.as_tensor(_random_gates(3))
    tp = ttr.TruncParams(chi_max=5, svd_min=1e-12, svd_method="native")
    batched, err_b = ttr.apply_bond_gates(psi, G, start, tp)
    single, err_s = psi, torch.zeros((), dtype=torch.float64)
    for b in range(start, L - 1, 2):
        single, e = ttr.apply_single_bond_gate(single, G[b], b, tp)
        err_s = err_s + e
    np.testing.assert_allclose(batched.lam.numpy(), single.lam.numpy(),
                               atol=1e-13)
    np.testing.assert_allclose(batched.B.numpy(), single.B.numpy(), atol=1e-13)
    np.testing.assert_allclose(float(err_b), float(err_s), atol=1e-15)


def test_ensemble_axis_matches_single_chains():
    """A leading ensemble axis (folded into the bond batch of one SVD call)
    gives each chain's single-chain result: 1e-13."""
    psi = _to_port(_jax_state())
    G1 = torch.as_tensor(_random_gates(1))
    G2 = torch.as_tensor(_random_gates(2))
    tp = ttr.TruncParams(chi_max=5, svd_min=1e-12, svd_method="native")
    both = tmps.MPS(B=torch.stack([psi.B, psi.B]),
                    lam=torch.stack([psi.lam, psi.lam]))
    out, err = ttr.apply_bond_gates(both, torch.stack([G1, G2]), 0, tp)
    for r, G in enumerate((G1, G2)):
        one, e = ttr.apply_bond_gates(psi, G, 0, tp)
        np.testing.assert_allclose(out.B[r].numpy(), one.B.numpy(), atol=1e-13)
        np.testing.assert_allclose(out.lam[r].numpy(), one.lam.numpy(),
                                   atol=1e-13)
        np.testing.assert_allclose(float(err[r]), float(e), atol=1e-15)


def test_apply_two_site_gate_matches_jax():
    """Single-bond API, (right, left) site order included."""
    psi_j = _jax_state()
    G = _random_gates(5)[0].reshape(4, 4)
    out_j = jtr.apply_two_site_gate(psi_j, G, 3, 2,
                                    jtr.TruncParams(svd_method="native"))
    out_t = ttr.apply_two_site_gate(_to_port(psi_j), G, 3, 2,
                                    ttr.TruncParams(svd_method="native"))
    np.testing.assert_allclose(tmps.to_statevector(out_t),
                               jmps.to_statevector(out_j), rtol=0, atol=TOL)


def test_truncation_mask_matches_jax():
    S = np.array([[1.0, 0.5, 1e-3, 1e-6, 1e-9, 0.0]])
    for tp in (dict(chi_max=3), dict(svd_min=1e-5), dict(trunc_cut=1e-4),
               dict(chi_max=4, svd_min=1e-8, trunc_cut=2e-3)):
        mj = np.asarray(jtr.truncation_mask(jnp.asarray(S), 6,
                                            jtr.TruncParams(**tp)))
        mt = ttr.truncation_mask(torch.as_tensor(S), 6,
                                 ttr.TruncParams(**tp)).numpy()
        np.testing.assert_array_equal(mt, mj)


def test_convert_round_trip():
    """State carried across and back is bit-identical."""
    psi_j = _jax_state()
    B_re, B_im, lam = convert.mps_to_numpy(_to_port(psi_j))
    np.testing.assert_array_equal(B_re, np.asarray(psi_j.B.re))
    np.testing.assert_array_equal(B_im, np.asarray(psi_j.B.im))
    np.testing.assert_array_equal(lam, np.asarray(psi_j.lam))
    g = jki.make_floquet_gates(1.0, jnp.asarray(np.linspace(-0.3, 0.3, L)),
                               1.0, theta=0.9 * np.pi, dtype=jnp.float64,
                               bc="periodic")
    gt = convert.gates_from_numpy(
        np.asarray(g.bond_gates.re), np.asarray(g.bond_gates.im),
        np.asarray(g.kick.re), np.asarray(g.kick.im),
        np.asarray(g.boundary_gate.re), np.asarray(g.boundary_gate.im),
        device="cpu")
    back = convert.gates_to_numpy(gt)
    np.testing.assert_array_equal(back["bond_re"], np.asarray(g.bond_gates.re))
    np.testing.assert_array_equal(back["kick_im"], np.asarray(g.kick.im))
    np.testing.assert_array_equal(back["boundary_im"],
                                  np.asarray(g.boundary_gate.im))

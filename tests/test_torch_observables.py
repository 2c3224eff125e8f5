"""The port's observables (device and host), the MPS helpers and ops/fft.py
against the JAX package.

The same states go through both packages: an entangled kicked-Ising state
evolved by the JAX package in float64 and converted to a port MPS, and
random numpy traces.  complex128 against float64 throughout, held to 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timecrystal_tpu.core import mps as jmps
from timecrystal_tpu.core import observables as jobs
from timecrystal_tpu.core.truncate import TruncParams as JTruncParams
from timecrystal_tpu.dynamics.tebd import evolve_floquet_scan as jscan
from timecrystal_tpu.models import kicked_ising as jki
from timecrystal_tpu.ops import fft as jfft
from timecrystal_tpu.ops.cpx import C
from timecrystal_tpu_torch import convert
from timecrystal_tpu_torch.core import mps as tmps
from timecrystal_tpu_torch.core import observables as tobs
from timecrystal_tpu_torch.ops import fft as tfft


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs beside other worker processes on shared cores; torch's
    default intra-op thread pool would oversubscribe them and spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


L, CHI, TOL = 6, 8, 1e-10


def _jax_state(theta, n_periods, seed):
    m = jki.KickedIsingModel(L, 1.0, 0.4, 1.0, disorder_seed=seed,
                             theta=theta, chi=CHI, dtype=jnp.float64)
    psi0 = jmps.create_initial_state(L, "neel", chi=CHI, dtype=jnp.float64)
    psi, _ = jscan(psi0, m.gates, n_periods, JTruncParams(svd_min=1e-14))
    return psi


@pytest.fixture(scope="module")
def states():
    """Two entangled chains (JAX MPS), the same as one port MPS each and
    stacked on a leading ensemble axis [2, ...]."""
    js = [_jax_state(0.9 * np.pi, 3, 5), _jax_state(0.8 * np.pi, 4, 6)]
    ts = [convert.mps_from_numpy(np.asarray(p.B.re), np.asarray(p.B.im),
                                 np.asarray(p.lam), device="cpu") for p in js]
    batch = tmps.MPS(B=torch.stack([t.B for t in ts]),
                     lam=torch.stack([t.lam for t in ts]))
    assert int(np.asarray(jmps.max_bond_dimension(js[0]))) > 2
    return js, ts, batch


def _np(x):
    if isinstance(x, C):
        return np.asarray(x.re) + 1j * np.asarray(x.im)
    if torch.is_tensor(x):
        return x.detach().numpy()
    return np.asarray(x)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(_np(t), _np(j), rtol=0, atol=tol)


def _bond_h(seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(L - 1, 4, 4)) + 1j * rng.normal(size=(L - 1, 4, 4))
    H = (A + A.conj().transpose(0, 2, 1)).reshape(L - 1, 2, 2, 2, 2)
    return H, C(jnp.asarray(H.real), jnp.asarray(H.imag)), torch.as_tensor(H)


DEVICE_CASES = {
    "correlation_function_xz_2_4": (
        lambda m, p: m.correlation_function(p, "x", "z", 2, 4)),
    "correlation_function_zz_4_1": (
        lambda m, p: m.correlation_function(p, "z", "z", 4, 1)),
    "correlation_function_yx_same_site": (
        lambda m, p: m.correlation_function(p, "y", "x", 3, 3)),
    "correlation_function_neighbours": (
        lambda m, p: m.correlation_function(p, "y", "y", 0, 1)),
    "zz_correlation_profile_0": lambda m, p: m.zz_correlation_profile(p, 0),
    "zz_correlation_profile_3": lambda m, p: m.zz_correlation_profile(p, 3),
    "zz_correlation_profile_last": (
        lambda m, p: m.zz_correlation_profile(p, L - 1)),
    "magnetization_x": lambda m, p: m.magnetization(p, "x"),
    "magnetization_y_site": lambda m, p: m.magnetization(p, "y", site=2),
    "calculate_magnetization_z": lambda m, p: m.calculate_magnetization(p),
    "staggered_magnetization": lambda m, p: m.staggered_magnetization(p),
    "order_parameter": lambda m, p: m.order_parameter(p, [0, 2, 4], [1, 3, 5]),
    "participation_ratio": lambda m, p: m.participation_ratio(p),
    "norm_squared": lambda m, p: (jmps if m is jobs else tmps).norm_squared(p),
    "entanglement_spectrum": lambda m, p: m.entanglement_spectrum(p, 3),
}


@pytest.mark.parametrize("case", sorted(DEVICE_CASES))
def test_device_observables_match_jax(states, case):
    """Each chain alone, and both on the ensemble axis, against the JAX
    package's value per chain."""
    js, ts, batch = states
    fn = DEVICE_CASES[case]
    ref = [_np(fn(jobs, p)) for p in js]
    for t, r in zip(ts, ref):
        _close(fn(tobs, t), r)
    _close(fn(tobs, batch), np.stack(ref))


@pytest.mark.parametrize("name", ["bond_energies", "total_energy",
                                  "bond_energies_exact"])
def test_energies_match_jax(states, name):
    js, ts, batch = states
    _, Hj, Ht = _bond_h(7)
    ref = [_np(getattr(jobs, name)(p, Hj)) for p in js]
    for t, r in zip(ts, ref):
        _close(getattr(tobs, name)(t, Ht), r)
    _close(getattr(tobs, name)(batch, Ht), np.stack(ref))


def test_cross_sz_profile_matches_jax(states):
    """<phi| sz_j |psi> of two different chains, and of sz_2 |psi> against
    psi (the two-time correlator at t=0, which is zz_correlation_profile)."""
    js, ts, batch = states
    _close(tobs.cross_sz_profile(ts[1], ts[0]),
           jobs.cross_sz_profile(js[1], js[0]))
    phi = tmps.apply_sz(batch, 2)
    _close(tobs.cross_sz_profile(phi, batch).real,
           tobs.zz_correlation_profile(batch, 2))
    swapped = tmps.MPS(B=batch.B.flip(0), lam=batch.lam.flip(0))
    _close(tobs.cross_sz_profile(swapped, batch),
           np.stack([_np(jobs.cross_sz_profile(js[1], js[0])),
                     _np(jobs.cross_sz_profile(js[0], js[1]))]))


def test_mps_constructors_match_jax():
    """haar_product_state from one numpy seed, and from_dense_tensors of
    dense tensors smaller than the padding."""
    j = jmps.haar_product_state(5, 4, dtype=jnp.float64,
                                rng=np.random.default_rng(3))
    t = tmps.haar_product_state(5, 4, dtype=torch.complex128, device="cpu",
                                rng=3)
    _close(t.B, j.B)
    _close(t.lam, j.lam)
    _close(tmps.norm_squared(t), 1.0)
    rng = np.random.default_rng(4)
    tensors = [rng.normal(size=(a, 2, b)) + 1j * rng.normal(size=(a, 2, b))
               for a, b in ((1, 2), (2, 3), (3, 1))]
    lams = [np.ones(1), rng.uniform(size=2), rng.uniform(size=3), np.ones(1)]
    j = jmps.from_dense_tensors(tensors, lams, 4, dtype=jnp.float64)
    t = tmps.from_dense_tensors(tensors, lams, 4, dtype=torch.complex128,
                                device="cpu")
    _close(t.B, j.B)
    _close(t.lam, j.lam)


def _traces(seed, n=64):
    rng = np.random.default_rng(seed)
    t = np.arange(n) * 4.0
    stag = np.cos(np.pi * np.arange(n)) * np.exp(-t / 300) + 0.05 * rng.normal(size=n)
    le = 0.5 + 0.4 * np.cos(np.pi * np.arange(n)) + 0.02 * rng.normal(size=n)
    return t, stag, np.clip(le, 1e-3, 1.0)


HOST_CASES = {
    "fidelity_decay": lambda m, t, s, le: m.fidelity_decay(le, t),
    "subharmonic_response": lambda m, t, s, le: m.subharmonic_response(s, 2.0),
    "subharmonic_weight_fraction": (
        lambda m, t, s, le: m.subharmonic_weight_fraction(t, s, 8.0)),
    "subharmonic_weight_fraction_short": (
        lambda m, t, s, le: m.subharmonic_weight_fraction(t[:9], s[:9], 8.0)),
    "extract_subharmonic_amplitude": (
        lambda m, t, s, le: m.extract_subharmonic_amplitude(t, s, 8.0)),
    "extract_subharmonic_amplitude_from_loschmidt": (
        lambda m, t, s, le: m.extract_subharmonic_amplitude_from_loschmidt(
            t, le, 8.0)),
    "detect_period_doubling_from_loschmidt": (
        lambda m, t, s, le: m.detect_period_doubling_from_loschmidt(le)),
    "calculate_fourier_spectrum": (
        lambda m, t, s, le: np.concatenate(m.calculate_fourier_spectrum(
            t, s, 4.0))),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_host_recipes_match_jax(case, seed):
    t, s, le = _traces(seed)
    s_nan = s.copy()
    s_nan[5] = np.nan            # the recipes drop invalid samples
    for series in (s, s_nan):
        out = HOST_CASES[case](tobs, t, series, le)
        ref = HOST_CASES[case](jobs, t, series, le)
        np.testing.assert_allclose(np.asarray(out, float),
                                   np.asarray(ref, float), rtol=0, atol=TOL,
                                   equal_nan=True)


def test_power_spectrum_matches_jax():
    x = np.random.default_rng(8).normal(size=(3, 4, 50))
    for axis in (-1, 1):
        _close(tfft.power_spectrum(torch.as_tensor(x), axis=axis),
               jfft.power_spectrum(jnp.asarray(x), axis=axis), tol=1e-9)


@pytest.mark.parametrize("window,dc", [(True, True), (False, False),
                                       (True, False)])
def test_spacetime_power_matches_jax(window, dc):
    c = np.random.default_rng(9).normal(size=(2, 41, 6))
    _close(tfft.spacetime_power(torch.as_tensor(c), window, dc),
           jfft.spacetime_power(jnp.asarray(c), window, dc))


def test_dynamic_structure_factor_matches_jax():
    c = np.random.default_rng(10).normal(size=(30, 8))
    times = np.arange(30) * 2.0
    ft, kt, St = tobs.dynamic_structure_factor(times, c, device="cpu")
    fj, kj, Sj = jobs.dynamic_structure_factor(times, c)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(kt, kj)
    _close(St, Sj)
    with pytest.raises(ValueError, match="29 entries"):
        tobs.dynamic_structure_factor(times[:29], c, device="cpu")

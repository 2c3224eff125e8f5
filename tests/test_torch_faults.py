"""Two behaviours of the port that looked like faults against the JAX
package, settled on the CPU and pinned: the adaptive NS polish of
'jacobi_core' runs near its 12-iteration cap in both packages, and the
drive grid's float32 drift from complex128 once truncation sets in is the
same in both.  The same inputs go through both packages;
``tests/probe_torch_faults.py`` prints the numbers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timecrystal_tpu.core.truncate import TruncParams as JTruncParams
from timecrystal_tpu.parallel import sweep as jsw
from timecrystal_tpu_torch.core.truncate import TruncParams
from timecrystal_tpu_torch.ops import jacobi_svd as TJ
from timecrystal_tpu_torch.parallel import sweep as tsw

from probe_torch_faults import (SPECTRA, haar_panels, jax_polish_iterations,
                                torch_polish_iterations)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs beside other worker processes on shared cores; torch's
    default intra-op thread pool would oversubscribe them and spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("spectrum,expected", [
    ("steady", (10, 11, 12)),
    ("dense", (6, 7, 8)),
])
def test_ns_polish_runs_near_its_cap_in_both_packages(spectrum, expected):
    """jacobi_core's adaptive NS polish (cap 12, exit 5e-6 in float32) on the
    same complex64 V = Z Vk of a [1, 512, 512] input, k = 256: a steep
    TEBD-like spectrum (sigma_256 = 3.6e-5 sigma_max) and the dense
    logspace(0, -7).  Both packages take the same count to within one
    iteration, and neither exits in the ~4-5 its docstring gives for steady
    spectra: the steep spectrum runs to 10-12."""
    k = 256
    M = torch.as_tensor(haar_panels(SPECTRA[spectrum], 1))
    _, V, _ = TJ.jacobi_core(M, k, polish_iters=0)
    V = V.numpy()
    n_port = torch_polish_iterations(V, k, 12, 5e-6)
    n_jax = jax_polish_iterations(V, k, 12, 5e-6)
    assert n_port in expected and n_jax in expected, (n_port, n_jax)
    assert abs(n_port - n_jax) <= 1, (n_port, n_jax)


def test_drive_grid_float32_drift_is_shared_with_jax():
    """A drive-grid point (eps=0.2, h=0.8) at L=10, chi_pad=16, chi_max=8,
    12 periods: once truncation sets in, float32 'jacobi' leaves the
    complex128 LAPACK run by ~3.5e-5 in sz in both packages (the port's
    twin and the JAX package's Pallas kernel in interpret mode), while
    float32 LAPACK stays at rounding.  Before truncation both agree to
    float32 rounding."""
    L, n = 10, 12
    np.random.seed(42)
    h = 0.8 * np.random.uniform(-1.0, 1.0, L)[None]
    taus, thetas = np.ones(1), np.array([0.8 * np.pi])
    basis = jsw._basis_indices(L, "neel")

    def tp(cls, method):
        return cls(chi_max=8, svd_min=1e-12, trunc_cut=1e-7, svd_method=method)

    def port(dtype, method):
        spec = tsw.SweepSpec(L=L, chi=16, n_periods=n, dtype=dtype,
                             tp=tp(TruncParams, method))
        return tsw.evolve_batch(h, taus, basis, spec, thetas=thetas,
                                device="cpu")["sz_sites"]

    ref = tsw.evolve_batch(h, taus, basis, tsw.SweepSpec(
        L=L, chi=16, n_periods=n, dtype="float64", tp=tp(TruncParams, "native")),
        thetas=thetas, device="cpu")
    exact = np.cumsum(ref["trunc_err"] > 1e-8, axis=1) == 0
    jspec = jsw.SweepSpec(L=L, chi=16, n_periods=n, dtype="float32",
                          tp=tp(JTruncParams, "jacobi"))
    jax_sz = np.asarray(jsw.evolve_batch(
        jnp.asarray(h), jnp.asarray(taus), jnp.asarray(basis), jspec,
        thetas=jnp.asarray(thetas))["sz_sites"])
    d_port = np.abs(port("float32", "jacobi") - ref["sz_sites"])
    d_jax = np.abs(jax_sz - ref["sz_sites"])
    d_lapack = np.abs(port("float32", "native") - ref["sz_sites"])
    assert 2 <= exact.sum() < n, exact.sum()
    assert d_port[exact].max() < 2e-6 and d_jax[exact].max() < 2e-6
    assert d_lapack.max() < 5e-6
    assert d_port.max() > 1e-5 and d_jax.max() > 1e-5
    assert 0.5 < d_port.max() / d_jax.max() < 2.0, (d_port.max(), d_jax.max())

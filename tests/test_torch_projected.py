"""Parity of the port's projected top-k SVDs and its A2T batch with the JAX
package.

The port's ``jacobi_proj`` / ``jacobi_core`` run the torch twin of kernel 1
on CPU tensors; the JAX side runs the Pallas kernel in interpret mode
(float64 pairs, tests/conftest.py), as tests/test_csvd.py does.  Both get
the same numpy inputs.

Tolerances: complex128 against float64, S and disc to 1e-12 and the
polished V columns to 1e-8 (both sides run the same sweeps with the same
exit rule and differ in summation order only); complex64 against float32,
S to 1e-5 x sigma_max and V through the gauge-invariant |theta V| column
norms to 1e-5 (float32 V columns inside the 1e-8 spectrum's tail are
resolved only to ~eps sigma_max / sigma).  A2T to 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timecrystal_tpu.core.observables import \
    extract_subharmonic_amplitude as jax_host_a2t
from timecrystal_tpu.ops import cpx
from timecrystal_tpu.ops.csvd import csvd_topk as jax_csvd_topk
from timecrystal_tpu.ops.fft import \
    batched_subharmonic_amplitude as jax_batched_a2t
from timecrystal_tpu.ops.pallas import jacobi_svd as JJ
from timecrystal_tpu.parallel.sweep import ensemble_a2t as jax_ensemble_a2t
from timecrystal_tpu_torch.ops import jacobi_svd as J
from timecrystal_tpu_torch.ops.csvd import csvd_topk
from timecrystal_tpu_torch.ops.fft import batched_subharmonic_amplitude
from timecrystal_tpu_torch.parallel.sweep import ensemble_a2t


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs beside other worker processes on shared cores; torch's
    default intra-op thread pool would oversubscribe them and spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JDTYPE = {torch.complex128: jnp.float64, torch.complex64: jnp.float32}


def _haar(rng, n):
    q, _ = np.linalg.qr(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    return q


def _steep(seed, B=2, n=32, decades=8):
    """[B, n, n] with a logspace(0, -decades) spectrum: the steady state's
    steep boundary class."""
    rng = np.random.default_rng(seed)
    return np.stack([(_haar(rng, n) * np.logspace(0, -decades, n))
                     @ _haar(rng, n).conj().T for _ in range(B)])


def _jax(M, dtype):
    return cpx.from_numpy(M, JDTYPE[dtype])


def _check(jax_out, port_out, M, dtype):
    """(S, V, disc) of both packages: complex128 to 1e-12 / 1e-8, complex64
    through S and the |M V| column norms to 1e-5 x sigma_max."""
    Sj, Vj, dj = (np.asarray(jax_out[0]), cpx.to_numpy(jax_out[1]),
                  np.asarray(jax_out[2]))
    St, Vt, dt = (x.numpy() for x in port_out)
    assert St.shape == Sj.shape and Vt.shape == Vj.shape and dt.shape == dj.shape
    smax = float(np.abs(Sj).max())
    if dtype == torch.complex128:
        np.testing.assert_allclose(St, Sj, rtol=0, atol=1e-12 * smax)
        np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-12 * smax ** 2)
        np.testing.assert_allclose(Vt, Vj, rtol=0, atol=1e-8)
    else:
        np.testing.assert_allclose(St, Sj, rtol=0, atol=1e-5 * smax)
        np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-5 * smax ** 2)
        Md = M.astype(np.complex128)
        nt = np.linalg.norm(Md @ Vt.astype(np.complex128), axis=-2)
        nj = np.linalg.norm(Md @ Vj.astype(np.complex128), axis=-2)
        np.testing.assert_allclose(nt, nj, rtol=0, atol=1e-5 * smax)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128],
                         ids=["c64", "c128"])
@pytest.mark.parametrize("n,k", [(32, 16), (48, 8), (96, 48)])
def test_fixed_projection_basis_is_the_jax_constant(dtype, n, k):
    """Bit for bit, real and imaginary parts, and cached per key."""
    Qj = JJ._fixed_projection_basis(n, k, JDTYPE[dtype])
    Qt = J._fixed_projection_basis(n, k, dtype, "cpu")
    assert Qt.dtype == dtype and Qt.shape == (n, k)
    assert np.array_equal(Qt.real.numpy(), np.asarray(Qj.re))
    assert np.array_equal(Qt.imag.numpy(), np.asarray(Qj.im))
    assert J._fixed_projection_basis(n, k, dtype, "cpu") is Qt


def test_ns_polish_adaptive_matches_jax_with_a_null_column():
    """A null column (the fault class pinned in ROADMAP.md section 3): the
    null-safe defect converges, the column stays zero, and the result is
    the JAX while_loop's; on the CPU the polish reads nothing off a
    device."""
    rng = np.random.default_rng(4)
    V = _haar(rng, 12)[None, :, :6] * np.array([1.0, 1.0, 0.999, 1.001, 0.0,
                                                 1.0])
    V = V + 1e-3 * (rng.normal(size=V.shape) + 1j * rng.normal(size=V.shape))
    V[..., 4] = 0.0
    out_j = cpx.to_numpy(JJ._ns_polish_adaptive(_jax(V, torch.complex128), 6,
                                                max_iters=12, tol=1e-12))
    reads = J.NS_HOST_READS
    out_t = J._ns_polish_adaptive(torch.as_tensor(V), 6, 12, 1e-12).numpy()
    assert J.NS_HOST_READS == reads
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-12)
    assert np.abs(out_t[..., 4]).max() == 0.0
    G = out_t[0].conj().T @ out_t[0]
    assert np.abs(G - np.diag([1, 1, 1, 1, 0, 1])).max() < 1e-10


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128],
                         ids=["c64", "c128"])
def test_poly_polar_matches_jax(dtype):
    """Quintic 3.4445 / -4.7750 / 2.0315 after the Frobenius prescale, then
    the cubic tail; a rank-deficient panel keeps its null direction."""
    rng = np.random.default_rng(6)
    X = (rng.normal(size=(2, 24, 8)) + 1j * rng.normal(size=(2, 24, 8)))
    X = X * np.logspace(0, -3, 8)
    X[1, :, 7] = 0.0
    X = X.astype(np.complex64 if dtype == torch.complex64 else np.complex128)
    q, c = (10, 4) if dtype == torch.complex64 else (16, 8)
    Wj = cpx.to_numpy(JJ._poly_polar(_jax(X, dtype), q, c))
    Wt = J._poly_polar(torch.as_tensor(X), q, c).numpy()
    np.testing.assert_allclose(Wt, Wj, rtol=0,
                               atol=1e-5 if dtype == torch.complex64 else 1e-12)
    assert np.abs(Wt[1, :, 7]).max() == 0.0


def test_quintic_precision_modes_on_the_cpu():
    """'tf32' only scopes a cuBLAS flag: on a CPU tensor it is 'highest'
    bit for bit, and the flag is off again afterwards, also when the
    matmul raises; any other mode raises."""
    rng = np.random.default_rng(8)
    X = torch.as_tensor(rng.normal(size=(1, 16, 4)) + 1j * rng.normal(size=(1, 16, 4)))
    W = J._poly_polar(X, 10, 4)
    assert J.QUINTIC_PRECISIONS == ("highest", "tf32")
    assert torch.equal(J._poly_polar(X, 10, 4, "tf32"), W)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    with pytest.raises(RuntimeError):
        J._qmul(X, X, "tf32")               # [1, 16, 4] @ [1, 16, 4]
    assert torch.backends.cuda.matmul.allow_tf32 is False
    for mode in ("bf16", "fp8"):
        with pytest.raises(ValueError, match="quintic"):
            J._poly_polar(X, 1, 0, mode)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128],
                         ids=["c64", "c128"])
def test_jacobi_proj_matches_jax(dtype):
    """Both panels' sweep loops (rows = the panels' columns), polish 6 + 6;
    the plain version (twin and host loop) is the same function on the
    CPU."""
    M = _steep(10).astype(np.complex64 if dtype == torch.complex64
                          else np.complex128)
    k = 16
    kw = dict(polish=k, polish_b_iters=6, polish_iters=6)
    out_j = JJ.jacobi_proj(_jax(M, dtype), k, interpret=True, **kw)
    out_t = J.jacobi_proj(torch.as_tensor(M), k, **kw)
    _check(out_j, out_t, M, dtype)
    for a, b in zip(out_t, J.jacobi_proj_plain(torch.as_tensor(M), k, **kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("config", ["default", "fast"])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128],
                         ids=["c64", "c128"])
def test_jacobi_core_matches_jax(dtype, config):
    """The core on conj(K) (the columns of K^H), V = Z Vk, and the polish:
    adaptive (the default) or the fast configuration's fixed 4 iterations
    with the quintic at full precision (the JAX package's 'default'
    matmul precision is full precision on the CPU)."""
    M = _steep(12).astype(np.complex64 if dtype == torch.complex64
                          else np.complex128)
    k = 16
    if config == "fast":
        kw_j = dict(quintic_precision="default", polish_iters=4,
                    polish_adaptive=False)
        kw_t = dict(kw_j, quintic_precision="highest")
    else:
        kw_j = kw_t = {}
    out_j = JJ.jacobi_core(_jax(M, dtype), k, interpret=True, **kw_j)
    out_t = J.jacobi_core(torch.as_tensor(M), k, **kw_t)
    _check(out_j, out_t, M, dtype)
    for a, b in zip(out_t, J.jacobi_core_plain(torch.as_tensor(M), k, **kw_t)):
        assert torch.equal(a, b)


def test_projected_precondition_raises():
    M = torch.as_tensor(_steep(1, B=1, n=8))
    for fn in (J.jacobi_proj, J.jacobi_core):
        with pytest.raises(ValueError, match="even k"):
            fn(M, 3)
        with pytest.raises(ValueError, match="even k"):
            fn(M[:, :4], 6)


@pytest.mark.parametrize("k", [16, 15, 40], ids=["k16", "odd-k", "k-past-n"])
@pytest.mark.parametrize("method", ["jacobi_proj", "jacobi_core",
                                    "jacobi_core_fast"])
def test_csvd_topk_projected_methods_match_jax(method, k):
    """The tuned configurations of csvd_topk in complex128 (jacobi_proj
    polish 6 + 6; jacobi_core and jacobi_core_fast both the adaptive
    default, as complex128 keeps full precision); an odd k, or k past
    min(m, n), takes 'jacobi' in both packages.  A rectangular [32, 40]
    panel."""
    M = _steep(14, B=2, n=40)[:, :32]
    Sj, Vhj, dj = jax_csvd_topk(_jax(M, torch.complex128), k, method=method)
    St, Vht, dt = csvd_topk(torch.as_tensor(M), k, method=method)
    smax = float(np.asarray(Sj).max())
    np.testing.assert_allclose(St.numpy(), np.asarray(Sj), rtol=0,
                               atol=1e-12 * smax)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0,
                               atol=1e-12 * smax ** 2)
    Vhj = cpx.to_numpy(Vhj)
    assert Vht.shape == Vhj.shape
    # the kept rows' projectors (a kept row's phase is free for the
    # 'jacobi' fallback); rows past the rank are zero in both
    np.testing.assert_allclose((Vht.mH @ Vht).numpy(),
                               np.swapaxes(Vhj.conj(), -1, -2) @ Vhj,
                               rtol=0, atol=1e-8)


@pytest.mark.parametrize("method", ["jacobi_proj", "jacobi_core",
                                    "jacobi_core_fast"])
def test_csvd_topk_complex64_configurations_match_jax(method):
    """The complex64 configurations (jacobi_proj tol 1e-6 and polish 4 + 4;
    jacobi_core_fast's fixed 4-iteration polish with its fast quintic,
    which on a CPU tensor runs at full precision, as the JAX package's
    'default' does on the CPU): S and disc to 1e-5 x sigma_max."""
    M = _steep(16, B=2, n=32).astype(np.complex64)
    Sj, _, dj = jax_csvd_topk(_jax(M, torch.complex64), 16, method=method)
    St, Vht, dt = csvd_topk(torch.as_tensor(M), 16, method=method)
    assert St.dtype == torch.float32 and Vht.shape == (2, 16, 32)
    np.testing.assert_allclose(St.numpy(), np.asarray(Sj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-5)


def _a2t_inputs(seed=3, R=5, n=81):
    rng = np.random.default_rng(seed)
    taus = rng.uniform(0.5, 1.5, R)
    t = np.arange(n)[None, :] * (2.0 * taus)[:, None]
    series = (np.cos(np.pi * np.arange(n))[None] * rng.uniform(0.2, 1.0, (R, 1))
              + 0.3 * rng.normal(size=(R, n)))
    return t, series, taus


@pytest.mark.parametrize("n", [81, 64, 10, 9], ids=["n81", "n64", "n10", "n9"])
def test_batched_subharmonic_amplitude_matches_jax_and_host(n):
    """torch.fft.rfft in place of the JAX package's matmul DFT: the same
    bins, argmin and normalization (per-trace drive periods); n < 10 gives
    0.0, as the host recipe does."""
    t, series, taus = _a2t_inputs(n=n)
    a_t = batched_subharmonic_amplitude(torch.as_tensor(t), torch.as_tensor(series),
                                        torch.as_tensor(2.0 * taus)).numpy()
    a_j = np.asarray(jax_batched_a2t(jnp.asarray(t), jnp.asarray(series),
                                     jnp.asarray(2.0 * taus)))
    host = [jax_host_a2t(t[r], series[r], 2.0 * taus[r]) for r in range(len(taus))]
    np.testing.assert_allclose(a_t, a_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(a_t, host, rtol=0, atol=1e-12)
    if n < 10:
        assert np.all(a_t == 0.0)


def test_batched_subharmonic_amplitude_nan_rules():
    """A non-finite sample or a time grid with dt <= 0 gives NaN (the JAX
    package's rule); a shared 1-D time grid broadcasts."""
    t, series, taus = _a2t_inputs()
    series[1, 7] = np.nan
    t_bad = t.copy()
    t_bad[3] = 0.0
    a = batched_subharmonic_amplitude(torch.as_tensor(t_bad), torch.as_tensor(series),
                                      torch.as_tensor(2.0 * taus)).numpy()
    assert np.isnan(a[1]) and np.isnan(a[3])
    assert np.all(np.isfinite(a[[0, 2, 4]]))
    a1 = batched_subharmonic_amplitude(torch.as_tensor(t[0]), torch.as_tensor(series),
                                       2.0 * float(taus[0])).numpy()
    aj = np.asarray(jax_batched_a2t(jnp.asarray(t[0]), jnp.asarray(series),
                                    2.0 * float(taus[0])))
    np.testing.assert_array_equal(np.isnan(a1), np.isnan(aj))
    np.testing.assert_allclose(a1[~np.isnan(a1)], aj[~np.isnan(aj)], atol=1e-12)


def test_ensemble_a2t_recomputes_nan_traces_on_the_host():
    """ensemble_a2t against the JAX package's: a trace with a NaN comes back
    from the host recipe (which drops the sample), the rest from the
    batch."""
    _, series, taus = _a2t_inputs()
    series[2, 11] = np.nan
    traces = {"staggered_magnetization": series}
    a_t = ensemble_a2t(traces, taus, device="cpu")
    a_j = np.asarray(jax_ensemble_a2t({"staggered_magnetization":
                                       jnp.asarray(series)}, jnp.asarray(taus)))
    assert isinstance(a_t, np.ndarray) and np.all(np.isfinite(a_t))
    np.testing.assert_allclose(a_t, a_j, rtol=0, atol=1e-12)
    t = np.arange(series.shape[1]) * 2.0 * taus[2]
    assert a_t[2] == jax_host_a2t(t, series[2], 2.0 * taus[2])

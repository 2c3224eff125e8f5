"""Parity of the port's full Jacobi SVD (jacobi_svd, csvd, csvd_topk
'jacobi_full') and Hermitian factorizations with the JAX package.

The port runs the torch twin of the V-accumulating sweep kernel on CPU
tensors (complex128 here); the JAX side runs ``jacobi_svd`` with the Pallas
kernel in interpret mode (float64 pairs, tests/conftest.py).  Both get the
same numpy inputs and run the same rotation sequence from V0 = I, so S, U
and Vh agree entrywise, not only up to phases.

Tolerances: 1e-10 (float64 runs of the same sweeps differ by summation
order, ~1e-14 measured).  U columns and Vh rows are compared where sigma
is nonzero (above 1e-8 sigma_max): rows of Vh in the null space of a wide
matrix are any basis of it.  Shapes: square, tall, wide, odd width (the
zero-pad column), n = 2 (the analytic pair) and two leading axes.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from timecrystal_tpu.ops import csvd as jcsvd
from timecrystal_tpu.ops.cpx import C
from timecrystal_tpu.ops.pallas.jacobi_svd import jacobi_svd as jax_jacobi_svd
from timecrystal_tpu_torch.ops import csvd as tcsvd
from timecrystal_tpu_torch.ops import cuda_build
from timecrystal_tpu_torch.ops import jacobi_svd as J

TOL = 1e-10

SHAPES = {
    "square": (3, 16, 16),
    "tall": (2, 12, 8),
    "wide": (2, 8, 12),
    "odd": (2, 10, 7),
    "n2": (4, 5, 2),
    "multi_lead": (2, 2, 8, 6),
}


def _matrix(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _c(M):
    return C(np.ascontiguousarray(M.real), np.ascontiguousarray(M.imag))


def _np(x):
    return np.asarray(x.re) + 1j * np.asarray(x.im)


def _assert_usv_equal(jax_usv, port_usv):
    Uj, Sj, Vhj = _np(jax_usv[0]), np.asarray(jax_usv[1]), _np(jax_usv[2])
    Up, Sp, Vhp = (x.numpy() for x in port_usv)
    assert Up.shape == Uj.shape and Sp.shape == Sj.shape and Vhp.shape == Vhj.shape
    smax = float(np.max(Sj))
    np.testing.assert_allclose(Sp, Sj, rtol=0, atol=TOL * smax)
    live = Sj > 1e-8 * smax
    np.testing.assert_allclose(np.where(live[..., None, :], Up, 0),
                               np.where(live[..., None, :], Uj, 0),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(np.where(live[..., :, None], Vhp, 0),
                               np.where(live[..., :, None], Vhj, 0),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_jacobi_svd_matches_jax(case):
    M = _matrix(SHAPES[case])
    port = J.jacobi_svd(torch.as_tensor(M))
    _assert_usv_equal(jax_jacobi_svd(_c(M), interpret=True), port)
    # and it is an SVD: U diag(S) Vh rebuilds M (1e-12 relative)
    U, S, Vh = port
    rec = ((U * S[..., None, :].to(U.dtype)) @ Vh).numpy()
    assert np.linalg.norm(rec - M) < 1e-12 * np.linalg.norm(M)


def test_csvd_and_jacobi_full_topk_match_jax():
    """csvd(method='jacobi') and csvd_topk('jacobi_full') route to
    jacobi_svd on both sides (same shape as the 'square' case, so JAX
    reuses its compiled program); 'native' csvd is LAPACK on both."""
    M = _matrix(SHAPES["square"])
    _assert_usv_equal(jcsvd.csvd(_c(M), method="jacobi"),
                      tcsvd.csvd(torch.as_tensor(M), method="jacobi"))
    Sj, Vhj, dj = jcsvd.csvd_topk(_c(M), 6, method="jacobi_full")
    Sp, Vhp, dp = tcsvd.csvd_topk(torch.as_tensor(M), 6, method="jacobi_full")
    np.testing.assert_allclose(Sp.numpy(), np.asarray(Sj), rtol=0, atol=TOL)
    np.testing.assert_allclose(Vhp.numpy(), _np(Vhj), rtol=0, atol=TOL)
    np.testing.assert_allclose(dp.numpy(), np.asarray(dj), rtol=0, atol=TOL)
    Un, Sn, Vhn = tcsvd.csvd(torch.as_tensor(M), method="native")
    np.testing.assert_allclose(Sn.numpy(), np.asarray(jcsvd.csvd(
        _c(M), method="native")[1]), rtol=0, atol=1e-12)
    assert torch.equal(tcsvd.csvd(torch.as_tensor(M))[1], Sn)   # auto = native


def test_rectangular_and_odd_jacobi_topk_take_the_v_kernel_path():
    """'jacobi' on a rectangular or odd-width panel goes through
    jacobi_svd, as in the JAX package: same S and discarded weight as
    'jacobi_full' (bitwise) and as LAPACK (1e-12)."""
    for shape in (SHAPES["tall"], SHAPES["odd"]):
        M = torch.as_tensor(_matrix(shape, seed=1))
        S, Vh, d = tcsvd.csvd_topk(M, 3, method="jacobi")
        Sf, Vhf, df = tcsvd.csvd_topk(M, 3, method="jacobi_full")
        assert torch.equal(S, Sf) and torch.equal(Vh, Vhf) and torch.equal(d, df)
        Sn, _, dn = tcsvd.csvd_topk(M, 3, method="native")
        np.testing.assert_allclose(S.numpy(), Sn.numpy(), atol=1e-12)
        np.testing.assert_allclose(d.numpy(), dn.numpy(), atol=1e-12)


def test_v_sweep_twin_rotates_equal_norm_parallel_columns():
    """tau = 0 needs the full 45-degree rotation (torch.sign(0) = 0 would
    skip it).  Four equal rows u: step 1 moves each pair's weight into one
    row (norm^2 2|u|^2), step 2 pairs those two, so the sweep's measure is
    (2|u|^2)^2 / maxn2^2 = 4 and one row ends with all the weight (norm
    2|u|); the rotated rows are W @ X (V tracks the rotations), and the
    converged S of the 4x4 matrix of 0.5s is [2, 0, 0, 0].  Exact arithmetic
    up to rounding: 1e-12."""
    X = torch.full((1, 4, 3), 0.5 + 0.25j, dtype=torch.complex128)
    W0 = torch.eye(4, dtype=torch.complex128)[None]
    Xr, W, measure = J._jacobi_sweep_v_torch(X.clone(), W0.clone())
    np.testing.assert_allclose(measure.numpy(), [4.0], atol=1e-12)
    np.testing.assert_allclose((W @ X).numpy(), Xr.numpy(), atol=1e-12)
    np.testing.assert_allclose((W @ W.mH).numpy(), W0.numpy(), atol=1e-12)
    norms = np.sort(np.linalg.norm(Xr.numpy()[0], axis=-1))
    np.testing.assert_allclose(norms, [0, 0, 0, 2 * np.linalg.norm(X[0, 0])],
                               atol=1e-12)
    _, S, _ = J.jacobi_svd(torch.full((4, 4), 0.5, dtype=torch.complex128))
    np.testing.assert_allclose(S.numpy(), [2.0, 0.0, 0.0, 0.0], atol=1e-12)


def test_non_cpu_tensor_goes_to_the_cuda_wrapper(monkeypatch):
    """The dispatch rule: a tensor that is not on the CPU (here 'meta') goes
    to a CUDA wrapper, which raises; it never reaches the twin or LAPACK,
    and no launch is counted.  One matrix that fits ([1, 8, 6]) goes to the
    resident kernel's wrapper, a batch ([2, 8, 6]) to the per-sweep one."""
    def boom(*args, **kwargs):
        raise AssertionError("fell back off the CUDA route")

    monkeypatch.setattr(J, "_jacobi_sweep_v_torch", boom)
    monkeypatch.setattr(J, "_orthogonalize_v_plain", boom)
    monkeypatch.setattr(torch.linalg, "svd", boom)
    before = (J.V_KERNEL_LAUNCHES, J.V_RESIDENT_LAUNCHES)
    for shape, wrapper in (((2, 8, 6), "CUDA sweep"),
                           ((1, 8, 6), "CUDA resident sweep loop")):
        M = torch.empty(shape, dtype=torch.complex64, device="meta")
        for call in (lambda: J.jacobi_svd(M),
                     lambda: tcsvd.csvd(M),
                     lambda: tcsvd.csvd(M, method="jacobi"),
                     lambda: tcsvd.csvd_topk(M, 2, method="jacobi_full"),
                     lambda: tcsvd.csvd_topk(M, 2, method="auto")):
            with pytest.raises(ValueError, match=f"^{wrapper} needs a CUDA tensor"):
                call()
    assert (J.V_KERNEL_LAUNCHES, J.V_RESIDENT_LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA"):
        J._jacobi_sweep_v_cuda(torch.zeros(1, 4, 4, dtype=torch.complex64),
                               torch.zeros(1, 4, 4, dtype=torch.complex64))


# theta shape [B, m, n0], dtype, whether the resident kernel takes it: the
# limits of the fit rule (complex64 up to n = 120, complex128 up to n = 84,
# one matrix only), odd widths counted at their zero-padded even n
RESIDENT_FITS = {
    "c64_n96": ((1, 96, 96), torch.complex64, True),
    "c64_n120_limit": ((1, 120, 120), torch.complex64, True),
    "c64_n122": ((1, 122, 122), torch.complex64, False),
    "c64_batch2": ((2, 96, 96), torch.complex64, False),
    "c128_n96": ((1, 96, 96), torch.complex128, False),
    "c128_n64": ((1, 64, 64), torch.complex128, True),
    "c64_odd95_padded_to_96": ((1, 96, 95), torch.complex64, True),
}


@pytest.mark.parametrize("case", sorted(RESIDENT_FITS))
def test_resident_fit_rule_and_dispatch(case, monkeypatch):
    """_resident_fits (B == 1 and n (m + n) itemsize + (n + 32) 8 <= 232448
    bytes) at the rule's edges, and jacobi_svd's dispatch of a CUDA-like
    (meta) tensor by it: X [B, n, m] with n the padded width reaches the
    resident wrapper when it fits and the per-sweep loop otherwise."""
    shape, dtype, fits = RESIDENT_FITS[case]
    B, m, n0 = shape
    n = n0 + n0 % 2
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert J._resident_fits(B, n, m, itemsize) is fits

    class Reached(Exception):
        pass

    def reached(name):
        def wrapper(X, *args, **kwargs):
            raise Reached(name, tuple(X.shape))
        return wrapper

    monkeypatch.setattr(J, "_jacobi_svd_resident_cuda", reached("resident"))
    monkeypatch.setattr(J, "_orthogonalize_columns_v", reached("per-sweep"))
    with pytest.raises(Reached) as info:
        J.jacobi_svd(torch.empty(shape, dtype=dtype, device="meta"))
    assert info.value.args == ("resident" if fits else "per-sweep", (B, n, m))


@pytest.mark.parametrize("dtype,tol,n_sweeps", [(torch.complex64, 3e-8, 12),
                                                (torch.complex128, 1e-14, 24)])
def test_resident_wrapper_passes_the_host_exit_threshold(dtype, tol, n_sweeps,
                                                         monkeypatch):
    """The resident kernel tests the host loop's exit rule on the device, so
    its wrapper must pass the very float32 threshold the host loop compares
    with: np.float32(tol * tol) for jacobi_svd's default tol of each dtype,
    with the default sweep cap.  The C entry is replaced by a recorder that
    reports a failed launch: the wrapper raises and counts nothing."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 1                                  # cudaErrorInvalidValue

    lib = types.SimpleNamespace(tct_jacobi_svd_resident_c64=entry,
                                tct_jacobi_svd_resident_c128=entry)
    monkeypatch.setattr(cuda_build, "load_kernel_library",
                        lambda name: (lib, None))
    monkeypatch.setattr(J, "_check_cuda_rows", lambda X, what="": None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    before = (J.V_KERNEL_LAUNCHES, J.V_RESIDENT_LAUNCHES)
    with pytest.raises(RuntimeError, match="jacobi_svd_resident kernel launch"):
        J.jacobi_svd(torch.empty((1, 8, 6), dtype=dtype, device="meta"))
    (args,) = calls
    n, m, max_sweeps, threshold = args[4:8]
    assert (n, m, max_sweeps) == (6, 8, n_sweeps)
    assert threshold == np.float32(tol * tol) == J._exit_threshold(tol)
    assert np.float32(threshold) == threshold     # exact as a C float
    assert (J.V_KERNEL_LAUNCHES, J.V_RESIDENT_LAUNCHES) == before


def test_hermitian_factorizations_match_jax():
    """heigh, hermitian_invsqrt and cqr_tall against the JAX package's
    'native' forms (LAPACK eigh on both sides): eigenvalues to 1e-12; the
    inverse square root, Q and R -- gauge-free products -- to 1e-10, on a
    tall matrix of rank 3 < 4 columns (the padded-rank mask).  heigh's
    Gram/eigh names give its 'native' result bit for bit."""
    rng = np.random.default_rng(4)
    M = (rng.normal(size=(8, 3)) + 1j * rng.normal(size=(8, 3))) @ \
        (rng.normal(size=(3, 4)) + 1j * rng.normal(size=(3, 4)))
    G = M.conj().T @ M
    wj, _ = jcsvd.heigh(_c(G), method="native")
    wp, Vp = tcsvd.heigh(torch.as_tensor(G))
    np.testing.assert_allclose(wp.numpy(), np.asarray(wj), rtol=0,
                               atol=1e-12 * float(np.max(np.asarray(wj))))
    np.testing.assert_allclose((Vp * wp.to(Vp.dtype)) @ Vp.mH, G, atol=1e-10)
    ij, sj = jcsvd.hermitian_invsqrt(_c(G), method="native")
    ip, sp = tcsvd.hermitian_invsqrt(torch.as_tensor(G))
    np.testing.assert_allclose(ip.numpy(), _np(ij), rtol=0, atol=1e-10)
    np.testing.assert_allclose(sp.numpy(), _np(sj), rtol=0, atol=1e-10)
    Qj, Rj = jcsvd.cqr_tall(_c(M), method="native")
    Qp, Rp = tcsvd.cqr_tall(torch.as_tensor(M))
    np.testing.assert_allclose(Qp.numpy(), _np(Qj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(Rp.numpy(), _np(Rj), rtol=0, atol=1e-10)
    np.testing.assert_allclose((Qp @ Rp).numpy(), M, atol=1e-10)
    # the Gram/eigh names are aliases of heigh's one method, 'native'
    for alias in ("gram_eigh", "gram_eigh_gs"):
        wa, Va = tcsvd.heigh(torch.as_tensor(G), method=alias)
        assert torch.equal(wa, wp) and torch.equal(Va, Vp)

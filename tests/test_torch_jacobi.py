"""Parity of the port's Jacobi (S, V) path with the JAX package.

The port's ``jacobi_sv`` runs its torch twin of the sweep kernel on CPU
tensors (complex128 here); the JAX side runs ``jacobi_sv`` with the Pallas
kernel in interpret mode (float64 pairs, tests/conftest.py), as
tests/test_csvd.py does.  Both get the same numpy inputs.

Tolerances: S within 1e-12 * sigma_max (both sides are float64 Jacobi runs
of the same sweep with the same exit rule; they differ only in summation
order, ~1e-15 relative), and the kept (polished) V columns equal up to a
per-column phase within 1e-10 (column directions are resolved to
~eps * sigma_max / gap, and the kept columns' gaps are >= 1e-4 here).
"""

import numpy as np
import pytest
import torch

from timecrystal_tpu.ops.cpx import C
from timecrystal_tpu.ops.pallas.jacobi_svd import jacobi_sv as jax_jacobi_sv
from timecrystal_tpu_torch.ops import jacobi_svd as J
from timecrystal_tpu_torch.ops.csvd import csvd_topk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs beside other worker processes on shared cores; torch's
    default intra-op thread pool would oversubscribe them and spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S_TOL = 1e-12
V_TOL = 1e-10


def _haar(rng, n):
    q, _ = np.linalg.qr(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    return q


def _random(rng, n):
    return (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))) / np.sqrt(n)


def _decaying(rng, n):
    return (_haar(rng, n) * np.logspace(0, -7, n)) @ _haar(rng, n).conj().T


def _rank_deficient(rng, n, r=3):
    A = rng.normal(size=(n, r)) + 1j * rng.normal(size=(n, r))
    B = rng.normal(size=(r, n)) + 1j * rng.normal(size=(r, n))
    return (A @ B) / n


def _rank1(rng, n):
    u = rng.normal(size=(n, 1)) + 1j * rng.normal(size=(n, 1))
    v = rng.normal(size=(1, n)) + 1j * rng.normal(size=(1, n))
    return (u @ v) / n


def _both(M, k):
    Sj, Vj = jax_jacobi_sv(C(np.ascontiguousarray(M.real),
                             np.ascontiguousarray(M.imag)),
                           polish=k, interpret=True)
    Sj = np.asarray(Sj)
    Vj = np.asarray(Vj.re) + 1j * np.asarray(Vj.im)
    Sp, Vp = J.jacobi_sv(torch.as_tensor(M), polish=k)
    return Sj, Vj, Sp.numpy(), Vp.numpy()


def _assert_same(Sj, Vj, Sp, Vp, k):
    smax = np.max(Sj)
    np.testing.assert_allclose(Sp, Sj, rtol=0, atol=S_TOL * smax)
    Sj2, Vj2, Vp2 = np.atleast_2d(Sj), Vj.reshape(-1, *Vj.shape[-2:]), \
        Vp.reshape(-1, *Vp.shape[-2:])
    for s, vj, vp in zip(Sj2, Vj2, Vp2):
        # kept, resolved columns: nonzero sigma that is not degenerate
        for c in range(k):
            if s[c] < 1e-8 * smax:
                continue
            ph = np.vdot(vj[:, c], vp[:, c])
            ph = ph / abs(ph)
            np.testing.assert_allclose(vp[:, c], vj[:, c] * ph, rtol=0,
                                       atol=V_TOL)


CASES = {
    "random": lambda rng: _random(rng, 8),
    "decaying_floor_polish": lambda rng: _decaying(rng, 16),
    "rank_deficient": lambda rng: _rank_deficient(rng, 16),
    "batched": lambda rng: np.stack([_random(rng, 8) for _ in range(3)]),
    # a rank-1 matrix converges sweeps before the random ones beside it: the
    # batch max decides when the whole call stops
    "batch_max_decides": lambda rng: np.stack([_rank1(rng, 8), _random(rng, 8),
                                               _random(rng, 8)]),
    "n2": lambda rng: _random(rng, 2),
    "n4": lambda rng: _random(rng, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_jacobi_sv_matches_jax(case):
    M = CASES[case](np.random.default_rng(11))
    k = M.shape[-1] // 2
    _assert_same(*_both(M, k), k)


def test_jacobi_sv_decaying_floor_zeroes_noise():
    """Below the 64*eps*sigma_max floor both S and V's columns are zero."""
    M = _decaying(np.random.default_rng(3), 16) * 1e-3
    M[:, -1] = 0.0                                  # one exact null direction
    S, V = J.jacobi_sv(torch.as_tensor(M), polish=8)
    floor = 64 * np.finfo(np.float64).eps * float(S[0])
    below = S.numpy() < floor
    assert below[-1]
    assert np.all(np.abs(V.numpy()[:, below]) == 0.0)


def test_equal_norm_parallel_columns():
    """tau = 0 needs the full 45-degree rotation (torch.sign(0) = 0 would
    skip it): rank-1 equal-norm inputs have S = [sqrt(2), 0] and
    [2, 0, 0, 0].  Exact arithmetic: 1e-12."""
    M2 = np.array([[1.0, 0.0], [1.0, 0.0]], dtype=np.complex128)
    S2, _ = J.jacobi_sv(torch.as_tensor(M2))
    np.testing.assert_allclose(S2.numpy(), [np.sqrt(2.0), 0.0], atol=1e-12)
    M4 = np.full((4, 4), 0.5, dtype=np.complex128)
    S4, _ = J.jacobi_sv(torch.as_tensor(M4))
    np.testing.assert_allclose(S4.numpy(), [2.0, 0.0, 0.0, 0.0], atol=1e-12)
    Sj, _ = jax_jacobi_sv(C(M4.real, M4.imag), interpret=True)
    np.testing.assert_allclose(S4.numpy(), np.asarray(Sj), atol=1e-12)


@pytest.mark.parametrize("n", [4, 6, 8, 16])
def test_tournament_schedule_replays_the_cycle(n):
    """The kernel's index schedule: every step pairs each row exactly once,
    each unordered pair meets exactly once per sweep, and running the twin
    by gathering rows through the schedule (what the kernel does: rows
    stay in place) gives the twin's result (to 1e-13: the same arithmetic
    on gathered rather than contiguous rows may round differently in the
    last bit; a wrong schedule differs at O(1))."""
    sched = J.tournament_schedule(n)
    k = n // 2
    assert sched.shape == (n - 1, n)
    pairs = set()
    for row in sched:
        assert sorted(row) == list(range(n))
        pairs |= {frozenset(p) for p in zip(row[:k], row[k:])}
    assert len(pairs) == n * (n - 1) // 2

    rng = np.random.default_rng(n)
    X = torch.as_tensor(rng.normal(size=(2, n, 5))
                        + 1j * rng.normal(size=(2, n, 5)))
    twin, meas = J._jacobi_sweep_torch(X)
    Y = X.clone()
    nrm = (Y.real ** 2 + Y.imag ** 2).sum(-1)
    inv = 1.0 / torch.clamp(nrm.amax(-1, keepdim=True) ** 2, min=1e-30)
    m_idx = torch.zeros(2, dtype=torch.float64)
    for row in torch.as_tensor(sched, dtype=torch.long):
        l, r = row[:k], row[k:]
        L, R = Y[:, l], Y[:, r]
        c = (L.conj() * R).sum(-1)
        m_idx = torch.maximum(m_idx, ((c.real ** 2 + c.imag ** 2) * inv).amax(-1))
        cs, w1, w2, t, absc = J._pair_rotation(nrm[:, l], nrm[:, r], c)
        Y[:, l] = cs[..., None] * L - w1[..., None] * R
        Y[:, r] = w2[..., None] * L + cs[..., None] * R
        nrm[:, l], nrm[:, r] = nrm[:, l] - t * absc, nrm[:, r] + t * absc
    np.testing.assert_allclose(Y.numpy(), twin.numpy(), rtol=0, atol=1e-13)
    np.testing.assert_allclose(m_idx.numpy(), meas.numpy(), rtol=1e-12)


def test_csvd_topk_jacobi_matches_native():
    """Port only: the 'jacobi' method against 'native' (LAPACK) on a
    batch; S to 1e-12 * sigma_max, discarded weight to 1e-12, and the
    top-k right singular subspaces equal (projector difference 1e-10)."""
    rng = np.random.default_rng(5)
    M = torch.as_tensor(np.stack([_decaying(rng, 16) for _ in range(2)]))
    k = 8
    Sj, Vhj, dj = csvd_topk(M, k, method="jacobi")
    Sn, Vhn, dn = csvd_topk(M, k, method="native")
    np.testing.assert_allclose(Sj.numpy(), Sn.numpy(), atol=1e-12)
    np.testing.assert_allclose(dj.numpy(), dn.numpy(), atol=1e-12)
    Pj = (Vhj.mH @ Vhj).numpy()
    Pn = (Vhn.mH @ Vhn).numpy()
    np.testing.assert_allclose(Pj, Pn, atol=1e-10)
    # 'auto' on a CPU tensor is 'native'
    Sa, _, _ = csvd_topk(M, k, method="auto")
    assert torch.equal(Sa, Sn)


@pytest.mark.parametrize("method", ["jacobi_proj", "jacobi_core",
                                    "jacobi_core_fast", "gram_eigh",
                                    "gram_eigh_gs"])
def test_unported_methods_raise(method):
    """The JAX package's other csvd_topk names.  The Gram/eigh names are
    aliases of 'auto' (on a CPU tensor 'native': the same S, Vh and disc
    bit for bit; tests/test_torch_checkpoint.py holds csvd's aliases to the
    JAX package's Gram/eigh SVD).  The projected methods are
    ported: on a [2, 16, 16] batch whose top 8 singular values (1 to 0.1)
    stand 1e5 above the rest -- the steady state's steep boundary -- their
    top-k S matches 'native''s to 1e-10 x sigma_max (one power
    application from the fixed basis captures the top subspace to
    ~(1e-6 / 0.1)^2), and disc is conservative."""
    if method.startswith("gram"):
        rng = np.random.default_rng(4)
        M = torch.as_tensor(rng.normal(size=(2, 16, 16))
                            + 1j * rng.normal(size=(2, 16, 16)))
        S, Vh, disc = csvd_topk(M, 8, method=method)
        Sn, Vhn, dn = csvd_topk(M, 8, method="native")
        assert torch.equal(S, Sn) and torch.equal(Vh, Vhn) and torch.equal(disc, dn)
        return
    rng = np.random.default_rng(9)
    s = np.concatenate([np.logspace(0, -1, 8), 1e-6 * np.logspace(0, -1, 8)])
    M = torch.as_tensor(np.stack([(_haar(rng, 16) * s) @ _haar(rng, 16).conj().T
                                  for _ in range(2)]))
    S, Vh, disc = csvd_topk(M, 8, method=method)
    Sn, _, dn = csvd_topk(M, 8, method="native")
    assert S.shape == (2, 8) and Vh.shape == (2, 8, 16)
    np.testing.assert_allclose(S.numpy(), Sn.numpy(), rtol=0, atol=1e-10)
    assert bool((disc >= dn - 1e-12).all())


def test_unknown_method_and_rectangular_jacobi_raise():
    """An unknown name raises; a rectangular 'jacobi' panel no longer
    raises but takes the V-accumulating jacobi_svd (S to 1e-12 of LAPACK's)."""
    with pytest.raises(ValueError):
        csvd_topk(torch.eye(4, dtype=torch.complex128), 2, method="natve")
    M = torch.as_tensor(_random(np.random.default_rng(2), 6)[:4])
    S, Vh, disc = csvd_topk(M, 2, method="jacobi")
    Sn, _, dn = csvd_topk(M, 2, method="native")
    np.testing.assert_allclose(S.numpy(), Sn.numpy(), atol=1e-12)
    np.testing.assert_allclose(disc.numpy(), dn.numpy(), atol=1e-12)
    assert Vh.shape == (2, 6)


def test_cpu_tensor_never_launches_the_kernel():
    before = J.KERNEL_LAUNCHES
    J.jacobi_sv(torch.as_tensor(_random(np.random.default_rng(1), 8)))
    assert J.KERNEL_LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        J._jacobi_sweep_cuda(torch.zeros(1, 4, 4, dtype=torch.complex64))

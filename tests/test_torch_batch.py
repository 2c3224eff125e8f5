"""The port's fixed-chi ensemble (evolve_batch, disorder_ensemble,
phase_grid_batch) and the at-cap SVD method of both staged evolutions, against
the JAX package.

Same fields on both sides, complex128 against float64.  'native' is LAPACK
in both packages; 'jacobi' is the torch twin of kernel 1 against the Pallas
kernel in interpret mode; 'jacobi_proj' at the cap likewise.  Traces to
1e-8 (the fixtures' parity gate; the runs agree to ~1e-14 here), chi
schedules identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timecrystal_tpu.core.truncate import TruncParams as JTruncParams
from timecrystal_tpu.dynamics.tebd import evolve_floquet_auto as jax_auto
from timecrystal_tpu.models.kicked_ising import \
    make_floquet_gates as jax_floquet_gates
from timecrystal_tpu.ops import cpx
from timecrystal_tpu.parallel import sweep as jsw
from timecrystal_tpu_torch.core.truncate import TruncParams
from timecrystal_tpu_torch.dynamics.tebd import evolve_floquet_auto
from timecrystal_tpu_torch.models import kicked_ising as tki
from timecrystal_tpu_torch.ops import jacobi_svd as J
from timecrystal_tpu_torch.parallel import sweep as tsw


R, L, CHI, N = 3, 6, 8, 6
THETAS = np.array([0.9, 0.95, 0.85]) * np.pi


def _inputs():
    rng = np.random.default_rng(3)
    return (rng.uniform(-0.3, 0.3, (R, L)), np.array([1.0, 1.1, 1.2]),
            jsw._basis_indices(L, "neel"))


def _assert_traces_equal(tt, tj, atol=1e-8):
    assert set(tt) == set(tj)
    for k in tj:
        ref = np.asarray(tj[k])
        assert tt[k].shape == ref.shape, k
        np.testing.assert_allclose(tt[k], ref, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("frame,drive", [("strict", "theta"),
                                         ("merged", "theta"),
                                         ("strict", "thetas")])
@pytest.mark.parametrize("method", ["native", "jacobi"])
def test_evolve_batch_matches_jax(method, frame, drive):
    """The fixed-chi batch: both frames with a scalar kick (0.9 pi), and a
    kick per realization (the drive-strength axis); the t=0 row and the
    derived magnetizations included."""
    h, taus, basis = _inputs()
    thetas = THETAS if drive == "thetas" else None
    kw = dict(L=L, chi=CHI, n_periods=N, theta=0.9 * np.pi, dtype="float64",
              frame=frame)
    tj = jsw.evolve_batch(
        jnp.asarray(h), jnp.asarray(taus), jnp.asarray(basis),
        jsw.SweepSpec(tp=JTruncParams(svd_min=1e-12, svd_method=method), **kw),
        thetas=None if thetas is None else jnp.asarray(thetas))
    tt = tsw.evolve_batch(
        h, taus, basis,
        tsw.SweepSpec(tp=TruncParams(svd_min=1e-12, svd_method=method), **kw),
        thetas=thetas, device="cpu")
    _assert_traces_equal(tt, tj)
    assert tt["sz_sites"].shape == (R, N + 1, L)
    assert int(tt["max_chi"][:, -1].min()) > 1, "the kick must entangle"


def test_per_realization_kick_equals_the_scalar_gates():
    """make_floquet_gates with a tensor of kick angles: kick [R, 2, 2], row
    r equal to the scalar build at thetas[r] and to the JAX package's
    x-rotation; a float pi stays the exact -i sigma_x."""
    h, taus, _ = _inputs()
    hf = torch.as_tensor(h)
    g = tki.make_floquet_gates(1.0, hf, torch.as_tensor(taus),
                               theta=torch.as_tensor(THETAS),
                               dtype=torch.complex128)
    assert g.kick.shape == (R, 2, 2)
    for r in range(R):
        one = tki.make_floquet_gates(1.0, hf[r], float(taus[r]),
                                     theta=float(THETAS[r]),
                                     dtype=torch.complex128)
        assert torch.equal(g.kick[r], one.kick)
        assert torch.equal(g.bond_gates[r], one.bond_gates)
        ref = jax_floquet_gates(1.0, jnp.asarray(h[r]), float(taus[r]),
                                theta=float(THETAS[r]), dtype=jnp.float64)
        np.testing.assert_allclose(one.kick.numpy(), cpx.to_numpy(ref.kick),
                                   rtol=0, atol=1e-15)
    pi = tki.make_floquet_gates(1.0, hf, 1.0, theta=np.pi, dtype=torch.complex128)
    assert torch.equal(pi.kick, torch.tensor([[0, -1j], [-1j, 0]],
                                             dtype=torch.complex128))


def test_phase_grid_batch_is_the_jax_grid():
    """The reference's MT19937 construction: fields, taus and the flattened
    grid axes equal to the JAX package's, exactly."""
    spec_t = tsw.SweepSpec(L=16, chi=32, n_periods=80, J=1.0)
    spec_j = jsw.SweepSpec(L=16, chi=32, n_periods=80, J=1.0)
    h_vals, T_vals = np.linspace(0.0, 0.8, 12), np.linspace(0.8, 4.0, 10)
    out_t = tsw.phase_grid_batch(h_vals, T_vals, spec_t, disorder_seed=42)
    out_j = jsw.phase_grid_batch(h_vals, T_vals, spec_j, disorder_seed=42)
    assert out_t[0].shape == (120, 16) and out_t[1].shape == (120,)
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("staged", [False, True], ids=["fixed", "staged"])
def test_disorder_ensemble_is_evolve_batch_on_its_fields(staged):
    """disorder_ensemble draws its fields from the torch.Generator
    (draw_disorder_batch) and evolves them: the same traces as the chosen
    evolution on those fields."""
    spec = tsw.SweepSpec(L=L, chi=CHI, n_periods=4, theta=0.9 * np.pi,
                         dtype="float64", tp=TruncParams(svd_min=1e-12),
                         frame="merged")
    out = tsw.disorder_ensemble(torch.Generator().manual_seed(11), R, spec,
                                0.3, 1.1, staged=staged, chi_start=4,
                                chunk_periods=2, device="cpu")
    h = tki.draw_disorder_batch(torch.Generator().manual_seed(11), R, L, 0.3)
    basis = tsw._basis_indices(L, "neel")
    if staged:
        ref, _ = tsw.evolve_batch_auto(h, np.full(R, 1.1), basis, spec,
                                       chi_start=4, chunk_periods=2,
                                       device="cpu")
    else:
        ref = tsw.evolve_batch(h, np.full(R, 1.1), basis, spec, device="cpu")
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


@pytest.mark.parametrize("option,item", [
    ("correlation_site", "Observables"),
    ("two_time_anchor", "The rest of tebd.py"),
])
def test_evolve_batch_unported_options_raise(option, item):
    """Both options are ported now, each by the ROADMAP item named beside
    it, and neither raises.  correlation_site adds zz_corr [R, n+1, L];
    two_time_anchor adds zz2t_re / zz2t_im [R, n+1, L], the t=0 row of
    zz2t_re the Neel state's s_1 s_j and of zz2t_im zero.  Either leaves
    the other traces as they were (LAPACK splits psi alike with and
    without sz_1 psi beside it)."""
    h, taus, basis = _inputs()
    spec = tsw.SweepSpec(L=L, chi=4, n_periods=1, dtype="float64")
    ref = tsw.evolve_batch(h, taus, basis, spec, device="cpu")
    out = tsw.evolve_batch(h, taus, basis, spec, device="cpu", **{option: 1})
    new = {"correlation_site": ("zz_corr",),
           "two_time_anchor": ("zz2t_re", "zz2t_im")}[option]
    assert set(out) == set(ref) | set(new)
    s = 1.0 - 2.0 * basis
    np.testing.assert_array_equal(out[new[0]][:, 0],
                                  np.broadcast_to(s[1] * s, (R, L)))
    for k in new:
        assert out[k].shape == (R, 2, L), k
    if option == "two_time_anchor":
        np.testing.assert_array_equal(out["zz2t_im"][:, 0], 0.0)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_disorder_ensemble_mesh_raises():
    """disorder_ensemble's ``mesh`` is ported: three realizations over a
    two-device CPU mesh (one padded row), fixed-chi and staged, give the
    unsharded traces bit for bit."""
    spec = tsw.SweepSpec(L=L, chi=4, n_periods=2, theta=0.9 * np.pi,
                         dtype="float64")
    mesh = tsw.BatchMesh(("cpu", "cpu"))
    for staged in (False, True):
        ref, out = (tsw.disorder_ensemble(torch.Generator().manual_seed(0), 3,
                                          spec, 0.3, 1.0, mesh=m,
                                          staged=staged, chi_start=2,
                                          device="cpu")
                    for m in (None, mesh))
        assert set(out) == set(ref) and out["sz_sites"].shape[0] == 3
        for k in ref:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def _count_proj_calls(monkeypatch):
    """Record the k of every port jacobi_proj call (csvd_topk's binding)."""
    from timecrystal_tpu_torch.ops import csvd as tcsvd

    calls: list = []

    def counting(theta, k, **kw):
        calls.append(int(k))
        return J.jacobi_proj(theta, k, **kw)

    monkeypatch.setattr(tcsvd, "jacobi_proj", counting)
    return calls


def test_batch_auto_cap_svd_method_matches_jax(monkeypatch):
    """cap_svd_method='jacobi_proj' on the batched staged evolution, as
    tests/test_parallel.py's case: L=6 with the cap at the full rank
    (chi 8), so the ladder reaches the cap, only cap-chi chunks take the
    projected SVD, and the schedule and traces equal the JAX package's."""
    h, taus, basis = _inputs()
    kw = dict(L=L, chi=8, n_periods=8, theta=0.85 * np.pi, dtype="float64")
    tj, ij = jsw.evolve_batch_auto(
        jnp.asarray(h), jnp.asarray(taus), jnp.asarray(basis),
        jsw.SweepSpec(tp=JTruncParams(svd_min=1e-12), **kw), chi_start=4,
        chunk_periods=2, cap_svd_method="jacobi_proj")
    calls = _count_proj_calls(monkeypatch)
    tt, it = tsw.evolve_batch_auto(
        h, taus, basis, tsw.SweepSpec(tp=TruncParams(svd_min=1e-12), **kw),
        chi_start=4, chunk_periods=2, cap_svd_method="jacobi_proj",
        device="cpu")
    assert it["chi_pad_used"] == ij["chi_pad_used"] == 8
    assert it["chi_escalations"] == ij["chi_escalations"]
    assert it["n_rerun_periods"] == ij["n_rerun_periods"]
    assert calls and all(k == 8 for k in calls)
    _assert_traces_equal(tt, tj)


def test_floquet_auto_cap_svd_method_matches_jax(monkeypatch):
    """cap_svd_method='jacobi_proj' on the single-chain staged evolution, as
    tests/test_tebd_generic.py's case: the chi schedule and the traces of
    the JAX package's, projected calls at the cap only."""
    kwargs = dict(n_sites=6, J=1.0, h_disorder=0.3, tau=1.2, disorder_seed=7,
                  theta=0.85 * np.pi)
    tpd = {"chi_max": 0, "svd_min": 1e-12}
    tj, times_j, ij, _ = jax_auto(dict(kwargs, dtype=jnp.float64), "neel", 8,
                                  tpd, chi_start=4, chi_limit=8,
                                  chunk_periods=2, cap_svd_method="jacobi_proj")
    calls = _count_proj_calls(monkeypatch)
    tt, times_t, it, _ = evolve_floquet_auto(
        dict(kwargs, dtype=torch.complex128, device="cpu"), "neel", 8, tpd,
        chi_start=4, chi_limit=8, chunk_periods=2,
        cap_svd_method="jacobi_proj")
    assert it["chi_pad_used"] == ij["chi_pad_used"] == 8
    assert it["chi_escalations"] == ij["chi_escalations"]
    assert calls and all(k == 8 for k in calls)
    np.testing.assert_allclose(times_t, times_j)
    for key in ("sz_sites", "loschmidt_echo", "staggered_magnetization",
                "trunc_err"):
        np.testing.assert_allclose(tt[key], np.asarray(tj[key]), rtol=0,
                                   atol=1e-8, err_msg=key)

"""The port's chi-staged ensemble evolution against the JAX package's.

Same fields, same ladder, merged frame, float64 on both sides ('auto' ->
LAPACK on the CPU in both packages).  Traces equal to 1e-8 (the fixtures'
parity gate; both runs evolve the same state with float64 LAPACK and agree
to ~1e-12 here), and the escalation schedules identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timecrystal_tpu.core.truncate import TruncParams as JTruncParams
from timecrystal_tpu.models.kicked_ising import draw_disorder_reference
from timecrystal_tpu.parallel import sweep as jsw
from timecrystal_tpu_torch.core.truncate import TruncParams
from timecrystal_tpu_torch.models import kicked_ising as tki
from timecrystal_tpu_torch.parallel import sweep as tsw


R, L, CHI, N = 2, 8, 16, 10


def _fields():
    return np.stack([draw_disorder_reference(L, 0.3, 100 + r) for r in range(R)])


def test_evolve_batch_auto_matches_jax():
    h = _fields()
    taus = np.full(R, 1.0)
    basis = jsw._basis_indices(L, "neel")
    kw = dict(L=L, chi=CHI, n_periods=N, theta=0.9 * np.pi, dtype="float64",
              frame="merged")
    tj, ij = jsw.evolve_batch_auto(
        jnp.asarray(h), jnp.asarray(taus), jnp.asarray(basis),
        jsw.SweepSpec(tp=JTruncParams(svd_min=1e-12), **kw),
        chi_start=4, chunk_periods=3, growth=2.0)
    tt, it = tsw.evolve_batch_auto(
        h, taus, tsw._basis_indices(L, "neel"),
        tsw.SweepSpec(tp=TruncParams(svd_min=1e-12), **kw),
        chi_start=4, chunk_periods=3, growth=2.0, device="cpu")
    assert it["chi_escalations"] == ij["chi_escalations"]
    assert it["chi_escalations"], "the ladder must be exercised"
    assert it["chi_pad_used"] == ij["chi_pad_used"]
    assert it["n_rerun_periods"] == ij["n_rerun_periods"]
    assert set(tt) == set(tj)
    for k in tj:
        assert tt[k].shape == np.asarray(tj[k]).shape, k
        np.testing.assert_allclose(tt[k], np.asarray(tj[k]), rtol=0,
                                   atol=1e-8, err_msg=k)


def test_stage_tp_pins_jacobi_on_cuda_only():
    tp = TruncParams()
    assert tsw._stage_tp(tp, "cuda").svd_method == "jacobi"
    assert tsw._stage_tp(tp, "cpu").svd_method == "auto"
    assert tsw._stage_tp(tp._replace(svd_method="native"),
                         "cuda").svd_method == "native"


@pytest.mark.parametrize("arg", ["checkpoint_dir", "mesh", "cap_svd_method",
                                 "correlation_site"])
def test_unported_arguments_raise(arg, tmp_path):
    """evolve_batch_auto's options, all ported now.  ``cap_svd_method``: at
    L=4 the cap (chi 4) is the full rank, so the run with the cap chunks
    on 'jacobi_core' gives the traces of the run without it to 1e-8.
    ``correlation_site`` adds zz_corr and leaves every other trace as it
    was.  ``checkpoint_dir`` and a two-device CPU ``mesh`` (three rows, so
    one padded) give the traces and schedule of the plain run bit for
    bit."""
    spec = tsw.SweepSpec(L=4, chi=4, n_periods=1, dtype="float64")
    args = (np.zeros((1, 4)), np.ones(1), tsw._basis_indices(4, "neel"))
    if arg == "cap_svd_method":
        spec = spec._replace(n_periods=4, theta=0.9 * np.pi)
        ref, _ = tsw.evolve_batch_auto(*args, spec, chi_start=2,
                                       chunk_periods=2, device="cpu")
        out, info = tsw.evolve_batch_auto(*args, spec, chi_start=2,
                                          chunk_periods=2, device="cpu",
                                          cap_svd_method="jacobi_core")
        assert info["chi_pad_used"] == 4
        for k in ref:
            np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=1e-8,
                                       err_msg=k)
        return
    if arg == "correlation_site":
        spec = spec._replace(n_periods=4, theta=0.9 * np.pi)
        ref, _ = tsw.evolve_batch_auto(*args, spec, chi_start=2,
                                       chunk_periods=2, device="cpu")
        out, _ = tsw.evolve_batch_auto(*args, spec, chi_start=2,
                                       chunk_periods=2, device="cpu",
                                       correlation_site=1)
        assert set(out) == set(ref) | {"zz_corr"}
        assert out["zz_corr"].shape == (1, 5, 4)
        np.testing.assert_array_equal(out["zz_corr"][0, 0], [-1, 1, -1, 1])
        for k in ref:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
        return
    spec = spec._replace(n_periods=4, theta=0.9 * np.pi)
    args = (np.stack([np.zeros(4), np.full(4, 0.2), np.full(4, -0.1)]),
            np.ones(3), args[2])
    opt = ({"checkpoint_dir": str(tmp_path / "ck")} if arg == "checkpoint_dir"
           else {"mesh": tsw.BatchMesh(("cpu", "cpu"))})
    ref, ref_info = tsw.evolve_batch_auto(*args, spec, chi_start=2,
                                          chunk_periods=2, device="cpu")
    out, info = tsw.evolve_batch_auto(*args, spec, chi_start=2,
                                      chunk_periods=2, device="cpu", **opt)
    assert info["chi_escalations"] == ref_info["chi_escalations"]
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_draw_disorder_batch_is_seeded_and_bounded():
    """The port's batch draw uses an explicit torch.Generator: same seed,
    same fields; values in [-h, h]."""
    a = tki.draw_disorder_batch(torch.Generator().manual_seed(3), 4, 6, 0.3)
    b = tki.draw_disorder_batch(torch.Generator().manual_seed(3), 4, 6, 0.3)
    assert a.shape == (4, 6) and torch.equal(a, b)
    assert float(a.abs().max()) <= 0.3

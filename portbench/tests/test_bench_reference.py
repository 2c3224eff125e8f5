"""The plain reference against a dense exact evolution, and the TF32
rounding of its control."""

import numpy as np
import pytest
import torch

from portbench.reference import tebd


def _dense_period(L, J, h, tau, theta):
    """U_F = H K H as a dense 2^L matrix (site 0 the most significant)."""
    z = np.array([1.0, -1.0])
    E = np.zeros(2 ** L)
    for idx in range(2 ** L):
        s = z[[(idx >> (L - 1 - j)) & 1 for j in range(L)]]
        E[idx] = sum(J * s[b] * s[b + 1] + h[b] * s[b] + h[b + 1] * s[b + 1]
                     for b in range(L - 1))
    half = np.exp(-0.5j * tau * E)
    k = np.array([[np.cos(theta / 2), -1j * np.sin(theta / 2)],
                  [-1j * np.sin(theta / 2), np.cos(theta / 2)]])
    K = np.ones((1, 1))
    for _ in range(L):
        K = np.kron(K, k)
    return half[:, None] * K * half[None, :]


def _dense_traces(L, J, h, tau, theta, basis, n):
    U = _dense_period(L, J, h, tau, theta)
    psi0 = np.zeros(2 ** L, complex)
    psi0[int("".join(str(b) for b in basis), 2)] = 1.0
    bits = (np.arange(2 ** L)[:, None] >> (L - 1 - np.arange(L))[None, :]) & 1
    zdiag = 1.0 - 2.0 * bits
    psi, sz, le = psi0, [], []
    for _ in range(n + 1):
        p = np.abs(psi) ** 2
        sz.append(p @ zdiag)
        le.append(abs(np.vdot(psi0, psi)) ** 2)
        psi = U @ psi
    return np.array(sz), np.array(le)


@pytest.mark.parametrize("L,frame", [(6, "strict"), (7, "merged"),
                                     (8, "strict"), (8, "merged")])
def test_reference_matches_dense_evolution(L, frame):
    rng = np.random.default_rng(L)
    R, n = 2, 12
    h = rng.uniform(-0.3, 0.3, (R, L))
    thetas = np.array([0.9 * np.pi, 0.8 * np.pi])
    basis = np.arange(L) % 2
    tr = tebd.evolve(h, 1.0, thetas, basis, n, 1.0,
                     dict(chi_cap=64, svd_min=1e-14, trunc_cut=0.0),
                     frame=frame, workers=1)
    for r in range(R):
        sz, le = _dense_traces(L, 1.0, h[r], 1.0, thetas[r], basis, n)
        assert np.max(np.abs(tr["sz_sites"][r] - sz)) < 1e-10
        assert np.max(np.abs(tr["loschmidt_echo"][r] - le)) < 1e-10
    assert tr["trunc_err"].max() < 1e-20
    assert tr["max_chi"].max() <= 2 ** (L // 2)
    signs = np.where(np.arange(L) % 2 == 0, 1.0, -1.0)
    np.testing.assert_allclose(tr["staggered_magnetization"],
                               (tr["sz_sites"] * signs).sum(-1) / L)


def test_truncation_keeps_the_cap_and_reports_the_weight():
    rng = np.random.default_rng(3)
    L, n = 8, 10
    h = rng.uniform(-0.3, 0.3, (1, L))
    basis = np.arange(L) % 2
    full = tebd.evolve(h, 1.0, 0.85 * np.pi, basis, n, 1.0,
                       dict(chi_cap=64, svd_min=1e-14), workers=1)
    cut = tebd.evolve(h, 1.0, 0.85 * np.pi, basis, n, 1.0,
                      dict(chi_cap=4, svd_min=1e-14, trunc_cut=1e-7),
                      workers=1)
    assert cut["max_chi"].max() == 4 and full["max_chi"].max() > 4
    assert cut["trunc_err"].max() > 1e-8
    first = int(np.argmax(cut["trunc_err"][0] > 1e-8))
    assert np.abs(cut["sz_sites"][0, :first] - full["sz_sites"][0, :first]).max() < 1e-6


def test_keep_mask_semantics():
    S = torch.tensor([[1.0, 0.1, 1e-4, 1e-8, 0.0]], dtype=torch.float64)
    assert tebd.keep_mask(S, 5, 1e-12, 0.0).tolist() == [[True, True, True, True, False]]
    assert tebd.keep_mask(S, 2, 1e-12, 0.0).tolist() == [[True, True, False, False, False]]
    # the tail 1e-4, 1e-8 weighs 1e-8 + 1e-16 <= (1e-3)^2 once 0 is dropped
    assert tebd.keep_mask(S, 5, 1e-12, 1e-3).tolist() == [[True, True, False, False, False]]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0, 1.0 + 2 ** -12],
                     dtype=torch.float32)
    y = tebd.tf32_round(x)
    assert y.tolist() == [1.0, 1.0 + 2 ** -9, -3.0, 1.0]
    z = torch.randn(64, dtype=torch.complex64)
    rel = ((tebd.tf32_round(z) - z).abs() / z.abs()).max()
    assert 1e-5 < rel < 2 ** -10


def test_control_precision_drifts_from_the_reference():
    rng = np.random.default_rng(5)
    L, n = 8, 10
    h = rng.uniform(-0.3, 0.3, (2, L))
    basis = np.arange(L) % 2
    trunc = dict(chi_cap=16, svd_min=1e-12, trunc_cut=1e-7)
    ref = tebd.evolve(h, 1.0, 0.9 * np.pi, basis, n, 1.0, trunc, workers=1)
    ctl = tebd.evolve(h, 1.0, 0.9 * np.pi, basis, n, 1.0, trunc,
                      precision="tf32", workers=1)
    gap = np.abs(ref["sz_sites"] - ctl["sz_sites"]).max()
    assert 1e-5 < gap < 0.1
    wit = tebd.evolve(h, 1.0, 0.9 * np.pi, basis, n, 1.0, trunc,
                      precision="complex64", workers=1)
    assert wit["sz_sites"].dtype == np.float64
    assert 1e-9 < np.abs(ref["sz_sites"] - wit["sz_sites"]).max() < gap / 10


def test_until_trunc_stops_a_chain_after_its_first_truncating_period():
    rng = np.random.default_rng(4)
    L, n = 8, 12
    h = rng.uniform(-0.3, 0.3, (2, L))
    thetas = np.array([np.pi, 0.8 * np.pi])       # a product state, and not
    trunc = dict(chi_cap=4, svd_min=1e-12, trunc_cut=1e-7)
    whole = tebd.evolve(h, 1.0, thetas, np.arange(L) % 2, n, 1.0, trunc,
                        workers=1)
    cut = tebd.evolve(h, 1.0, thetas, np.arange(L) % 2, n, 1.0, trunc,
                      workers=1, until_trunc=1e-8)
    stop = int(np.argmax(whole["trunc_err"][1] > 1e-8))
    assert 0 < stop < n
    np.testing.assert_array_equal(cut["sz_sites"][0], whole["sz_sites"][0])
    np.testing.assert_allclose(cut["sz_sites"][1, :stop + 1],
                               whole["sz_sites"][1, :stop + 1], atol=1e-14)
    assert np.isnan(cut["sz_sites"][1, stop + 1:]).all()
    assert np.isnan(cut["trunc_err"][1, stop + 1:]).all()


def test_frozen_scoring_recipe_matches_the_project_recipe():
    from portbench.reference import scoring
    from timecrystal_tpu_torch.core.observables import (
        extract_subharmonic_amplitude, subharmonic_weight_fraction)

    rng = np.random.default_rng(5)
    t = np.arange(81) * 2.0
    worst64 = worst32 = 0.0
    for i in range(60):
        x = (rng.uniform(0, 1) * np.cos(np.pi * t / 2.0)
             + rng.uniform(0, 1) * rng.normal(0, 1, len(t)))
        if i == 0:
            x = (-1.0) ** np.arange(len(t))
        want = (extract_subharmonic_amplitude(t, x, 2.0),
                subharmonic_weight_fraction(t, x, 2.0))
        for dtype in (torch.float64, torch.float32):
            got = scoring.scores(t, x, 2.0, dtype)
            gap = max(abs(got[0] - want[0]), abs(got[1] - want[1]))
            if dtype == torch.float64:
                worst64 = max(worst64, gap)
            else:
                worst32 = max(worst32, gap)
    assert worst64 < 1e-13
    assert 1e-9 < worst32 < 1e-5
    short = scoring.score_points(t[:9], np.ones((2, 9)), 2.0)
    assert np.all(short["A2T"] == 0) and np.all(short["success"])
    nan = np.ones((1, len(t)))
    nan[0, 3] = np.nan
    bad = scoring.score_points(t, nan, 2.0)
    assert not bad["success"][0] and bad["A2T"][0] == bad["weight"][0] == 0

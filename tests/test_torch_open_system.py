"""The port's open-system dynamics and memory-lifetime analysis: the
stochastic dephasing channel and the superket Lindblad solver against the
JAX package, the channel's statistics, and ``analysis/memory.py`` with the
``--memory-diagram`` CLI.

The stochastic scan takes its noise as an input: the JAX package's key
stream (``key, sub = split(key)``, then ``normal(sub, (L,))`` a period) is
replayed here and passed through ``convert.noise_from_numpy``, so both
packages see the same angles; traces to 1e-8 (complex128 against
float64).  Where the port draws its own noise (a ``torch.Generator`` or a
numpy seed) parity is statistical: E<sx>(t) = e^{-2 gamma t}.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timecrystal_tpu.analysis import memory as jmem
from timecrystal_tpu.core.mps import create_initial_state as jax_state
from timecrystal_tpu.core.truncate import TruncParams as JTruncParams
from timecrystal_tpu.dynamics import open_system as jos
from timecrystal_tpu.dynamics import tebd as jtebd
from timecrystal_tpu.models.kicked_ising import KickedIsingModel as JModel
from timecrystal_tpu_torch import convert
from timecrystal_tpu_torch import main as tmain
from timecrystal_tpu_torch.analysis import memory as tmem
from timecrystal_tpu_torch.core import gates as G
from timecrystal_tpu_torch.core.mps import MPS, create_initial_state, norm_squared
from timecrystal_tpu_torch.core.truncate import TruncParams
from timecrystal_tpu_torch.dynamics import open_system as tos
from timecrystal_tpu_torch.dynamics import tebd as ttebd
from timecrystal_tpu_torch.models.kicked_ising import KickedIsingModel
from timecrystal_tpu_torch.parallel import sweep as tsw

C128 = torch.complex128
CPU = dict(device="cpu", dtype=C128)
TOL = 1e-8


def _replay(key, n_periods, L):
    """The unit normals the JAX scan draws from ``key``: [n_periods, L]."""
    out = []
    for _ in range(n_periods):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (L,), jnp.float64)))
    return np.stack(out)


def _kicked(L, chi, theta=0.92 * np.pi, seed=1):
    kw = dict(J=1.0, h_disorder=0.3, tau=1.0, disorder_seed=seed, theta=theta,
              chi=chi)
    return (JModel(L, dtype=jnp.float64, **kw),
            KickedIsingModel(L, **CPU, **kw))


@pytest.mark.parametrize("n_traj", [0, 3], ids=["one", "ensemble"])
def test_stochastic_scan_matches_jax_with_replayed_noise(n_traj):
    """One trajectory, and three as one leading axis (the JAX package's
    vmap over keys): sz, sx, LE, max_chi and trunc_err to 1e-8."""
    L, chi, n, gdt = 6, 16, 5, 0.1
    jm, tm = _kicked(L, chi)
    jp = jax_state(L, "neel", chi=chi, dtype=jnp.float64)
    tp = create_initial_state(L, "neel", chi=chi, **CPU)
    jtp, ttp = JTruncParams(svd_min=1e-12), TruncParams(svd_min=1e-12)

    def jax_run(k):
        return jos._evolve_stochastic_scan(jp, jm.gates, k, gdt, n, jtp,
                                           ref_state=jp)[2]

    if n_traj:
        keys = jax.random.split(jax.random.PRNGKey(7), n_traj)
        jtr = jax.vmap(jax_run)(keys)
        normals = np.stack([_replay(k, n, L) for k in keys])
    else:
        key = jax.random.PRNGKey(7)
        jtr = jax_run(key)
        normals = _replay(key, n, L)
    _, ttr = tos._evolve_stochastic_scan(
        tp, tm.gates, convert.noise_from_numpy(normals, device="cpu"), gdt, n,
        ttp, ref_state=tp)
    assert set(ttr) == set(jtr)
    for k in jtr:
        np.testing.assert_allclose(ttr[k].numpy(), np.asarray(jtr[k]), rtol=0,
                                   atol=TOL, err_msg=k)
    assert int(ttr["max_chi"].max()) > 1


def test_generator_advances_and_trajectories_differ():
    """Repeated calls draw fresh noise from the instance's generator (the
    same seed replays the first call); an ensemble's trajectories are
    distinct; the exact-pi echo stays protected; one period stays
    normalized."""
    L, chi = 4, 8
    _, tm = _kicked(L, chi, theta=0.9 * np.pi, seed=0)
    psi0 = create_initial_state(L, "all_up", chi=chi, **CPU)
    ose = tos.OpenSystemEvolution(tm, gamma=0.3, max_chi=chi, seed=7)
    tr1, times, _ = ose.evolve(psi0, 5)
    tr2, _, _ = ose.evolve(psi0, 5)
    again, _, _ = tos.OpenSystemEvolution(tm, gamma=0.3, max_chi=chi,
                                          seed=7).evolve(psi0, 5)
    assert not np.allclose(tr1["sz_sites"], tr2["sz_sites"])
    np.testing.assert_array_equal(again["sz_sites"], tr1["sz_sites"])
    assert times == [2.0 * p for p in range(1, 6)]
    ens, _, info = ose.evolve_ensemble(psi0, 4, n_trajectories=5)
    pt = ens["per_trajectory"]
    assert pt["max_chi"].shape == pt["trunc_err"].shape == (5, 4)
    assert float(ens["sz_sites_std"].max()) > 1e-3
    assert info["n_trajectories"] == 5

    _, tpi = _kicked(6, 16, theta=np.pi, seed=3)
    neel = create_initial_state(6, "neel", chi=16, **CPU)
    le = tos.OpenSystemEvolution(tpi, gamma=0.2, max_chi=16).evolve(neel, 8)[0][
        "loschmidt_echo"]
    np.testing.assert_allclose(le[0::2], 0.0, atol=1e-10)
    np.testing.assert_allclose(le[1::2], 1.0, atol=1e-10)
    psi1 = tos.OpenSystemEvolution(tpi, gamma=0.01).evolve_floquet_period(neel)
    assert abs(float(norm_squared(psi1)) - 1.0) < 1e-10


def test_ensemble_average_reproduces_dephasing_decay():
    """No drive (J = h = 0, theta = 0) from |+x>: the channel average of
    <sx> is e^{-2 gamma t} (600 trajectories as one leading axis)."""
    L, gamma, tau, n = 4, 0.05, 0.5, 8
    m = KickedIsingModel(L, 0.0, 0.0, tau, h_fields=np.zeros(L), theta=0.0,
                         chi=8, **CPU)
    psi0 = tmem._x_plus_state(L, 8, C128, "cpu")
    tr, _, _ = tos.OpenSystemEvolution(m, gamma=gamma, max_chi=8, seed=3) \
        .evolve_ensemble(psi0, n, n_trajectories=600)
    expected = np.exp(-2 * gamma * n * 2 * tau)
    assert abs(tr["sx_sites"][-1].mean() - expected) < 0.05


def _rho_plus_pair(L, chi=16):
    """|+><+|^L as a superket MPS in both packages (d = 4 through
    convert.mps_from_numpy)."""
    from timecrystal_tpu.core.mps import MPS as JMPS
    from timecrystal_tpu.ops.cpx import C

    rho = jos.density_mps_from_product(np.zeros(L, np.int32), chi, jnp.float64)
    B_re = rho.B.re.at[:, 0, :, 0].set(0.5 * jnp.ones((L, 4), jnp.float64))
    rj = JMPS(B=C(B_re, rho.B.im), lam=rho.lam)
    rt = convert.mps_from_numpy(np.asarray(B_re), np.asarray(rho.B.im),
                                np.asarray(rho.lam), device="cpu")
    assert rt.d == 4 and rt.dtype == C128
    return rj, rt


def test_lindblad_matches_jax():
    """L=4 transverse-field chain with dephasing: every stored rho's <X>,
    <Y>, <Z> per site and the final trace against the JAX package to 1e-8;
    the superket helpers on the way."""
    kw = dict(Jz=1.0, hx=0.4, hz=0.2)
    rj, rt = _rho_plus_pair(4)
    assert abs(complex(tos.trace_rho(rt)) - 1.0) < 1e-12
    jr, jt, jinfo = jos.LindbladEvolution(
        jtebd.spin_chain_model(4, **kw), 0.08, max_chi=16,
        dtype=jnp.float64).evolve(rj, 0.6, 0.05, observe_every=4)
    tr, tt, tinfo = tos.LindbladEvolution(
        ttebd.spin_chain_model(4, **kw), 0.08, max_chi=16, **CPU).evolve(
            rt, 0.6, 0.05, observe_every=4)
    assert tt == jt and len(tr) == len(jr)
    assert abs(tinfo["final_trace"] - jinfo["final_trace"]) < TOL
    for name in ("X", "Y", "Z"):
        op = G.pauli_matrices()[name]
        for a, b in zip(jr, tr):
            np.testing.assert_allclose(tos.expectation_rho_one_site(b, op),
                                       jos.expectation_rho_one_site(a, op),
                                       rtol=0, atol=TOL, err_msg=name)


def test_superket_helpers_and_pure_dephasing():
    """Tr(O rho) of a complex O (rho = (I + sigma_y)/2 per site gives
    <sigma_y> = 1), vec(I) and |b><b|; with H = 0 the coherences decay as
    e^{-2 gamma t} exactly and the populations stay."""
    L = 2
    rho = tos.density_mps_from_product(np.zeros(L, np.int32), 8, **CPU)
    B = rho.B.clone()
    B[:, 0, :, 0] = torch.tensor([0.5, -0.5j, 0.5j, 0.5], dtype=C128)
    sy = tos.expectation_rho_one_site(MPS(B=B, lam=rho.lam), G.SIGMA_Y)
    np.testing.assert_allclose(sy, 1.0, atol=1e-12)
    assert abs(complex(tos.trace_rho(rho)) - 1.0) < 1e-12
    ident = tos.vec_identity_mps(3, 4, **CPU)
    assert abs(complex(tos.trace_rho(ident)) - 8.0) < 1e-12

    L, gamma = 3, 0.1
    H = ttebd.NearestNeighborModel(np.zeros((L - 1, 4, 4)))
    _, rt = _rho_plus_pair(L, chi=8)
    rhos, times, _ = tos.LindbladEvolution(H, gamma, max_chi=8, **CPU).evolve(
        rt, 2.0, 0.1)
    sx = tos.expectation_rho_one_site(rhos[-1], G.SIGMA_X)
    np.testing.assert_allclose(sx.real, np.exp(-2 * gamma * times[-1]), atol=TOL)
    sz = tos.expectation_rho_one_site(rhos[-1], G.SIGMA_Z)
    np.testing.assert_allclose(sz.real, 0.0, atol=1e-10)


@pytest.mark.parametrize("case", ["perfect", "scaled", "exponential", "flat",
                                  "noisy_tail", "immediate", "nan"])
def test_envelope_and_fit_match_jax(case):
    """memory_envelope and fit_memory_lifetime (the port's own copies) give
    the JAX package's numbers on the same traces."""
    t = np.linspace(2, 80, 40)
    rng = np.random.default_rng(0)
    env = {"perfect": np.array([(-1.0) ** p for p in range(1, 41)]),
           "scaled": 0.7 * np.array([(-1.0) ** p for p in range(1, 41)]),
           "exponential": np.exp(-t / 7.0), "flat": np.ones(40),
           "noisy_tail": np.where(t > 30, rng.uniform(-0.2, 0.2, 40),
                                  np.exp(-t / 10.0)),
           "immediate": np.eye(40)[0], "nan": np.full(40, np.nan)}[case]
    for norm in (True, False):
        np.testing.assert_array_equal(tmem.memory_envelope(env, norm),
                                      jmem.memory_envelope(env, norm))
    a, b = tmem.fit_memory_lifetime(t, env), jmem.fit_memory_lifetime(t, env)
    assert a == b or (np.isnan(a) and np.isnan(b)), (a, b)


MEM = dict(h_over_J=0.3, chi=16, **CPU)


def test_exact_pi_protection():
    """At eps = 0 the Floquet map keeps z-basis states: the envelope is flat
    at any gamma."""
    res = tmem.scan_memory_lifetime([0.05], L=8, eps=0.0, n_periods=16,
                                    n_trajectories=4, coherence_leg=False, **MEM)
    assert res["envelope"].min() > 0.999
    assert res["tau_bit"][0] > 1e4


def test_bare_qubit_t2_anchor_and_protection_window():
    """The fitted bare-qubit T2 within 30% of 1/(2 gamma); the DTC bit
    outlives it by far."""
    res = tmem.scan_memory_lifetime([0.05], L=8, eps=0.04, n_periods=40,
                                    n_trajectories=32, coherence_leg=True, **MEM)
    t2 = res["t2_qubit"][0]
    assert abs(t2 - 10.0) / 10.0 < 0.3, t2
    np.testing.assert_allclose(res["t2_analytic"][0], 10.0)
    assert res["tau_bit"][0] > 5.0 * t2, (res["tau_bit"], t2)
    assert res["sx_coherence"].shape == (1, 40)


def test_monotone_envelope_in_gamma():
    res = tmem.scan_memory_lifetime([0.01, 0.2], L=8, eps=0.08, n_periods=30,
                                    n_trajectories=16, coherence_leg=False, **MEM)
    final = res["envelope"][:, -5:].mean(axis=1)
    assert final[0] > final[1], final


@pytest.mark.parametrize("scan", ["gamma", "eps"])
def test_chunked_matches_one_program(scan):
    """Rows carry their own noise, fields and kick: chunks of rows give the
    one-batch traces."""
    kw = dict(L=6, h_over_J=0.3, n_periods=8, n_trajectories=5, chi=8, **CPU)
    if scan == "gamma":
        def run(cs):
            return tmem.scan_memory_lifetime([0.02, 0.08], eps=0.05,
                                             coherence_leg=True, chunk_size=cs,
                                             **kw)
    else:
        def run(cs):
            return tmem.scan_memory_vs_eps([0.0, 0.1], 0.05, chunk_size=cs, **kw)
    one, chunked = run(0), run(3)
    for k in ("envelope", "envelope_std") + (("sx_coherence",)
                                              if scan == "gamma" else ()):
        np.testing.assert_allclose(chunked[k], one[k], rtol=0, atol=1e-12,
                                   err_msg=k)


def test_eps_axis_opens_the_channel():
    res = tmem.scan_memory_vs_eps([0.0, 0.12], gamma=0.1, L=8, n_periods=24,
                                  n_trajectories=12, **MEM)
    assert res["envelope"].shape == (2, 24)
    final0, final1 = res["envelope"][:, -4:].mean(axis=1)
    assert final0 > 0.999 and final1 < final0 - 0.02, (final0, final1)
    assert res["tau_bit"][1] < res["tau_bit"][0]


def _ported(which, tmp_path):
    """The options that used to raise, ported: each returns the plain run's
    numbers bit for bit.  'mesh': scan_memory_lifetime over a two-device
    CPU mesh (three rows a leg, one padded); 'checkpoint': the eps scan
    through checkpoint_dir in chunks of one row, run twice (the second
    call loads every chunk); 'ensemble': evolve_ensemble's trajectories
    over a two-device CPU mesh, the noise drawn from the same seed."""
    kw = dict(L=6, n_periods=2, chi=8, n_trajectories=3, **CPU)
    if which == "mesh":
        ref = tmem.scan_memory_lifetime([0.02], **kw)
        out = tmem.scan_memory_lifetime([0.02], mesh=tsw.BatchMesh(("cpu",) * 2),
                                        **kw)
    elif which == "checkpoint":
        ref = tmem.scan_memory_vs_eps([0.0, 0.1], 0.02, **kw)
        ck = dict(kw, checkpoint_dir=str(tmp_path / "ck"), chunk_size=1)
        tmem.scan_memory_vs_eps([0.0, 0.1], 0.02, **ck)
        out = tmem.scan_memory_vs_eps([0.0, 0.1], 0.02, **ck)
    else:
        psi0 = create_initial_state(4, chi=4, **CPU)
        ref = tos.OpenSystemEvolution(_kicked(4, 4)[1], 0.1).evolve_ensemble(
            psi0, 2, 3)[0]
        out = tos.OpenSystemEvolution(_kicked(4, 4)[1], 0.1).evolve_ensemble(
            psi0, 2, 3, mesh=tsw.BatchMesh(("cpu",) * 2))[0]
        ref, out = ref["per_trajectory"] | ref, out["per_trajectory"] | out
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(out[k], v, err_msg=k)


@pytest.mark.parametrize("call,err,match", [
    (lambda tmp: tmem.scan_memory_lifetime([0.02], L=6, n_periods=2, chi=8,
                                           n_trajectories=2, chunk_size=-1,
                                           **CPU),
     ValueError, "chunk_size"),
    (lambda tmp: tmem.scan_memory_lifetime([], L=6, n_periods=2, chi=8,
                                           n_trajectories=2, **CPU),
     ValueError, "empty batch"),
    (lambda tmp: _ported("mesh", tmp), None, None),
    (lambda tmp: _ported("checkpoint", tmp), None, None),
    (lambda tmp: _ported("ensemble", tmp), None, None),
], ids=["<lambda>-ValueError-chunk_size", "<lambda>-ValueError-empty batch",
        "<lambda>-NotImplementedError-'Scale-out'0",
        "<lambda>-NotImplementedError-'Utilities'",
        "<lambda>-NotImplementedError-'Scale-out'1"])
def test_bad_arguments_and_unported_options_raise(call, err, match, tmp_path):
    """Bad arguments raise; the mesh and checkpoint options, which raised
    before they were ported, reproduce the plain runs (``_ported``)."""
    if err is None:
        call(tmp_path)
        return
    with pytest.raises(err, match=match):
        call(tmp_path)


def test_cli_memory_diagram_on_the_cpu_writes_the_figure(tmp_path, monkeypatch):
    """python -m timecrystal_tpu_torch --cpu --memory-diagram, the scans cut
    to L=6, 6 periods, 2 trajectories, chi 8: memory_lifetime.{png,pdf} in
    ./figures."""
    real = tmem.generate_memory_figure

    def cut(params, **kw):
        return real(params, gammas=[0.02, 0.1], L=6, n_periods=6,
                    n_trajectories=2, n_realizations=1, chi=8,
                    eps_values=[0.0, 0.1], **kw)

    monkeypatch.setattr(tmem, "generate_memory_figure", cut)
    monkeypatch.chdir(tmp_path)
    config = Path(__file__).resolve().parents[1] / "config.txt"
    tmain.main(["--cpu", "--memory-diagram", "--config", str(config)])
    for ext in ("png", "pdf"):
        assert (tmp_path / "figures" / f"memory_lifetime.{ext}").stat().st_size > 0

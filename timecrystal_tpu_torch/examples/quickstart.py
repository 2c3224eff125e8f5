"""Quickstart: simulate a disordered discrete time crystal and detect the
period-doubling signature.  Port of the JAX package's
``examples/quickstart.py``: the same five sections at its sizes.

    python -m timecrystal_tpu_torch.examples.quickstart          # the CUDA device
    python -m timecrystal_tpu_torch.examples.quickstart --cpu    # the CPU, complex128

Each section is a function that returns its numbers; ``main()`` runs them in
order and prints the JAX script's summary.  Without ``--cpu`` the run needs
a CUDA device and raises when there is none.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..analysis.detection import stringent_dtc_detection
from ..analysis.memory import scan_memory_lifetime
from ..analysis.phase_diagram import _spec_dtype
from ..core.mps import create_initial_state
from ..core.observables import (dynamic_structure_factor,
                                extract_subharmonic_amplitude)
from ..core.truncate import TruncParams
from ..dynamics.tebd import CustomFloquet
from ..models.kicked_ising import KickedIsingModel, draw_disorder_batch
from ..models.long_range import scan_interaction_range
from ..parallel.sweep import (SweepSpec, _basis_indices, ensemble_a2t,
                              evolve_batch, evolve_batch_auto)

# a slightly imperfect pi pulse: theta != pi makes the dynamics entangling
THETA = 0.97 * np.pi


def _fields(h_fields, seed: int, R: int, L: int) -> np.ndarray:
    """The given disorder fields [R, L], or a U[-0.3, 0.3] draw from a
    torch.Generator seeded with ``seed``."""
    if h_fields is not None:
        return np.asarray(h_fields, float)
    gen = torch.Generator().manual_seed(seed)
    return draw_disorder_batch(gen, R, L, 0.3).numpy()


def single_chain(L: int = 20, chi: int = 64, n_periods: int = 100,
                 device="cuda", dtype=torch.complex64) -> dict:
    """One disordered kicked-Ising chain (h = 0.3, seed 42) from Neel
    through ``CustomFloquet.evolve_floquet_traces``: {traces, times, info,
    a2t, dtc_score}."""
    model = KickedIsingModel(n_sites=L, J=1.0, h_disorder=0.3, tau=1.0,
                             disorder_seed=42, chi=chi, theta=THETA,
                             dtype=dtype, device=device)
    psi0 = create_initial_state(L, "neel", chi=chi, dtype=dtype, device=device)
    flo = CustomFloquet(model, TruncParams(chi_max=chi, svd_min=1e-7))
    traces, times, info = flo.evolve_floquet_traces(psi0, n_periods=n_periods)
    period = 2 * model.tau
    times = np.asarray(times)
    return dict(traces=traces, times=times, info=info,
                a2t=extract_subharmonic_amplitude(
                    times, traces["staggered_magnetization"], period),
                dtc_score=stringent_dtc_detection(traces["loschmidt_echo"],
                                                  times, period))


def ensemble(R: int = 8, L: int = 20, chi: int = 64, n_periods: int = 60,
             h_fields=None, seed: int = 0, device="cuda",
             dtype=torch.complex64) -> dict:
    """The disorder ensemble on the production path: R realizations as one
    chi-staged batch (``evolve_batch_auto``, chi from 16, chunks of 10
    merged periods), the cap chunks on 'jacobi_core' on the card (on the CPU
    LAPACK throughout).  {traces, info, a2t [R], h_fields}."""
    h = _fields(h_fields, seed, R, L)
    spec = SweepSpec(L=L, chi=chi, n_periods=n_periods, theta=THETA,
                     tp=TruncParams(chi_max=0, svd_min=1e-7),
                     dtype=_spec_dtype(dtype), frame="merged")
    taus = np.full(len(h), 1.0)
    cap = "jacobi_core" if torch.device(device).type == "cuda" else None
    traces, info = evolve_batch_auto(h, taus, _basis_indices(L, "neel"), spec,
                                     chi_start=16, chunk_periods=10,
                                     cap_svd_method=cap, device=device)
    return dict(traces=traces, info=info, h_fields=h,
                a2t=ensemble_a2t(traces, taus, device=device))


def correlator_map(R: int = 8, L: int = 12, chi: int = 32, n_periods: int = 20,
                   site: int = 6, h_fields=None, seed: int = 1,
                   device="cuda", dtype=torch.complex64) -> dict:
    """The disorder-averaged C(r, t) = mean_h <sz_i sz_j(t)> from the anchor
    ``site`` and the two-time map's S(k, omega), both measured in the one
    batched evolution (``evolve_batch`` with ``correlation_site`` and
    ``two_time_anchor``).  {traces, c_rt, c2t, freqs, ks, S, peak_k,
    peak_f, h_fields}."""
    tau = 1.0
    h = _fields(h_fields, seed, R, L)
    spec = SweepSpec(L=L, chi=chi, n_periods=n_periods, theta=THETA,
                     tp=TruncParams(chi_max=0, svd_min=1e-7),
                     dtype=_spec_dtype(dtype))
    tr = evolve_batch(h, np.full(len(h), tau), _basis_indices(L, "neel"), spec,
                      correlation_site=site, two_time_anchor=site,
                      device=device)
    c_rt = tr["zz_corr"].mean(axis=0)                 # [n+1, L]
    c2t = tr["zz2t_re"].mean(axis=0)                  # [n+1, L]
    times = np.arange(1, c2t.shape[0]) * 2 * tau
    freqs, ks, S = dynamic_structure_factor(times, c2t[1:], device=device)
    S = S.cpu().numpy()
    fi, ki = np.unravel_index(int(np.argmax(S)), S.shape)
    return dict(traces=tr, c_rt=c_rt, c2t=c2t, freqs=freqs, ks=ks, S=S,
                peak_k=float(ks[ki]), peak_f=float(freqs[fi]), h_fields=h)


def interaction_range(alphas=(1.0, 1.5, None), L: int = 10, chi: int = 32,
                      n_periods: int = 16, n_realizations: int = 2,
                      device="cuda", dtype=torch.complex64) -> dict:
    """A2T against the interaction range alpha (None = nearest neighbour):
    power-law couplings through an FSM MPO and two-site TDVP
    (``scan_interaction_range``)."""
    return scan_interaction_range(list(alphas), L=L, h_disorder=0.25,
                                  tau=2.0, theta=THETA, n_periods=n_periods,
                                  n_realizations=n_realizations, chi=chi,
                                  substeps=2, device=device, dtype=dtype)


def memory_lifetime(gammas=(0.01, 0.05), L: int = 10, n_periods: int = 40,
                    n_trajectories: int = 8, chi: int = 24, device="cuda",
                    dtype=torch.complex64) -> dict:
    """How long the stored Ising bit survives dephasing against the bare
    qubit's T2 = 1/(2 gamma) (``scan_memory_lifetime`` at eps = 0.04)."""
    return scan_memory_lifetime(list(gammas), L=L, h_over_J=0.3, eps=0.04,
                                n_periods=n_periods,
                                n_trajectories=n_trajectories, chi=chi,
                                device=device, dtype=dtype)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU in complex128 instead of the CUDA device")
    args = ap.parse_args(argv)
    from ..main import run_device

    device, dtype = run_device(args.cpu)
    run = dict(device=device, dtype=dtype)

    one = single_chain(**run)
    tr, info = one["traces"], one["info"]
    print(f"throughput:            {info['periods_per_second']:.1f} periods/s")
    print(f"final max bond dim:    {info['final_bond_dim']}")
    print(f"subharmonic A2T:       {one['a2t']:.3f}   (DTC if ~1)")
    print(f"stringent DTC score:   {one['dtc_score']:.3f} (threshold 0.3)")
    print(f"staggered magnetization, first 6 periods: "
          f"{np.round(tr['staggered_magnetization'][:6], 3)}")

    ens = ensemble(**run)
    print(f"\nensemble of {len(ens['a2t'])} disorder realizations "
          f"({ens['info']['chain_periods_per_second']:.0f} chain-periods/s, "
          f"chi staged to {ens['info']['chi_pad_used']}):")
    print(f"A2T per realization: {np.round(ens['a2t'], 3)}")

    cor = correlator_map(**run)
    print(f"\ndisorder-averaged C(r, t) from site 6 "
          f"(rows t=0, 10, 20 periods):")
    for t in (0, 10, 20):
        print(f"  t={t:2d}: {np.round(cor['c_rt'][t], 2)}")
    print(f"S(k, omega) peak of the disorder-averaged two-time C(r, t): "
          f"k = {cor['peak_k']:.3f} (pi = {np.pi:.3f}), f = "
          f"{cor['peak_f']:.3f} (top bin below f_drive/2 = {1 / 4:.3f})")

    rng = interaction_range(**run)
    print("\nsubharmonic A2T vs interaction range (None = nearest-neighbor):")
    for a, v, s in zip(rng["alphas"], rng["a2t"], rng["a2t_std"]):
        label = "inf (NN)" if a is None else f"{a:.1f}"
        print(f"  alpha = {label:8s}: A2T = {v:.3f} +- {s:.3f}")

    mem = memory_lifetime(**run)
    print("\nDTC memory lifetime vs dephasing (L=10, eps=0.04):")
    for g, tb, t2 in zip(mem["gammas"], mem["tau_bit"], mem["t2_qubit"]):
        print(f"  gamma = {g:.3f}: stored-bit tau = {tb:8.1f} J^-1,  "
              f"bare-qubit T2 = {t2:6.1f} J^-1  "
              f"(protection x{tb / t2:.0f})")


if __name__ == "__main__":
    main()

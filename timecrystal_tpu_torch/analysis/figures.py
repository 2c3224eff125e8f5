"""Figures A-D: the simulations and their rendering.

Port of ``timecrystal_tpu/analysis/figures.py``: the reference's
parameters, seeds, output files and panels, each figure one chi-escalating
evolution (``dynamics.tebd.evolve_floquet_auto``) on ``device``.  Figure C
is the reference's post-hoc decay of closed-system traces, not a Lindblad
solve; Figure D plots the true per-site <sigma_z_i(t)> unless
``synthetic_parity`` asks for the reference's noisy approximation.
matplotlib is imported by the rendering only.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.observables import calculate_fourier_spectrum
from ..dynamics.tebd import evolve_floquet_auto

FIGURE_SITES = [1, 3, 5, 7, 9, 11]  # the reference's Figure-D sites


def _trunc_from_params(params: Dict) -> dict:
    return {
        "chi_max": int(params.get("CHI_MAX", 256)),
        "svd_min": float(params.get("SVD_MIN", 1e-12)),
        "trunc_cut": float(params.get("SVD_CUTOFF", 1e-7)),
    }


def _run_figure_sim(params: Dict, h_frac: float, seed: int, n_sites: int,
                    n_periods: int, device, dtype):
    J = float(params.get("J", 1.0))
    kwargs = dict(n_sites=n_sites, J=J, h_disorder=h_frac * J, tau=2.0 / J,
                  disorder_seed=seed, device=device, dtype=dtype)
    return evolve_floquet_auto(kwargs, "neel", n_periods,
                               _trunc_from_params(params),
                               chi_limit=int(params.get("CHI_MAX", 256)))


def simulate_perfect_dtc(params: Dict, n_sites: int = 64, n_periods: int = 200,
                         device="cuda", dtype=torch.complex64):
    """Figure A: h/J=0.25, tau=2/J, L=64, 200 periods, seed 42.  Returns
    (times, staggered magnetization, magnetization) as lists."""
    print("  Simulating perfect DTC conditions...")
    traces, times, _, _ = _run_figure_sim(params, 0.25, 42, n_sites,
                                          n_periods, device, dtype)
    return (list(times), traces["staggered_magnetization"].tolist(),
            traces["magnetization"].tolist())


def simulate_disordered_dtc(params: Dict, n_sites: int = 64,
                            n_periods: int = 200, device="cuda",
                            dtype=torch.complex64):
    """Figure B: h/J=0.4, seed 123."""
    print("  Simulating disordered DTC conditions...")
    traces, times, _, _ = _run_figure_sim(params, 0.4, 123, n_sites,
                                          n_periods, device, dtype)
    return (list(times), traces["staggered_magnetization"].tolist(),
            traces["magnetization"].tolist())


def simulate_dephasing_dtc(params: Dict, n_sites: int = 64,
                           n_periods: int = 200, device="cuda",
                           dtype=torch.complex64):
    """Figure C: h/J=0.3, gamma=0.01 J: the closed-system traces times
    e^{-gamma t} (the reference's post-hoc decay, not a Lindblad solve)."""
    print("  Simulating DTC with dephasing...")
    gamma = 0.01 * float(params.get("J", 1.0))
    traces, times, _, _ = _run_figure_sim(params, 0.3, 42, n_sites,
                                          n_periods, device, dtype)
    decay = np.exp(-gamma * np.asarray(times))
    stag = traces["staggered_magnetization"] * decay
    total = traces["magnetization"] * decay
    return list(times), stag.tolist(), total.tolist()


def simulate_multi_site_dtc(params: Dict, synthetic_parity: bool = False,
                            n_periods: int = 200, device="cuda",
                            dtype=torch.complex64):
    """Figure D: L=16, <sigma_z_i(t)> of sites ``FIGURE_SITES``.
    ``synthetic_parity`` reproduces the reference's approximation (total
    +- 0.5 staggered + 0.1 N(0, 1) from numpy's global stream)."""
    print("  Simulating multi-site DTC analysis...")
    traces, times, _, _ = _run_figure_sim(params, 0.3, 42, 16, n_periods,
                                          device, dtype)
    if synthetic_parity:
        total = traces["magnetization"]
        stag = traces["staggered_magnetization"]
        site_mags = []
        for site in FIGURE_SITES:
            sign = 1.0 if site % 2 == 0 else -1.0
            noise = 0.1 * np.random.randn(len(total))
            site_mags.append((total + sign * 0.5 * stag + noise).tolist())
        return list(times), site_mags
    sz = traces["sz_sites"]                      # [n+1, L]
    return list(times), [sz[:, s].tolist() for s in FIGURE_SITES]


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

_THEMES = {
    # (stag, total, spec, drive, dtc) colors per figure
    "A": ("#440154", "#482777", "#6A0D83", "#7B68EE", "#9370DB"),
    "B": ("#1B5E20", "#2E7D32", "#388E3C", "#43A047", "#4CAF50"),
    "C": ("#0D47A1", "#1565C0", "#1976D2", "#1E88E5", "#2196F3"),
    "D": ("#004D40", "#00695C", "#00796B", "#00897B", "#009688"),
}
_SITE_COLORS = ["#E91E63", "#9C27B0", "#3F51B5", "#00BCD4", "#4CAF50", "#FF9800"]

FILES = {
    "A": "perfect_time_crystal",
    "B": "disordered_time_crystal",
    "C": "time_crystal_with_dephasing",
    "D": "multisite_time_crystal_dynamics",
}
_TITLES = {
    "A": r"Perfect DTC ($h/J = 0.25$)",
    "B": r"Disordered DTC ($h/J = 0.4$)",
    "C": r"DTC with Dephasing ($\gamma/J = 0.01$)",
    "D": r"Multi-Site Dynamics ($N = 16$)",
}


def _render_two_panel(key: str, times, series_top: List[Tuple],
                      spec_freqs, spec_power, out_dir: str,
                      spec_title: str = "Fourier Spectrum"):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _, _, spec_c, drive_c, dtc_c = _THEMES[key]
    fig, (ax_t, ax_s) = plt.subplots(2, 1, figsize=(4.5, 6))

    for label, data, color, style, lw in series_top:
        ax_t.plot(times, data, color=color, linestyle=style, linewidth=lw,
                  alpha=0.8, label=label)
    ax_t.set_xlabel(r"Time $t$ (Floquet periods)")
    ax_t.set_ylabel(r"Site magnetization $\langle\sigma_i^z\rangle$"
                    if key == "D" else r"Magnetization")
    ax_t.set_title(_TITLES[key], fontweight="bold")
    if key == "D":
        ax_t.legend(frameon=True, ncol=3, loc="lower right",
                    bbox_to_anchor=(0.98, 0.02), columnspacing=0.6,
                    handlelength=1.0, handletextpad=0.4, fancybox=True,
                    facecolor="white")
    else:
        ax_t.legend(frameon=False, loc="lower right", ncol=1)
    # the reference's axes, kept: absolute time cropped to [0, 100] under a
    # "Floquet periods" label, the spectrum on [0, 2] omega/omega_drive
    ax_t.set_xlim(0, 100)
    ax_t.set_ylim(-1.2, 1.2)

    ax_s.semilogy(spec_freqs, np.maximum(spec_power, 1e-12), color=spec_c,
                  linewidth=2, alpha=0.8)
    ax_s.axvline(x=0.5, color=dtc_c, linestyle="--", alpha=0.8, linewidth=2,
                 label=r"$\omega/2$")
    ax_s.axvline(x=1.0, color=drive_c, linestyle=":", alpha=0.8, linewidth=2,
                 label=r"$\omega$")
    ax_s.set_xlabel(r"Frequency $\omega/\omega_{\mathrm{drive}}$")
    ax_s.set_ylabel(r"Power (normalized)")
    ax_s.set_title(spec_title)
    ax_s.legend(frameon=False, loc="lower right", ncol=1)
    ax_s.set_xlim(0, 2.0)
    ax_s.set_ylim(1e-4, 1.2)

    fig.tight_layout(pad=1.5)
    os.makedirs(out_dir, exist_ok=True)
    for fmt in ("png", "pdf"):
        fig.savefig(os.path.join(out_dir, f"{FILES[key]}.{fmt}"), dpi=600,
                    bbox_inches="tight", facecolor="white", edgecolor="none")
    plt.close(fig)


def generate_individual_figures(params: Dict, out_dir: str = "figures",
                                synthetic_parity_d: bool = False,
                                device="cuda", dtype=torch.complex64) -> None:
    """Figures A-D with their spectra into ``out_dir`` (the reference's
    eight files)."""
    print("=" * 60)
    print("GENERATING INDIVIDUAL TIME CRYSTAL FIGURES")
    print("=" * 60)

    run = dict(device=device, dtype=dtype)
    sims = {
        "A": simulate_perfect_dtc(params, **run),
        "B": simulate_disordered_dtc(params, **run),
        "C": simulate_dephasing_dtc(params, **run),
    }
    times_d, site_mags = simulate_multi_site_dtc(params, synthetic_parity_d,
                                                 **run)

    J = float(params.get("J", 1.0))
    drive_period = 2 * (2.0 / J)  # the full Floquet period 4/J

    for key in ("A", "B", "C"):
        times, stag, total = sims[key]
        stag_c, total_c = _THEMES[key][0], _THEMES[key][1]
        print(f"  Generating Figure {key}...")
        freqs, power = calculate_fourier_spectrum(np.asarray(times),
                                                  np.asarray(stag),
                                                  drive_period)
        _render_two_panel(key, times,
                          [(r"$M_s(t)$", stag, stag_c, "-", 2),
                           (r"$M(t)$", total, total_c, "--", 2)],
                          freqs, power, out_dir)

    print("  Generating Figure D...")
    freqs_ref = None
    avg_power = None
    n_acc = 0
    for mags in site_mags:
        f, p = calculate_fourier_spectrum(np.asarray(times_d),
                                          np.asarray(mags), drive_period)
        if avg_power is None:
            freqs_ref, avg_power = f, p.copy()
            n_acc = 1
        elif len(p) == len(avg_power):
            avg_power += p
            n_acc += 1
    avg_power /= n_acc
    series = [(f"Site {s}", m, c, "-", 1.5)
              for s, m, c in zip(FIGURE_SITES, site_mags, _SITE_COLORS)]
    _render_two_panel("D", times_d, series, freqs_ref, avg_power, out_dir,
                      spec_title="Average Spectrum")

    print("\nIndividual figures saved:")
    for key in "ABCD":
        print(f"- {out_dir}/{FILES[key]}.png/.pdf")

"""Observables needed by the Floquet and TDVP traces and the DTC readout.

Port of the matching functions of ``timecrystal_tpu/core/observables.py``;
the subharmonic recipe is host numpy, exactly the JAX package's (and the
reference's) recipe.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gates as G
from .mps import MPS, expectation_one_site, overlap


def calculate_loschmidt_echo(psi_initial: MPS, psi_evolved: MPS) -> torch.Tensor:
    """L(t) = |<psi0|psi(t)>|^2, one real value per chain."""
    ov = overlap(psi_initial, psi_evolved)
    return ov.real * ov.real + ov.imag * ov.imag


def sz_sites(psi: MPS) -> torch.Tensor:
    """<sigma_z_i> for every site, [..., L] real."""
    return expectation_one_site(psi, G.pauli_c("z", psi.dtype, psi.device)).real


def add_derived_magnetization(traces: dict, L: int) -> dict:
    """In place: ``magnetization`` (unnormalized site sum) and
    ``staggered_magnetization`` ((1/L)-normalized alternating sum) from
    ``sz_sites [..., L]`` (host numpy)."""
    sz = np.asarray(traces["sz_sites"])
    signs = np.where(np.arange(L) % 2 == 0, 1.0, -1.0)
    traces["magnetization"] = sz.sum(axis=-1)
    traces["staggered_magnetization"] = (sz * signs).sum(axis=-1) / L
    return traces


def staggered_signs(L: int, dtype=torch.float32, device="cuda") -> torch.Tensor:
    return torch.as_tensor(np.where(np.arange(L) % 2 == 0, 1.0, -1.0),
                           dtype=dtype, device=device)


def _windowed_fft(series: np.ndarray, dt: float):
    """DC removal -> Hann window -> FFT -> positive-frequency half."""
    centered = series - np.mean(series)
    window = np.hanning(len(centered))
    fft_result = np.fft.fft(centered * window)
    freqs = np.fft.fftfreq(len(centered), d=dt)
    pos = freqs > 0
    return freqs[pos], fft_result[pos]


def extract_subharmonic_amplitude(times, magnetizations, period) -> float:
    """Normalized subharmonic amplitude A2T (|F(1/2T)| / max |F|)."""
    t = np.asarray(times, dtype=float)
    m = np.asarray(magnetizations, dtype=float)
    if len(t) < 10 or len(m) < 10:
        return 0.0
    valid = np.isfinite(m) & np.isfinite(t)
    if np.sum(valid) < 10:
        return 0.0
    t, m = t[valid], m[valid]
    dt = float(np.mean(np.diff(t)))
    if dt <= 0:
        return 0.0
    freqs_pos, fft_pos = _windowed_fft(m, dt)
    if len(freqs_pos) == 0:
        return 0.0
    subharmonic_freq = (1.0 / period) / 2.0
    sub_idx = int(np.argmin(np.abs(freqs_pos - subharmonic_freq)))
    amp = np.abs(fft_pos[sub_idx])
    max_amp = np.max(np.abs(fft_pos))
    return float(amp / max_amp) if max_amp > 1e-12 else 0.0

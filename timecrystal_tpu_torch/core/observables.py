"""Observables of padded MPS and the spectral recipes of the DTC readout.

Port of ``timecrystal_tpu/core/observables.py``.  The device observables
take an MPS with optional leading ensemble axes and return one value (or
one profile) per chain; the JAX package's ``lax.scan`` transfer sweeps are
Python loops over sites.  The spectral recipes (FFT post-processing of
observable traces) are host numpy, exactly the JAX package's (and the
reference's) recipes.

Conventions kept: Pauli (+-1) magnetizations, staggered magnetization
normalized by 1/L.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gates as G
from .mps import (MPS, entanglement_entropy,  # noqa: F401 (re-export)
                  entanglement_spectrum, expectation_one_site, overlap)


def calculate_loschmidt_echo(psi_initial: MPS, psi_evolved: MPS) -> torch.Tensor:
    """L(t) = |<psi0|psi(t)>|^2, one real value per chain."""
    ov = overlap(psi_initial, psi_evolved)
    return ov.real * ov.real + ov.imag * ov.imag


def sz_sites(psi: MPS) -> torch.Tensor:
    """<sigma_z_i> for every site, [..., L] real."""
    return expectation_one_site(psi, G.pauli_c("z", psi.dtype, psi.device)).real


def magnetization(psi: MPS, direction: str = "z", site: int | None = None):
    """Pauli magnetization along x/y/z: the sum over sites [...] (range
    [-L, L]), or one site's value when ``site`` is given."""
    vals = expectation_one_site(
        psi, G.pauli_c(direction, psi.dtype, psi.device)).real
    if site is not None:
        return vals[..., site]
    return vals.sum(-1)


def calculate_magnetization(psi: MPS, direction: str = "z"):
    """Alias of ``magnetization`` (the reference's name)."""
    return magnetization(psi, direction)


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


def staggered_magnetization(psi: MPS) -> torch.Tensor:
    """M_s = (1/L) sum_i (-1)^i <sigma_i^z>, [...]."""
    vals = sz_sites(psi)
    L = vals.shape[-1]
    return (staggered_signs(L, vals.dtype, vals.device) * vals).sum(-1) / L


def _zdiag(psi: MPS) -> torch.Tensor:
    return torch.tensor([1.0, -1.0], dtype=psi.dtype, device=psi.device)


def correlation_function(psi: MPS, op1: str, op2: str, i: int,
                         j: int) -> torch.Tensor:
    """<sigma_i^op1 sigma_j^op2>, complex [...]: the operators multiplied
    on one site, else the transfer matrix between i and j with the B-form
    environments (left diag(lam_i^2), right the identity).  For zz
    correlations from one site use ``zz_correlation_profile``."""
    o1 = G.pauli_c(op1, psi.dtype, psi.device)
    o2 = G.pauli_c(op2, psi.dtype, psi.device)
    if i == j:
        return expectation_one_site(psi, o1 @ o2)[..., i]
    if i > j:
        i, j, o1, o2 = j, i, o2, o1
    w = (psi.lam[..., i, :] ** 2).to(psi.dtype)
    Bi = psi.B[..., i, :, :, :]
    T = torch.einsum("pq,...aqc->...apc", o1, Bi)
    E = torch.einsum("...apb,...apc->...bc", Bi.conj(), T * w[..., :, None, None])
    for k in range(i + 1, j):
        Bk = psi.B[..., k, :, :, :]
        T = torch.einsum("...ab,...bpc->...apc", E, Bk)
        E = torch.einsum("...apb,...apc->...bc", Bk.conj(), T)
    Bj = psi.B[..., j, :, :, :]
    T = torch.einsum("pq,...bqc->...bpc", o2, Bj)
    T = torch.einsum("...ab,...bpc->...apc", E, T)
    return torch.einsum("...apc,...apc->...", Bj.conj(), T)


def zz_correlation_profile(psi: MPS, i: int) -> torch.Tensor:
    """<sigma^z_i sigma^z_j> for every j, [..., L] real, by one forward and
    one backward transfer sweep from site i (z diagonal, the MPS
    right-canonical).  Entry j == i is exactly 1."""
    L = psi.L
    z = _zdiag(psi)
    w = (psi.lam ** 2).to(psi.dtype)                       # [..., L+1, chi]
    Bi = psi.B[..., i, :, :, :]
    Tz = Bi * z[:, None]
    # sites <= i with z at i, the left environment diag(lam_i^2)
    E = torch.einsum("...apb,...apc->...bc", Bi.conj(),
                     Tz * w[..., i, :, None, None])
    fwd = []
    for j in range(i + 1, L):
        Bj = psi.B[..., j, :, :, :]
        # read out before absorbing: right canonicity collapses sites > j
        T = torch.einsum("...bc,...cpa->...bpa", E, Bj * z[:, None])
        fwd.append(torch.einsum("...bpa,...bpa->...", Bj.conj(), T).real)
        T = torch.einsum("...ab,...bpc->...apc", E, Bj)
        E = torch.einsum("...apb,...apc->...bc", Bj.conj(), T)
    # sites >= i with z at i, collapsed from the right
    F = torch.einsum("...apc,...bpc->...ab", Tz, Bi.conj())
    bwd = []
    for j in range(i - 1, -1, -1):
        Bj = psi.B[..., j, :, :, :]
        T = torch.einsum("...apc,...cd->...apd",
                         Bj * z[:, None] * w[..., j, :, None, None], F)
        bwd.append(torch.einsum("...apd,...apd->...", T, Bj.conj()).real)
        T = torch.einsum("...apc,...cd->...apd", Bj, F)
        F = torch.einsum("...apd,...bpd->...ab", T, Bj.conj())
    one = psi.lam.new_ones(psi.lead)
    return torch.stack(bwd[::-1] + [one] + fwd, -1)


def cross_sz_profile(phi: MPS, psi: MPS) -> torch.Tensor:
    """<phi| sigma^z_j |psi> for every j, complex [..., L]: with
    phi(t) = U^t sigma^z_i |psi0> and psi(t) = U^t |psi0> this is the
    two-time correlator <sz_i(0) sz_j(t)>.  Left and right transfer
    environments, then one readout per site (boundaries as in
    ``core.mps.overlap``)."""
    lead = torch.broadcast_shapes(phi.lead, psi.lead)
    L = psi.L
    z = _zdiag(psi)
    e00 = psi.B.new_zeros(lead + (phi.chi, psi.chi))
    e00[..., 0, 0] = 1.0
    lefts, E = [], e00
    for j in range(L):                    # lefts[j]: sites < j
        lefts.append(E)
        T = torch.einsum("...ab,...bpc->...apc", E, psi.B[..., j, :, :, :])
        E = torch.einsum("...apb,...apc->...bc", phi.B[..., j, :, :, :].conj(), T)
    rights, R = [None] * L, e00
    for j in range(L - 1, -1, -1):        # rights[j]: sites > j
        rights[j] = R
        T = torch.einsum("...apb,...cb->...apc", psi.B[..., j, :, :, :], R)
        R = torch.einsum("...apc,...bpc->...ab", phi.B[..., j, :, :, :].conj(), T)
    Ls, Rs = torch.stack(lefts, -3), torch.stack(rights, -3)
    T1 = torch.einsum("...jab,...jbpc->...japc", Ls, psi.B * z[:, None])
    T2 = torch.einsum("...japc,...jbc->...japb", T1, Rs)
    return torch.einsum("...japb,...japb->...j", phi.B.conj(), T2)


def _bond_thetas(psi: MPS) -> torch.Tensor:
    """theta_b = B_b B_{b+1} of every bond, [..., L-1, chi, d, d, chi]."""
    return torch.einsum("...napb,...nbqc->...napqc", psi.B[..., :-1, :, :, :],
                        psi.B[..., 1:, :, :, :])


def bond_energies(psi: MPS, bond_H: torch.Tensor) -> torch.Tensor:
    """Per-bond energies <theta_b|H_b|theta_b> / <theta_b|theta_b>,
    [..., L-1], with the left environment diag(lam_b^2) and the right one
    the identity (canonical form).  ``bond_H`` complex [L-1, d, d, d, d]
    with the gate index convention [p_out, q_out, p_in, q_in]."""
    lam = psi.lam[..., :psi.L - 1, :].to(psi.dtype)
    theta = _bond_thetas(psi) * lam[..., :, :, None, None, None]
    Ht = torch.einsum("...npqrs,...narsc->...napqc", bond_H.to(psi.dtype), theta)
    num = torch.einsum("...napqc,...napqc->...n", theta.conj(), Ht).real
    den = torch.einsum("...napqc,...napqc->...n", theta.conj(), theta).real
    return num / torch.clamp(den, min=1e-30)


def total_energy(psi: MPS, bond_H: torch.Tensor) -> torch.Tensor:
    """<H> of a nearest-neighbour chain Hamiltonian (sum of
    ``bond_energies``), [...]."""
    return bond_energies(psi, bond_H).sum(-1)


def bond_energies_exact(psi: MPS, bond_H: torch.Tensor) -> torch.Tensor:
    """Per-bond energies with exact left and right transfer environments,
    [..., L-1]: the Rayleigh quotient <psi|H_b|psi> / <psi|psi> whatever
    the canonical form (imaginary-time sweeps degrade it)."""
    L = psi.L
    e00 = psi.B.new_zeros(psi.lead + (psi.chi, psi.chi))
    e00[..., 0, 0] = 1.0
    lenvs, E = [], e00
    for j in range(L):                    # lenvs[j]: left of site j
        lenvs.append(E)
        B = psi.B[..., j, :, :, :]
        E = torch.einsum("...apb,...apc->...bc", B.conj(),
                         torch.einsum("...ab,...bpc->...apc", E, B))
    renvs, F = [None] * L, e00
    for j in range(L - 1, -1, -1):        # renvs[j]: right of site j
        renvs[j] = F
        B = psi.B[..., j, :, :, :]
        F = torch.einsum("...apc,...dpc->...ad",
                         torch.einsum("...apb,...bc->...apc", B.conj(), F), B)
    lenv = torch.stack(lenvs[:-1], -3)    # left of site b
    renv = torch.stack(renvs[1:], -3)     # right of site b+1
    theta = _bond_thetas(psi)
    Ht = torch.einsum("...npqrs,...narsc->...napqc", bond_H.to(psi.dtype), theta)

    def sandwich(mid):
        T1 = torch.einsum("...naA,...nApqC->...napqC", lenv, mid)
        T2 = torch.einsum("...napqC,...ncC->...napqc", T1, renv)
        return torch.einsum("...napqc,...napqc->...n", theta.conj(), T2).real

    return sandwich(Ht) / torch.clamp(sandwich(theta), min=1e-30)


def order_parameter(psi: MPS, sublattice_a, sublattice_b) -> torch.Tensor:
    """|<S_A> - <S_B>| over the sublattices' mean z-magnetizations, [...]."""
    vals = sz_sites(psi)
    a = vals[..., list(sublattice_a)].mean(-1)
    b = vals[..., list(sublattice_b)].mean(-1)
    return (a - b).abs()


def participation_ratio(psi: MPS) -> torch.Tensor:
    """(sum_i n_i)^2 / sum_i n_i^2 over the local densities n_i = p_up +
    p_down (identically 1 for a normalized state: the reference's
    semantics), [...]."""
    up = torch.tensor([[1, 0], [0, 0]], dtype=psi.dtype, device=psi.device)
    dn = torch.tensor([[0, 0], [0, 1]], dtype=psi.dtype, device=psi.device)
    dens = expectation_one_site(psi, up).real + expectation_one_site(psi, dn).real
    num = dens.sum(-1) ** 2
    den = (dens ** 2).sum(-1)
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                       torch.zeros_like(den))


# ---------------------------------------------------------------------------
# Spectral recipes (host numpy)
# ---------------------------------------------------------------------------

def fidelity_decay(loschmidt_echoes, times) -> float:
    """Coherence time T2 from a linear fit of log L(t)."""
    le = np.asarray(loschmidt_echoes, dtype=float)
    t = np.asarray(times, dtype=float)
    logf = np.log(np.maximum(le, 1e-10))
    coeffs = np.polyfit(t, logf, 1)
    decay_rate = -coeffs[0]
    return float(1.0 / decay_rate) if decay_rate > 0 else np.inf


def subharmonic_response(magnetization_data, drive_period):
    """(fundamental amplitude, subharmonic amplitude) from a raw FFT (no
    window, raw bins, unit-spacing fftfreq: the reference's semantics)."""
    m = np.asarray(magnetization_data, dtype=float)
    fft_data = np.fft.fft(m)
    freqs = np.fft.fftfreq(len(m))
    fundamental_freq = 1.0 / drive_period
    subharmonic_freq = fundamental_freq / 2.0
    fund_idx = int(np.argmin(np.abs(freqs - fundamental_freq)))
    sub_idx = int(np.argmin(np.abs(freqs - subharmonic_freq)))
    return abs(fft_data[fund_idx]), abs(fft_data[sub_idx])


def _windowed_fft(series: np.ndarray, dt: float):
    """DC removal -> Hann window -> FFT -> positive-frequency half."""
    centered = series - np.mean(series)
    window = np.hanning(len(centered))
    fft_result = np.fft.fft(centered * window)
    freqs = np.fft.fftfreq(len(centered), d=dt)
    pos = freqs > 0
    return freqs[pos], fft_result[pos]


def _valid_series(times, series):
    """(t, x, dt) of the finite samples, or None when fewer than 10 remain
    or the mean step is not positive (the recipes' guards)."""
    t = np.asarray(times, dtype=float)
    m = np.asarray(series, dtype=float)
    if len(t) < 10 or len(m) < 10:
        return None
    valid = np.isfinite(m) & np.isfinite(t)
    if np.sum(valid) < 10:
        return None
    t, m = t[valid], m[valid]
    dt = float(np.mean(np.diff(t)))
    if dt <= 0:
        return None
    return t, m, dt


def extract_subharmonic_amplitude(times, magnetizations, period) -> float:
    """Normalized subharmonic amplitude A2T (|F(1/2T)| / max |F|)."""
    valid = _valid_series(times, magnetizations)
    if valid is None:
        return 0.0
    _, m, dt = valid
    freqs_pos, fft_pos = _windowed_fft(m, dt)
    if len(freqs_pos) == 0:
        return 0.0
    subharmonic_freq = (1.0 / period) / 2.0
    sub_idx = int(np.argmin(np.abs(freqs_pos - subharmonic_freq)))
    amp = np.abs(fft_pos[sub_idx])
    max_amp = np.max(np.abs(fft_pos))
    return float(amp / max_amp) if max_amp > 1e-12 else 0.0


def subharmonic_weight_fraction(times, magnetizations, period) -> float:
    """The omega/2 Hann main lobe's share (bins sub-1 .. sub+1) of the total
    spectral power: the companion of A2T that does not saturate at 1 where
    the omega/2 bin dominates.  Same recipe and guards as A2T."""
    valid = _valid_series(times, magnetizations)
    if valid is None:
        return 0.0
    _, m, dt = valid
    freqs_pos, fft_pos = _windowed_fft(m, dt)
    if len(freqs_pos) == 0:
        return 0.0
    power = np.abs(fft_pos) ** 2
    total = float(np.sum(power))
    if total <= 1e-24:
        return 0.0
    sub_idx = int(np.argmin(np.abs(freqs_pos - (1.0 / period) / 2.0)))
    lo, hi = max(sub_idx - 1, 0), min(sub_idx + 2, len(power))
    return float(np.sum(power[lo:hi]) / total)


def extract_subharmonic_amplitude_from_loschmidt(times, loschmidt_echoes,
                                                 period) -> float:
    """A2T of the Loschmidt echo series."""
    return extract_subharmonic_amplitude(times, loschmidt_echoes, period)


def detect_period_doubling_from_loschmidt(loschmidt_echoes,
                                          tolerance: float = 0.1) -> float:
    """Strength of the even/odd alternation of an LE series in [0, 1]."""
    le = np.asarray(loschmidt_echoes, dtype=float)
    if len(le) < 4:
        return 0.0
    even, odd = le[0::2], le[1::2]
    if len(even) < 2 or len(odd) < 2:
        return 0.0
    even_std, odd_std = np.std(even), np.std(odd)
    even_mean, odd_mean = np.mean(even), np.mean(odd)
    separation = abs(even_mean - odd_mean)
    max_sep = max(even_mean, odd_mean)
    if max_sep <= 0:
        return 0.0
    strength = separation / max_sep
    consistency_penalty = min(even_std, odd_std) / (separation + 1e-10)
    strength *= np.exp(-consistency_penalty)
    return float(min(strength, 1.0))


def calculate_fourier_spectrum(times, data, drive_period):
    """(freqs / f_drive, power / max power) over the positive frequencies
    of the windowed FFT of a trace (the figures' spectra)."""
    t = np.asarray(times, dtype=float)
    x = np.asarray(data, dtype=float)
    dt = float(np.mean(np.diff(t)))
    freqs_pos, fft_pos = _windowed_fft(x, dt)
    power = np.abs(fft_pos) ** 2
    drive_freq = 1.0 / drive_period
    pmax = np.max(power) if len(power) else 0.0
    return freqs_pos / drive_freq, (power / pmax if pmax > 0 else power)


def dynamic_structure_factor(times, c_rt, device="cuda"):
    """S(k, omega) of a real correlator map ``c_rt`` [..., n_t, L] sampled
    at the uniform ``times`` [n_t]: (freqs [n_pos], ks [L], S [..., n_pos,
    L]) with n_pos = (n_t - 1) // 2, freqs as ``extract_subharmonic_amplitude``
    bins them, ks = 2 pi m / L, and S the Hann-windowed, DC-removed space-time
    power (``ops.fft.spacetime_power``) computed on ``device``."""
    from ..ops.fft import spacetime_power

    times = np.asarray(times)
    c_rt = torch.as_tensor(c_rt, device=device)
    n_t, L = c_rt.shape[-2], c_rt.shape[-1]
    if len(times) != n_t:
        raise ValueError(f"times has {len(times)} entries for {n_t} rows")
    dt = float(np.mean(np.diff(times)))
    n_pos = (n_t - 1) // 2
    freqs = np.arange(1, n_pos + 1) / (n_t * dt)
    ks = 2.0 * np.pi * np.arange(L) / L
    return freqs, ks, spacetime_power(c_rt)

"""Spectra of observable traces on the device.

Port of ``timecrystal_tpu/ops/fft.py``: ``power_spectrum``,
``batched_subharmonic_amplitude`` and ``spacetime_power``.  The JAX package
evaluates its DFTs as dense matmuls (``rdft``) because the TPU has no FFT;
here they are ``torch.fft``.  The A2T recipe is the host one of
``core.observables.extract_subharmonic_amplitude`` (DC removal -> Hann
window -> FFT -> positive bins -> |F(1/2T)| / max |F|), bin for bin.
"""

from __future__ import annotations

import numpy as np
import torch


def power_spectrum(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """|DFT(x)|^2 of a real signal along ``axis`` (full spectrum, numpy's
    bin order)."""
    return torch.fft.fft(torch.as_tensor(x), dim=axis).abs() ** 2


def batched_subharmonic_amplitude(times: torch.Tensor, series: torch.Tensor,
                                  drive_period) -> torch.Tensor:
    """A2T of every trace of ``series`` [..., n] (real), sampled at
    ``times`` [n] or [..., n] (a uniform grid: dt is the mean step, as in
    the host recipe), for the drive period(s) ``drive_period`` (a float or
    [...]).  Returns [...] on the series' device.

    Traces shorter than 10 samples score 0.0, as in the host recipe.  A
    trace with a non-finite sample, or a time grid whose dt is not finite
    and positive, gives NaN: the host recipe drops invalid samples, which a
    fixed-shape batch cannot; callers that need its answer recompute those
    traces on the host (``parallel.sweep.ensemble_a2t``)."""
    series = torch.as_tensor(series)
    times = torch.as_tensor(times, dtype=series.dtype, device=series.device)
    lead, n = series.shape[:-1], series.shape[-1]
    if n < 10:
        return series.new_zeros(lead)
    dt = torch.diff(times, dim=-1).mean(-1)
    dt = torch.broadcast_to(dt, lead)
    period = torch.broadcast_to(torch.as_tensor(drive_period, dtype=series.dtype,
                                                device=series.device), lead)
    window = torch.as_tensor(np.hanning(n), dtype=series.dtype,
                             device=series.device)
    centered = series - series.mean(-1, keepdim=True)
    # the positive frequencies of np.fft.fftfreq(n): bins 1..(n-1)//2
    n_pos = (n - 1) // 2
    amp_pos = torch.fft.rfft(centered * window, dim=-1)[..., 1:n_pos + 1].abs()
    idx = torch.arange(1, n_pos + 1, dtype=series.dtype, device=series.device)
    freqs_pos = idx / (n * dt[..., None])
    sub_idx = (freqs_pos - (0.5 / period)[..., None]).abs().argmin(-1)
    amp = torch.gather(amp_pos, -1, sub_idx[..., None])[..., 0]
    max_amp = amp_pos.amax(-1)
    out = torch.where(max_amp > 1e-12, amp / torch.clamp(max_amp, min=1e-12),
                      torch.zeros_like(amp))
    finite = (torch.isfinite(series).all(-1) & torch.isfinite(dt) & (dt > 0))
    return torch.where(finite, out, torch.full_like(out, float("nan")))


def spacetime_power(c_rt: torch.Tensor, window_time: bool = True,
                    remove_dc: bool = True) -> torch.Tensor:
    """|DFT_{t -> omega, r -> k} C|^2 of a real space-time map ``c_rt``
    [..., n_t, L] (e.g. the ``zz_corr`` trace of a ``correlation_site``
    run), optionally DC-removed (the per-r time mean) and Hann-windowed
    along time.  Returns [..., n_pos, L], n_pos = (n_t - 1) // 2: the
    positive time bins 1..n_pos (the real input's spectrum is conjugate
    symmetric) and all L momenta (bin m is k = 2 pi m / L)."""
    x = torch.as_tensor(c_rt)
    n_t = x.shape[-2]
    if remove_dc:
        x = x - x.mean(-2, keepdim=True)
    if window_time:
        x = x * torch.as_tensor(np.hanning(n_t), dtype=x.dtype,
                                device=x.device)[:, None]
    n_pos = (n_t - 1) // 2
    return torch.fft.fft2(x)[..., 1:n_pos + 1, :].abs() ** 2

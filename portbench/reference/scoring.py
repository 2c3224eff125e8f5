"""The drive diagram's scoring recipe, frozen: the subharmonic amplitude
A2T and the subharmonic weight fraction of a staggered-magnetization trace.

Written from the source project's recipe and importing nothing of the
program under test.  A trace of the period-doubled response x(t_k),
t_k = k dt, is scored so:

  * fewer than 10 finite samples, or a mean step that is not positive:
    both scores are 0 (the recipe's guards); otherwise the finite
    samples alone are used;
  * x minus its mean, times a Hann window, through the FFT; the bins of
    positive frequency are kept;
  * the subharmonic bin is the one nearest 1 / (2 T), T the drive period;
  * A2T = |F(sub)| / max |F|, or 0 when max |F| <= 1e-12;
  * weight = sum of |F|^2 over the bins sub-1 .. sub+1 (clipped to the
    kept bins) / sum of |F|^2 over every kept bin, or 0 when that total is
    <= 1e-24.

A point's verdict is ``success``: every sample of its trace is finite;
a point without it scores 0 and 0.
``dtype`` float64 is the reference; float32 is the control's precision.
"""

from __future__ import annotations

import numpy as np
import torch


def _spectrum(times, series, dtype):
    t = np.asarray(times, float)
    x = np.asarray(series, float)
    if len(t) < 10 or len(x) < 10:
        return None
    ok = np.isfinite(x) & np.isfinite(t)
    if ok.sum() < 10:
        return None
    t, x = t[ok], x[ok]
    dt = float(np.mean(np.diff(t)))
    if dt <= 0:
        return None
    n = len(x)
    v = torch.from_numpy(x).to(dtype)
    v = v - v.mean()
    k = torch.arange(n, dtype=torch.float64)
    hann = (0.5 - 0.5 * torch.cos(2.0 * np.pi * k / (n - 1))).to(dtype)
    F = torch.fft.fft(v * hann)
    freqs = np.fft.fftfreq(n, d=dt)
    pos = freqs > 0
    return freqs[pos], F[torch.from_numpy(pos)]


def scores(times, series, period: float, dtype=torch.float64) -> tuple:
    """(A2T, weight) of one trace."""
    spec = _spectrum(times, series, dtype)
    if spec is None or len(spec[0]) == 0:
        return 0.0, 0.0
    freqs, F = spec
    sub = int(np.argmin(np.abs(freqs - 0.5 / period)))
    amp = F.abs()
    top = float(amp.max())
    a2t = float(amp[sub] / amp.max()) if top > 1e-12 else 0.0
    power = amp * amp
    total = float(power.sum())
    lo, hi = max(sub - 1, 0), min(sub + 2, len(power))
    weight = float(power[lo:hi].sum() / power.sum()) if total > 1e-24 else 0.0
    return a2t, weight


def score_points(times, stag, period: float, dtype=torch.float64) -> dict:
    """A2T, weight and success [P] of the traces stag [P, T]."""
    stag = np.asarray(stag, float)
    ok = np.all(np.isfinite(stag), axis=-1)
    out = np.array([scores(times, s, period, dtype) if good else (0.0, 0.0)
                    for s, good in zip(stag, ok)]).reshape(-1, 2)
    return {"A2T": out[:, 0], "weight": out[:, 1], "success": ok}

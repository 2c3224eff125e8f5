"""DTC detection: the stringent 4-criterion scorer and physics penalties.

A copy of ``timecrystal_tpu/analysis/detection.py`` (pure NumPy, kept here
so the port never imports the JAX package): the reference's detector and
phase-point penalty pipeline, on the host, over the observable traces of
the device sweeps (``parallel/sweep.py``).  The series are O(n_periods)
scalars per grid point.

Criteria (weights [0.3, 0.4, 0.2, 0.1], geometric mean, threshold 0.3):
  1. autocorrelation of the LE series at lag 2T,
  2. spectral score: min(subharmonic/fundamental power ratio,
     5 * spectral purity) on the windowed FFT of the late-time 3/4,
  3. temporal stability: first-half vs second-half correlation,
  4. coherence: mean of the last 5 LE values.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _safe_corrcoef(a: np.ndarray, b: np.ndarray) -> float:
    sa, sb = np.std(a), np.std(b)
    if sa == 0.0 or sb == 0.0 or len(a) != len(b) or len(a) < 2:
        return np.nan
    return float(np.corrcoef(a, b)[0, 1])


def stringent_dtc_detection(loschmidt_echoes, times, period: float,
                            threshold: float = 0.3) -> float:
    """DTC order parameter in [0, 1] from an LE time series.

    Reference main.py:134-273; all four criteria and the gating logic are
    reproduced, including the early-return-zero paths.
    """
    le = np.asarray(loschmidt_echoes, dtype=float)
    t = np.asarray(times, dtype=float)
    if len(le) < 20:
        return 0.0

    # -- criterion 1: period doubling via autocorrelation at lag 2T
    dt = t[1] - t[0]
    if dt <= 0:
        return 0.0
    lag = int(2 * period / dt)
    if lag <= 0 or lag >= len(le) // 2:
        return 0.0
    ac = _safe_corrcoef(le[:-lag], le[lag:])
    if not np.isfinite(ac) or ac < threshold:
        return 0.0
    period_doubling_score = max(0.0, ac)

    # -- criterion 2: spectral subharmonic dominance on late-time data.
    # Reference-parity note (bins included): with the stroboscopic
    # once-per-drive-period sampling the phase sweep produces
    # (dt == period), 1/(2*period) and 1/period BOTH land on the top
    # positive bin, so ratio == 1 identically and this criterion reduces
    # to min(1, 5*purity) -- exactly as in the reference
    # (main.py:182-231, same sampling); kept bit-faithful.
    spectral_score = 0.0
    late = le[len(le) // 4:]
    if len(late) >= 10:
        centered = (late - np.mean(late)) * np.hanning(len(late))
        spec = np.abs(np.fft.fft(centered))
        freqs = np.fft.fftfreq(len(centered), d=dt)
        pos = freqs > 0
        fpos, apos = freqs[pos], spec[pos]
        if len(fpos) > 0:
            sub_idx = int(np.argmin(np.abs(fpos - 1.0 / (2 * period))))
            fund_idx = int(np.argmin(np.abs(fpos - 1.0 / period)))
            sub_p, fund_p = apos[sub_idx] ** 2, apos[fund_idx] ** 2
            total_p = float(np.sum(apos**2))
            ratio = sub_p / fund_p if fund_p > 0 else 0.0
            purity = sub_p / total_p if total_p > 0 else 0.0
            spectral_score = min(ratio, purity * 5.0)

    # -- criterion 3: temporal stability (halves correlate)
    mid = len(le) // 2
    stab = _safe_corrcoef(le[:mid], le[mid:2 * mid])
    stability_score = max(0.0, stab) if np.isfinite(stab) else 0.0

    # -- criterion 4: coherence (LE must not have decayed away)
    coherence_score = float(np.mean(le[-5:]))

    weights = (0.3, 0.4, 0.2, 0.1)
    scores = (period_doubling_score, spectral_score, stability_score,
              coherence_score)
    clipped = [max(s, 1e-6) for s in scores]
    dtc_score = float(np.exp(sum(w * np.log(s) for w, s in zip(weights, clipped))))
    if dtc_score < threshold:
        return 0.0
    return min(1.0, dtc_score)


def physics_penalties(h_over_J: float, T_J: float, avg_bond_dim: float) -> Dict[str, float]:
    """The four physical-reality penalties (reference main.py:359-386):
    disorder beyond the MBL transition, heating (fast drive), adiabatic
    (slow drive), and missing entanglement growth."""
    disorder = float(np.exp(-3 * (h_over_J - 0.6))) if h_over_J > 0.6 else 1.0
    heating = float(T_J) if T_J < 1.0 else 1.0
    adiabatic = float(np.exp(-0.5 * (T_J - 3.5))) if T_J > 3.5 else 1.0
    entanglement = avg_bond_dim / 2.0 if avg_bond_dim < 2.0 else 1.0
    return {
        "disorder_penalty": disorder,
        "heating_penalty": heating,
        "adiabatic_penalty": adiabatic,
        "entanglement_penalty": entanglement,
    }


def score_phase_point(loschmidt_echoes, times, bond_dims, h_over_J: float,
                      T_J: float, drive_period: float) -> Dict[str, float]:
    """Full per-point result record (reference main.py:275-415 contract)."""
    try:
        dtc = stringent_dtc_detection(loschmidt_echoes, times, drive_period)
        avg_chi = float(np.mean(bond_dims))
        pen = physics_penalties(h_over_J, T_J, avg_chi)
        total = (pen["disorder_penalty"] * pen["heating_penalty"]
                 * pen["adiabatic_penalty"] * pen["entanglement_penalty"])
        return {
            "A2T": dtc * total,
            "dtc_score_raw": dtc,
            **pen,
            "avg_bond_dim": avg_chi,
            "final_le": float(np.asarray(loschmidt_echoes)[-1]),
            "success": True,
        }
    except Exception as exc:  # failure masking per point (main.py:403-415)
        print(f"Error at h/J={h_over_J:.3f}, T*J={T_J:.3f}: {exc}")
        return _failure_record()


def _failure_record() -> Dict[str, float]:
    """The sanitized failed-point record: same keys as a successful
    score_phase_point result, all-zero scores, no NaN leaks into fields
    downstream consumers may aggregate (final_le etc.)."""
    return {
        "A2T": 0.0, "dtc_score_raw": 0.0, "disorder_penalty": 0.0,
        "heating_penalty": 0.0, "adiabatic_penalty": 0.0,
        "entanglement_penalty": 0.0, "avg_bond_dim": 1.0,
        "final_le": 0.0, "success": False,
    }


def score_grid(traces: Dict[str, np.ndarray], times, hs, Ts,
               drive_periods, show_progress: bool = False) -> List[Dict[str, float]]:
    """Score every point of a batched sweep (traces leading axis = grid).

    NaN/overflow guards: any non-finite trace marks the point failed without
    killing the sweep (SURVEY.md section 5 'failure detection').

    show_progress=True renders the reference's per-point tqdm bar with a
    live (h/J, T*J, A2T, chi_avg) postfix (reference main.py:466-481); the
    evolution itself is one batched device call here, so the bar tracks the
    host-side scoring pass.
    """
    out = []
    le_all = np.asarray(traces["loschmidt_echo"])
    chi_all = np.asarray(traces["max_chi"])
    indices = range(le_all.shape[0])
    bar = None
    if show_progress:
        try:
            from tqdm import tqdm
            bar = tqdm(total=le_all.shape[0], desc="Phase diagram",
                       unit="point")
        except ImportError:
            bar = None
    for g in indices:
        le = le_all[g]
        if not np.all(np.isfinite(le)):
            out.append(_failure_record())
        else:
            t = times[g] if np.ndim(times) > 1 else times
            out.append(score_phase_point(le, t, chi_all[g], float(hs[g]),
                                         float(Ts[g]), float(drive_periods[g])))
        if bar is not None:
            rec = out[-1]
            bar.set_postfix({"h/J": f"{float(hs[g]):.2f}",
                             "T*J": f"{float(Ts[g]):.2f}",
                             "A2T": f"{rec.get('A2T', 0.0):.3f}",
                             "chi": f"{float(np.mean(chi_all[g])):.1f}"})
            bar.update(1)
    if bar is not None:
        bar.close()
    return out

"""DTC-as-quantum-memory lifetime analysis.

Port of ``timecrystal_tpu/analysis/memory.py``.  The (gamma or eps x
disorder realization x trajectory) ensemble of stochastic dephasing
channels (``dynamics.open_system._evolve_stochastic_scan``) is one leading
axis of rows, each row with its own fields, kick angle, dephasing rate and
noise, evaluated as one batch or in chunks of rows.  Extracted:

  * ``tau_bit``: the lifetime of the classical Ising bit stored in the
    period-doubled response (log-linear fit of the sign-corrected
    stroboscopic staggered-magnetization envelope);
  * ``T2``: the coherence time of an undriven |+x> product state under the
    same channel, whose average is E[<sx>](t) = e^{-2 gamma t}: the fitted
    T2 must come out 1/(2 gamma), the calibration anchor.

At an exact pi pulse the Floquet map takes z-basis states to z-basis
states and the dephasing never reaches the stored bit; a pulse error
eps = 1 - theta/pi opens that path, and tau_bit(gamma, eps) is the memory
figure of merit.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

__all__ = ["memory_envelope", "fit_memory_lifetime", "scan_memory_lifetime",
           "scan_memory_vs_eps", "generate_memory_figure"]


def memory_envelope(staggered: np.ndarray, normalize: bool = True
                    ) -> np.ndarray:
    """Sign-corrected stroboscopic envelope of the period-doubled response.

    ``staggered``: [..., n] staggered-magnetization trace recorded after
    each Floquet period p = 1..n (no t=0 row).  The subharmonic alternates
    sign each period, so env[p-1] = (-1)^p * staggered[p-1]; ``normalize``
    divides by the first period's magnitude so a perfect DTC sits at
    env == 1.
    """
    s = np.asarray(staggered, float)
    n = s.shape[-1]
    signs = np.where((np.arange(1, n + 1) % 2) == 0, 1.0, -1.0)
    env = s * signs
    if normalize:
        ref = np.abs(env[..., :1])
        env = env / np.where(ref > 1e-12, ref, 1.0)
    return env


def fit_memory_lifetime(times, envelope, floor: float = 0.05,
                        min_points: int = 4) -> float:
    """Lifetime tau from a log-linear fit of a decaying envelope.

    Fits log(env) = a - t/tau over the contiguous prefix of samples before
    the first crossing below ``floor`` (past it the ensemble mean is noise,
    and keeping its positive excursions would flatten the slope).  Returns
    np.inf when the envelope does not decay (slope >= 0), the first
    crossing time when it decays within ``min_points`` samples, and np.nan
    when no sample is finite.
    """
    t = np.asarray(times, float)
    env = np.asarray(envelope, float)
    if not np.any(np.isfinite(env)):
        return float("nan")
    good = np.isfinite(env) & (env > floor)
    n_head = int(np.argmax(~good)) if np.any(~good) else env.size
    if n_head < int(min_points):
        return float(t[max(n_head - 1, 0)]) if n_head > 0 else 0.0
    slope, _ = np.polyfit(t[:n_head], np.log(env[:n_head]), 1)
    if slope >= -1e-12:
        return float("inf")
    return float(-1.0 / slope)


def _make_checkpointer(checkpoint_dir, fingerprint_src):
    """SweepCheckpointer (or None) of a chunked memory scan, fingerprinted
    by ``fingerprint_src`` (axes, model parameters, chunking).  Refused in
    a multi-process run: the ranks would race the same chunk and manifest
    files."""
    if checkpoint_dir is None:
        return None
    from ..parallel.multihost import process_count
    from ..utils.checkpoint import SweepCheckpointer, fingerprint

    if process_count() > 1:
        raise ValueError(
            "checkpoint_dir is not supported in a multi-process run: "
            "every process would race the same chunk/manifest files.  Run "
            "without checkpointing, or checkpoint per-slice single-process "
            "sweeps.")
    return SweepCheckpointer(checkpoint_dir,
                             fingerprint=fingerprint(*fingerprint_src))


def _x_plus_state(L: int, chi: int, dtype=torch.complex64, device="cuda"):
    """|+x>^L as a padded product MPS."""
    from ..core.mps import MPS

    B = torch.zeros((L, chi, 2, chi), dtype=dtype, device=device)
    B[:, 0, :, 0] = float(1.0 / np.sqrt(2.0))
    lam = torch.zeros((L + 1, chi), dtype=dtype.to_real(), device=device)
    lam[:, 0] = 1.0
    return MPS(B=B, lam=lam)


def memory_noise(n_rows: int, n_periods: int, L: int, seed: int) -> np.ndarray:
    """The unit normals [n_rows, n_periods, L] of a scan's rows, float64,
    from a numpy generator seeded with ``seed``
    (``open_system.dephasing_noise``): row i's noise depends on the seed and
    i only, so any subset of rows can be evaluated again."""
    from ..dynamics.open_system import dephasing_noise

    return dephasing_noise((n_rows, n_periods, L), seed=seed).numpy()


def disorder_rows(L: int, h_over_J: float, J: float, disorder_seed: int,
                  n_realizations: int, n_trajectories: int,
                  n_groups: int) -> np.ndarray:
    """The fields [n_groups * R * T, L] of a scan's rows: realization r is
    the reference's MT19937 draw at seed ``disorder_seed + r``; rows run
    group-major, then realization, then trajectory."""
    from ..models.kicked_ising import draw_disorder_reference

    h_all = np.stack([draw_disorder_reference(L, h_over_J * J, disorder_seed + r)
                      for r in range(int(n_realizations))])
    return np.tile(np.repeat(h_all, int(n_trajectories), axis=0),
                   (int(n_groups), 1))


def memory_rows(gamma_dt, noise, *, J: float, tau: float, chi: int,
                n_periods: int, h_rows=None, thetas=np.pi, start: str = "neel",
                chunk_size: int | None = None, mesh=None, checkpointer=None,
                device="cuda", dtype=torch.complex64) -> Dict[str, np.ndarray]:
    """The stochastic dephasing channel on every row; host numpy traces
    [rows, n_periods, ...] (``_evolve_stochastic_scan``'s keys).

    Row i has its dephasing rate times the period ``gamma_dt[i]``, its
    noise ``noise[i]`` [n_periods, L], its fields ``h_rows[i]`` (None: zero
    fields) and its kick ``thetas[i]`` (or one float for every row); its
    Floquet gates are built from them.  ``start`` is 'neel' or 'x_plus'.
    Truncation: no chi cap beyond ``chi``, svd_min 1e-7 (the JAX package's
    memory scans).  ``chunk_size`` None or 0 evaluates the rows as one
    batch; a positive value in chunks of that many rows.  ``mesh`` (a
    ``parallel.sweep.BatchMesh``, or 'auto': ``parallel.sweep.resolve_mesh``)
    shards each chunk's rows over its devices and ranks
    (``parallel.sweep.map_rows``); ``checkpointer`` (a
    ``utils.checkpoint.SweepCheckpointer``) loads the chunks it holds and
    saves each new one.
    """
    from ..core.mps import create_initial_state
    from ..core.truncate import TruncParams
    from ..dynamics.open_system import _evolve_stochastic_scan
    from ..dynamics.tebd import to_host
    from ..models.kicked_ising import make_floquet_gates
    from ..parallel.sweep import BatchMesh, map_rows, resolve_mesh

    noise = np.asarray(noise)
    gamma_dt = np.asarray(gamma_dt, float)
    B, L = noise.shape[0], noise.shape[-1]
    if chunk_size is not None and int(chunk_size) < 0:
        raise ValueError(f"chunk_size must be >= 0, got {chunk_size}")
    if B == 0:
        raise ValueError("empty batch: the leading axis of the sweep arrays "
                         "(gammas/eps_values x realizations x trajectories) "
                         "has zero rows")
    real = dtype.to_real()
    tp = TruncParams(chi_max=0, svd_min=1e-7)
    mesh = resolve_mesh(mesh, device) or BatchMesh((device,))
    rows = {"gamma_dt": gamma_dt, "noise": noise}
    if h_rows is not None:
        rows["h"] = np.asarray(h_rows)
    if np.ndim(thetas) != 0:
        rows["thetas"] = np.asarray(thetas, float)

    def run(r, dev):
        psi0 = (create_initial_state(L, "neel", chi=chi, dtype=dtype, device=dev)
                if start == "neel" else _x_plus_state(L, chi, dtype, dev))
        h = (torch.zeros(L, dtype=torch.float64, device=dev) if "h" not in r
             else torch.as_tensor(r["h"], dtype=real, device=dev))
        th = (float(thetas) if "thetas" not in r else
              torch.as_tensor(r["thetas"], dtype=real, device=dev))
        gates = make_floquet_gates(J, h, tau, theta=th, dtype=dtype)
        _, tr = _evolve_stochastic_scan(psi0, gates, r["noise"], r["gamma_dt"],
                                        int(n_periods), tp)
        return to_host(tr)

    cs = int(chunk_size) if chunk_size else B
    done = checkpointer.completed_chunks() if checkpointer is not None else set()
    parts = []
    for ci, lo in enumerate(range(0, B, cs)):
        if ci in done:
            parts.append(checkpointer.load_chunk(ci))
            continue
        chunk = {k: v[lo:lo + cs] for k, v in rows.items()}
        part = map_rows(run, chunk, mesh)
        if checkpointer is not None:
            checkpointer.save_chunk(ci, part)
        parts.append(part)
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _envelope_stats(sz: np.ndarray, L: int):
    """(envelope [G, n], envelope_std [G, n]) of sz [G, samples, n, L]:
    sign-correct each sample, average over the disorder x trajectory pool,
    then normalize by the mean's first-period magnitude (a per-sample
    normalization would amplify noisy small denominators at large gamma)."""
    signs = np.where(np.arange(L) % 2 == 0, 1.0, -1.0)
    stag = (sz * signs).sum(axis=-1) / L                  # [G, S, n]
    env_traj = memory_envelope(stag, normalize=False)
    env_mean = env_traj.mean(axis=1)
    ref = np.abs(env_mean[:, :1])
    ref = np.where(ref > 1e-12, ref, 1.0)
    return env_mean / ref, env_traj.std(axis=1) / ref


def scan_memory_lifetime(gammas, L: int = 16, h_over_J: float = 0.3,
                         eps: float = 0.04, J: float = 1.0, tau: float = 1.0,
                         n_periods: int = 100, n_trajectories: int = 32,
                         n_realizations: int = 1, chi: int = 48,
                         disorder_seed: int = 42,
                         traj_seed: int = 0, coherence_leg: bool = True,
                         mesh=None, axis_name: str = "batch",
                         chunk_size: int | None = None,
                         checkpoint_dir: str | None = None, device="cuda",
                         dtype=torch.complex64) -> Dict:
    """Memory lifetime over dephasing rates.

    Evolves ``len(gammas) * n_realizations * n_trajectories`` stochastic
    dephasing trajectories of the kicked-Ising DTC (theta = pi (1 - eps);
    realization r's fields the reference's MT19937 draw at seed
    ``disorder_seed + r``) as rows of one batch (``memory_rows``; rows
    gamma-major, the noise from ``memory_noise(..., traj_seed)``).  The
    statistics pool disorder and channel noise.  ``chunk_size`` None or 0
    is one batch, a positive value chunks of rows (the same traces).

    Returns gammas [G]; times [n]; envelope and envelope_std [G, n];
    tau_bit [G]; eps, h_over_J, L, n_realizations; with ``coherence_leg``
    (the same channel without drive on |+x>, R*T trajectories a gamma,
    noise from ``traj_seed + 1``) sx_coherence [G, n], t2_qubit [G] and
    t2_analytic = 1 / (2 gamma).  ``mesh`` (a ``parallel.sweep.BatchMesh``)
    shards the rows (``memory_rows``); ``checkpoint_dir`` persists every
    chunk of rows, each leg under its own subdirectory (``bit``,
    ``coherence``), so a killed scan resumes at its first missing chunk; a
    resume with other parameters raises, and a multi-process run refuses it.
    """
    gammas = np.asarray(gammas, float)
    G, R, T = int(gammas.size), int(n_realizations), int(n_trajectories)
    dt = 2.0 * tau                       # one Floquet period
    theta = (1.0 - eps) * float(np.pi)
    h_rows = disorder_rows(L, h_over_J, J, disorder_seed, R, T, G)
    run = dict(J=J, tau=tau, chi=chi, n_periods=n_periods,
               chunk_size=chunk_size, mesh=mesh, device=device, dtype=dtype)
    fp_src = ("memory_gamma", np.round(gammas, 12).tolist(), L,
              round(h_over_J, 12), round(eps, 12), round(J, 12),
              round(tau, 12), int(n_periods), R, T, chi, disorder_seed,
              traj_seed, int(chunk_size or 0), str(dtype))
    tr = memory_rows(np.repeat(gammas * dt, R * T),
                     memory_noise(G * R * T, n_periods, L, traj_seed),
                     h_rows=h_rows, thetas=theta,
                     checkpointer=_make_checkpointer(
                         checkpoint_dir and os.path.join(checkpoint_dir, "bit"),
                         fp_src + ("bit",)), **run)
    envelope, envelope_std = _envelope_stats(
        tr["sz_sites"].reshape(G, R * T, n_periods, L), L)
    times = (np.arange(n_periods) + 1) * dt
    out = {"gammas": gammas, "times": times, "envelope": envelope,
           "envelope_std": envelope_std,
           "tau_bit": np.array([fit_memory_lifetime(times, envelope[g])
                                for g in range(G)]),
           "eps": float(eps), "h_over_J": float(h_over_J), "L": int(L),
           "n_realizations": R}

    if coherence_leg:
        # the bare-qubit anchor: no drive (J = h = 0, theta = 0), |+x>,
        # <sx> decays as e^{-2 gamma t}; disorder-free, so R*T trajectories
        # a gamma (the bit leg's sample count)
        Tc = R * T
        tr2 = memory_rows(np.repeat(gammas * dt, Tc),
                          memory_noise(G * Tc, n_periods, L, traj_seed + 1),
                          thetas=0.0, start="x_plus",
                          checkpointer=_make_checkpointer(
                              checkpoint_dir
                              and os.path.join(checkpoint_dir, "coherence"),
                              fp_src + ("coherence",)), **dict(run, J=0.0))
        sx_mean = tr2["sx_sites"].reshape(G, Tc, n_periods, L).mean(axis=(1, 3))
        out["sx_coherence"] = sx_mean
        out["t2_qubit"] = np.array([fit_memory_lifetime(times, sx_mean[g])
                                    for g in range(G)])
        with np.errstate(divide="ignore"):
            out["t2_analytic"] = np.where(gammas > 0, 1.0 / (2.0 * gammas),
                                          np.inf)
    return out


def scan_memory_vs_eps(eps_values, gamma: float, L: int = 16,
                       h_over_J: float = 0.3, J: float = 1.0,
                       tau: float = 1.0, n_periods: int = 100,
                       n_trajectories: int = 32, n_realizations: int = 1,
                       chi: int = 48, disorder_seed: int = 42,
                       traj_seed: int = 0, mesh=None,
                       axis_name: str = "batch",
                       chunk_size: int | None = None,
                       checkpoint_dir: str | None = None, device="cuda",
                       dtype=torch.complex64) -> Dict:
    """Stored-bit lifetime against pulse imperfection at a fixed dephasing
    rate: the kick angle pi (1 - eps) is one more row parameter (rows
    eps-major, then realization, then trajectory; the noise from
    ``memory_noise(..., traj_seed)``).

    ``mesh`` and ``checkpoint_dir`` as in ``scan_memory_lifetime`` (one
    leg, so no subdirectory).

    Returns {"eps", "times", "envelope" [E, n], "envelope_std", "tau_bit"
    [E], "gamma", "h_over_J", "L", "n_realizations"}.
    """
    eps_values = np.asarray(eps_values, float)
    E, R, T = int(eps_values.size), int(n_realizations), int(n_trajectories)
    dt = 2.0 * tau
    ck = _make_checkpointer(checkpoint_dir, (
        "memory_eps", np.round(eps_values, 12).tolist(), round(gamma, 12),
        L, round(h_over_J, 12), round(J, 12), round(tau, 12),
        int(n_periods), R, T, chi, disorder_seed, traj_seed,
        int(chunk_size or 0), str(dtype)))
    tr = memory_rows(np.full(E * R * T, gamma * dt),
                     memory_noise(E * R * T, n_periods, L, traj_seed),
                     h_rows=disorder_rows(L, h_over_J, J, disorder_seed, R, T, E),
                     thetas=np.repeat(np.pi * (1.0 - eps_values), R * T),
                     J=J, tau=tau, chi=chi, n_periods=n_periods,
                     chunk_size=chunk_size, mesh=mesh, checkpointer=ck,
                     device=device, dtype=dtype)
    envelope, envelope_std = _envelope_stats(
        tr["sz_sites"].reshape(E, R * T, n_periods, L), L)
    times = (np.arange(n_periods) + 1) * dt
    return {"eps": eps_values, "times": times, "envelope": envelope,
            "envelope_std": envelope_std,
            "tau_bit": np.array([fit_memory_lifetime(times, envelope[e])
                                 for e in range(E)]),
            "gamma": float(gamma), "h_over_J": float(h_over_J), "L": int(L),
            "n_realizations": R}


def generate_memory_figure(params: Dict, out_dir: str = "figures",
                           gammas=None, mesh=None, device="cuda",
                           dtype=torch.complex64, **scan_kwargs) -> tuple:
    """Render figures/memory_lifetime.{png,pdf}: the stored-bit envelope
    against time per gamma; tau_bit(gamma) against the bare-qubit
    T2 = 1/(2 gamma); and (``eps_values``, on by default) tau_bit(eps) at
    ``eps_gamma``.  Defaults: gammas logspace(-3, -1.3, 6), 3 realizations
    x 12 trajectories, tau = T_DRIVE / (2 J) and the seed of ``params``.
    Returns (figure, result of ``scan_memory_lifetime`` with the eps scan
    under 'eps_scan')."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if gammas is None:
        gammas = np.logspace(-3, -1.3, 6)
    eps_values = scan_kwargs.pop("eps_values",
                                 [0.0, 0.02, 0.04, 0.06, 0.09, 0.12])
    eps_gamma = scan_kwargs.pop("eps_gamma", 0.02)
    scan_kwargs.setdefault("J", float(params.get("J", 1.0)))
    scan_kwargs.setdefault("tau", float(params.get("T_DRIVE", 2.0)) /
                           (2.0 * scan_kwargs["J"]))
    scan_kwargs.setdefault("disorder_seed", int(params.get("RANDOM_SEED", 42)))
    scan_kwargs.setdefault("n_realizations", 3)
    scan_kwargs.setdefault("n_trajectories", 12)
    scan_kwargs.update(device=device, dtype=dtype)
    res = scan_memory_lifetime(gammas, mesh=mesh, **scan_kwargs)
    res_eps = None
    if eps_values is not None:
        eps_kwargs = {k: v for k, v in scan_kwargs.items()
                      if k not in ("eps", "coherence_leg", "traj_seed")}
        res_eps = scan_memory_vs_eps(eps_values, eps_gamma, mesh=mesh,
                                     **eps_kwargs)

    n_panels = 3 if res_eps is not None else 2
    fig, axes = plt.subplots(1, n_panels, figsize=(7 * n_panels, 6))
    ax1, ax2 = axes[0], axes[1]
    cmap = plt.get_cmap("viridis")
    for g, gamma in enumerate(res["gammas"]):
        c = cmap(g / max(len(res["gammas"]) - 1, 1))
        ax1.plot(res["times"], res["envelope"][g], color=c,
                 label=rf"$\gamma/J = {gamma:.3g}$")
        ax1.fill_between(res["times"],
                         res["envelope"][g] - res["envelope_std"][g],
                         res["envelope"][g] + res["envelope_std"][g],
                         color=c, alpha=0.15, linewidth=0)
    ax1.set_xlabel(r"Time $tJ$", fontsize=16)
    ax1.set_ylabel("Stored-bit envelope "
                   r"$(-1)^p \bar{M}_s(pT) / \bar{M}_s(T)$", fontsize=16)
    ax1.set_ylim(-0.05, 1.1)
    ax1.legend(fontsize=11)
    ax1.set_title(rf"DTC memory decay  ($L={res['L']}$, "
                  rf"$h/J={res['h_over_J']}$, $\epsilon={res['eps']}$, "
                  rf"{res['n_realizations']} disorder real.)",
                  fontsize=15)

    # a fit to a roundoff-flat envelope returns a huge finite tau; beyond
    # ~100x the simulated window that is "no decay within run"
    finite = np.isfinite(res["tau_bit"]) & \
        (res["tau_bit"] < 100.0 * res["times"][-1])
    ax2.loglog(res["gammas"][finite], res["tau_bit"][finite], "o-",
               color="#1f77b4", label=r"DTC bit lifetime $\tau_{bit}$")
    if np.any(~finite):
        top = np.nanmax(res["tau_bit"][finite]) if np.any(finite) \
            else res["times"][-1]
        ax2.scatter(res["gammas"][~finite], np.full((~finite).sum(), top * 2),
                    marker="^", color="#1f77b4",
                    label=r"no decay within run ($\tau \to \infty$)")
    if "t2_analytic" in res:
        ax2.loglog(res["gammas"], res["t2_analytic"], "k--",
                   label=r"bare qubit $T_2 = 1/2\gamma$")
        ok = np.isfinite(res["t2_qubit"])
        ax2.loglog(res["gammas"][ok], res["t2_qubit"][ok], "s",
                   color="0.4", label=r"bare qubit $T_2$ (measured)")
    ax2.set_xlabel(r"Dephasing rate $\gamma / J$", fontsize=16)
    ax2.set_ylabel(r"Lifetime $\tau J$", fontsize=16)
    ax2.legend(fontsize=12)
    ax2.set_title("Memory lifetime vs dephasing", fontsize=15)

    if res_eps is not None:
        ax3 = axes[2]
        tb = res_eps["tau_bit"]
        finite3 = np.isfinite(tb) & (tb < 100.0 * res_eps["times"][-1])
        ax3.semilogy(res_eps["eps"][finite3], tb[finite3], "o-",
                     color="#1f77b4", label=r"$\tau_{bit}(\epsilon)$")
        if np.any(~finite3):
            top3 = np.nanmax(tb[finite3]) if np.any(finite3) \
                else res_eps["times"][-1]
            ax3.scatter(res_eps["eps"][~finite3],
                        np.full((~finite3).sum(), top3 * 2), marker="^",
                        color="#1f77b4",
                        label=r"no decay within run ($\tau \to \infty$)")
        ax3.axhline(1.0 / (2.0 * res_eps["gamma"]), color="k",
                    linestyle="--",
                    label=rf"bare qubit $T_2$ at $\gamma/J = "
                          rf"{res_eps['gamma']:g}$")
        ax3.set_xlabel(r"Pulse imperfection $\epsilon = 1 - \theta/\pi$",
                       fontsize=16)
        ax3.set_ylabel(r"Lifetime $\tau J$", fontsize=16)
        ax3.legend(fontsize=12)
        ax3.set_title(rf"Pulse-error budget  ($\gamma/J = "
                      rf"{res_eps['gamma']:g}$)", fontsize=15)
    plt.tight_layout(pad=1.5)

    os.makedirs(out_dir, exist_ok=True)
    for ext, kw in (("png", {"dpi": 300}), ("pdf", {})):
        fig.savefig(os.path.join(out_dir, f"memory_lifetime.{ext}"),
                    bbox_inches="tight", facecolor="white", **kw)
    print(f"Memory-lifetime figure saved to {out_dir}/memory_lifetime.png/.pdf")
    if res_eps is not None:
        res["eps_scan"] = res_eps
    return fig, res

"""The phase, drive-strength and interaction-range diagrams.

Port of ``timecrystal_tpu/analysis/phase_diagram.py``.  A grid evolves as
one batched call of ``parallel.sweep.evolve_batch`` on ``device`` (every
point a realization of the batch: L-1 bonds of every point share one SVD
call), and is scored on the host (``analysis.detection``); rendering uses
matplotlib, imported by the ``generate_*`` functions only.

Left out on purpose (TPU-only in the JAX package): the batch-size routing
of svd_method (on a CUDA device 'auto' is 'jacobi'), the supervised
fault-recovery child process, and the chunk size derived from the TPU
worker's fault envelope (``chunk_size=None`` is one program here).  A
``mesh`` (``parallel.sweep.BatchMesh``, or 'auto': every local CUDA device
when there are several) shards each chunk's points
(``parallel.sweep.evolve_batch_sharded``); ``sweep_phase_grid``'s
``checkpoint_dir`` makes the sweep chunked and resumable.

The reference's hard-coded grid is kept: L=16, 80 periods, chi cap 24,
the seed from params, h/J in [0, 0.8] x T.J in [0.8, 4.0] on a 12 x 10
grid, Neel start, tau = T.J / (2 J).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.observables import (extract_subharmonic_amplitude,
                                subharmonic_weight_fraction)
from ..core.truncate import TruncParams
from ..parallel.sweep import (SweepSpec, _basis_indices, evolve_batch,
                              evolve_batch_sharded, phase_grid_batch,
                              resolve_mesh)
from .detection import score_grid

GRID_HARDCODED = dict(n_sites=16, n_periods=80, max_chi=24,
                      h_range=(0.0, 0.8), T_range=(0.8, 4.0),
                      n_points=(12, 10))


def _spec_dtype(dtype) -> str:
    """SweepSpec's dtype name of a complex working dtype."""
    if dtype not in (torch.complex64, torch.complex128):
        raise ValueError(f"dtype must be torch.complex64 or complex128: {dtype}")
    return "float32" if dtype == torch.complex64 else "float64"


def _grid_trunc(params: Dict) -> TruncParams:
    return TruncParams(chi_max=GRID_HARDCODED["max_chi"],
                       svd_min=float(params.get("SVD_MIN", 1e-12)),
                       trunc_cut=float(params.get("SVD_CUTOFF", 1e-7)))


def _evolve_chunked(h_fields, taus, basis, spec: SweepSpec, thetas,
                    chunk_size: int | None, device, mesh=None,
                    checkpointer=None) -> Dict[str, np.ndarray]:
    """evolve_batch over the whole batch (``chunk_size`` None or 0) or in
    chunks of ``chunk_size`` points, concatenated; with a ``mesh`` each
    chunk is sharded (``evolve_batch_sharded``).  ``checkpointer`` loads
    the chunks it holds and saves each new one."""
    B = len(taus)
    if chunk_size is not None and int(chunk_size) < 0:
        raise ValueError(f"chunk_size must be >= 0, got {chunk_size}")
    cs = int(chunk_size) if chunk_size else B
    done = checkpointer.completed_chunks() if checkpointer is not None else set()
    parts = []
    for ci, lo in enumerate(range(0, B, cs)):
        if ci in done:
            parts.append(checkpointer.load_chunk(ci))
            continue
        hi = min(lo + cs, B)
        th = None if thetas is None else thetas[lo:hi]
        if mesh is None:
            part = evolve_batch(h_fields[lo:hi], taus[lo:hi], basis, spec,
                                thetas=th, device=device)
        else:
            part = evolve_batch_sharded(h_fields[lo:hi], taus[lo:hi], basis,
                                        spec, mesh, thetas=th)
        if checkpointer is not None:
            checkpointer.save_chunk(ci, part)
        parts.append(part)
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def calculate_phase_point(h_over_J: float, T_J: float, params: Dict,
                          device="cuda", dtype=torch.complex64) -> Dict:
    """One point's record (the reference's per-point contract)."""
    res = sweep_phase_grid([h_over_J], [T_J], params, device=device,
                           dtype=dtype)
    return res["records"][0]


def sweep_phase_grid(h_values, T_values, params: Dict, mesh=None,
                     chi_pad: int = 32, show_progress: bool = False,
                     checkpoint_dir: str | None = None,
                     chunk_size: int | None = None,
                     svd_method: str | None = None, device="cuda",
                     dtype=torch.complex64) -> Dict:
    """Evolve the (h/J x T.J) grid at ``GRID_HARDCODED`` in one batched call
    (or in chunks of ``chunk_size`` points) and score every point.

    ``svd_method`` overrides the truncation's 'auto' (on a CUDA device
    'auto' is the Jacobi kernel, on the CPU LAPACK).  ``mesh``: a
    ``parallel.sweep.BatchMesh`` or 'auto' (``parallel.sweep.resolve_mesh``).

    ``checkpoint_dir`` makes the sweep chunked and resumable
    (``utils.checkpoint.SweepCheckpointer``): ``chunk_size`` points a chunk
    (default: an eighth of the grid), each chunk saved when done, and a
    later call resumes at the first missing chunk.  The fingerprint holds
    the fields, taus, basis, spec and chunk size, with svd_method
    neutralised (a resume may switch SVD methods and keep the chunks done).
    Refused in a multi-process run: the ranks would race the same files.
    Returns {"records", "hs", "Ts", "traces"}."""
    mesh = resolve_mesh(mesh, device)
    hc = GRID_HARDCODED
    tp = _grid_trunc(params)
    if svd_method:
        tp = tp._replace(svd_method=svd_method)
    spec = SweepSpec(L=hc["n_sites"], chi=chi_pad, n_periods=hc["n_periods"],
                     J=float(params.get("J", 1.0)), theta=float(np.pi), tp=tp,
                     dtype=_spec_dtype(dtype))
    h_fields, taus, hs, Ts = phase_grid_batch(
        h_values, T_values, spec,
        disorder_seed=int(params.get("RANDOM_SEED", 42)))
    basis = _basis_indices(spec.L, "neel")
    ck = None
    if checkpoint_dir is not None:
        from ..parallel.multihost import process_count
        from ..utils.checkpoint import SweepCheckpointer, fingerprint

        if process_count() > 1:
            raise ValueError(
                "checkpoint_dir is not supported in a multi-process run: "
                "every process would race the same chunk/manifest files.  "
                "Run the sweep without checkpointing, or checkpoint "
                "per-slice single-process sweeps.")
        chunk_size = int(chunk_size or max(1, -(-len(taus) // 8)))
        fp_spec = spec._replace(tp=spec.tp._replace(svd_method="*"))
        ck = SweepCheckpointer(checkpoint_dir, fingerprint=fingerprint(
            np.round(h_fields, 12).tolist(), np.round(taus, 12).tolist(),
            basis.tolist(), fp_spec, chunk_size))
    traces = _evolve_chunked(h_fields, taus, basis, spec, None, chunk_size,
                             device, mesh, ck)
    n_stored = traces["loschmidt_echo"].shape[1]
    times = np.arange(n_stored)[None, :] * (2.0 * taus)[:, None]
    records = score_grid(traces, times, hs, Ts, drive_periods=2.0 * taus,
                         show_progress=show_progress)
    return {"records": records, "hs": hs, "Ts": Ts, "traces": traces}


def drive_grid_batch(eps_values, h_values, params: Dict, chi_pad: int = 48,
                     n_sites: int | None = None, n_periods: int | None = None,
                     dtype=torch.complex64):
    """The drive-strength diagram's batch, point (eps, h) in row-major
    order: (spec, h_fields [P, L], taus [P], thetas [P] = pi (1 - eps),
    eps [P], h [P]).

    Every point uses the reference's disorder convention: ONE MT19937
    pattern from ``np.random.seed(RANDOM_SEED)`` (the global stream, as in
    the JAX package) scaled by h.  The drive period is T_DRIVE."""
    hc = GRID_HARDCODED
    L = int(n_sites or hc["n_sites"])
    J = float(params.get("J", 1.0))
    tau = float(params.get("T_DRIVE", 2.0)) / (2.0 * J)
    spec = SweepSpec(L=L, chi=chi_pad, n_periods=int(n_periods or hc["n_periods"]),
                     J=J, theta=float(np.pi), tp=_grid_trunc(params),
                     dtype=_spec_dtype(dtype))
    np.random.seed(int(params.get("RANDOM_SEED", 42)))
    base = np.random.uniform(-1.0, 1.0, L)        # the same MT19937 stream
    eps_g, h_g = np.meshgrid(np.asarray(eps_values, float),
                             np.asarray(h_values, float), indexing="ij")
    eps_f, h_f = eps_g.ravel(), h_g.ravel()
    return (spec, h_f[:, None] * J * base[None, :], np.full(len(eps_f), tau),
            np.pi * (1.0 - eps_f), eps_f, h_f)


def sweep_drive_grid(eps_values, h_values, params: Dict, mesh=None,
                     chi_pad: int = 48, n_sites: int | None = None,
                     n_periods: int | None = None,
                     chunk_size: int | None = None, device="cuda",
                     dtype=torch.complex64) -> Dict:
    """Drive-strength diagram: pulse imperfection eps x disorder h/J, kick
    theta = pi (1 - eps) per point, drive period T_DRIVE from params,
    scored by A2T and the subharmonic weight fraction of the staggered
    magnetization.  The batch is ``drive_grid_batch``'s (the reference's
    global-stream disorder draw).  ``chunk_size`` None or 0 evolves the
    grid as one program, n > 0 in chunks of n points.

    ``mesh``: a ``parallel.sweep.BatchMesh`` or 'auto'
    (``parallel.sweep.resolve_mesh``); the JAX package's drive grid has no
    ``checkpoint_dir``, nor has this one.

    Returns {"A2T" [n_eps, n_h], "subharmonic_weight", "eps", "hs",
    "records", "traces"}."""
    spec, h_fields, taus, thetas, eps_f, h_f = drive_grid_batch(
        eps_values, h_values, params, chi_pad, n_sites, n_periods, dtype)
    traces = _evolve_chunked(h_fields, taus, _basis_indices(spec.L, "neel"),
                             spec, thetas, chunk_size, device,
                             resolve_mesh(mesh, device))

    tau, n_per = float(taus[0]), spec.n_periods
    times = np.arange(n_per + 1) * (2.0 * tau)
    stag = traces["staggered_magnetization"]
    records = []
    a2t = np.zeros(len(eps_f))
    w2t = np.zeros(len(eps_f))
    for g in range(len(eps_f)):
        s = stag[g]
        ok = bool(np.all(np.isfinite(s)))
        if ok:
            a2t[g] = extract_subharmonic_amplitude(times, s, 2.0 * tau)
            w2t[g] = subharmonic_weight_fraction(times, s, 2.0 * tau)
        records.append({"eps": float(eps_f[g]), "h_over_J": float(h_f[g]),
                        "A2T": float(a2t[g]),
                        "subharmonic_weight": float(w2t[g]), "success": ok})
    shape = (np.size(eps_values), np.size(h_values))
    return {"A2T": a2t.reshape(shape),
            "subharmonic_weight": w2t.reshape(shape),
            "eps": np.asarray(eps_values, float),
            "hs": np.asarray(h_values, float), "records": records,
            "traces": traces}


def _save(fig, out_dir: str, stem: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for ext, kw in (("png", {"dpi": 600}), ("pdf", {})):
        fig.savefig(os.path.join(out_dir, f"{stem}.{ext}"),
                    bbox_inches="tight", facecolor="white",
                    edgecolor="none", **kw)


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def generate_drive_diagram(params: Dict, mesh=None, out_dir: str = "figures",
                           n_eps: int = 12, n_h: int = 10,
                           eps_range=(0.0, 0.5), h_range=(0.0, 0.8),
                           device="cuda", dtype=torch.complex64) -> Tuple:
    """Render the drive-strength (eps x h/J) melting diagram into
    ``out_dir``/drive_strength_diagram.{png,pdf}: A2T (left) and the
    subharmonic weight fraction (right, which keeps a gradient where A2T
    plateaus at 1).  The grid is one program."""
    plt = _pyplot()
    eps_values = np.linspace(*eps_range, n_eps)
    h_values = np.linspace(*h_range, n_h)
    print(f"Computing {n_eps * n_h} drive-strength points (one batched "
          f"program on {device})...")
    res = sweep_drive_grid(eps_values, h_values, params, mesh=mesh,
                           device=device, dtype=dtype)
    A2T = res["A2T"]
    W2T = res["subharmonic_weight"]

    fig, axes = plt.subplots(1, 2, figsize=(19, 8))
    panels = (
        (axes[0], A2T, r"Subharmonic response $A_{2T}$"),
        (axes[1], W2T,
         r"Subharmonic weight fraction $|F(\omega/2)|^2 / \Sigma |F|^2$"),
    )
    for ax, Z, label in panels:
        im = ax.imshow(Z.T, extent=[*eps_range, *h_range], aspect="auto",
                       origin="lower", cmap="viridis",
                       interpolation="bilinear", vmin=0,
                       vmax=max(float(np.max(Z)), 1e-12))
        cbar = plt.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
        cbar.set_label(label, rotation=270, labelpad=25, fontsize=18)
        cbar.ax.tick_params(labelsize=16)
        if np.max(Z) > 0.3:
            ax.contour(eps_values, h_values, Z.T,
                       levels=[float(np.max(Z)) * 0.5], colors="white",
                       linewidths=2, linestyles="--")
        ax.set_xlabel(r"Pulse imperfection $\epsilon = 1 - \theta/\pi$",
                      fontsize=18)
        ax.set_ylabel(r"Disorder strength $h/J$", fontsize=18)
        ax.tick_params(axis="both", which="major", labelsize=16)
    plt.tight_layout(pad=1.5)
    _save(fig, out_dir, "drive_strength_diagram")
    print(f"Drive-strength diagram saved to "
          f"{out_dir}/drive_strength_diagram.png/.pdf")
    print(f"A2T range: [{np.min(A2T):.3f}, {np.max(A2T):.3f}]")
    print(f"Subharmonic weight fraction range: "
          f"[{np.min(W2T):.3f}, {np.max(W2T):.3f}]")
    return fig, axes


def generate_range_diagram(params: Dict, out_dir: str = "figures",
                           alphas=None, eps_values=(0.0, 0.05),
                           L: int = 12, n_periods: int = 24,
                           n_realizations: int = 3, chi: int = 48,
                           substeps: int = 2, device="cuda",
                           dtype=torch.complex64) -> Tuple:
    """Render A2T against the interaction-range exponent alpha (J/r^alpha
    couplings, two-site TDVP; ``models.long_range.scan_interaction_range``)
    into ``out_dir``/interaction_range_diagram.{png,pdf}: one curve per
    pulse imperfection eps, disorder-averaged over ``n_realizations``
    draws (error bars: their std); the nearest-neighbour limit (alpha None)
    is the rightmost point."""
    from ..models.long_range import scan_interaction_range

    plt = _pyplot()
    if alphas is None:
        alphas = [0.8, 1.2, 1.6, 2.0, 2.5, 3.0, None]
    J = float(params.get("J", 1.0))
    tau = float(params.get("T_DRIVE", 2.0)) / (2.0 * J)
    h_over_J = float(params.get("H_MAX", 0.3))
    seed = int(params.get("RANDOM_SEED", 42))

    finite = [a for a in alphas if a is not None and np.isfinite(a)]
    x_nn = (max(finite) + (finite[-1] - finite[0]) / max(len(finite) - 1, 1)
            if finite else 1.0)

    results = {}
    for eps in eps_values:
        print(f"Interaction-range scan at eps = {eps:g} "
              f"({len(alphas)} alphas x {n_realizations} realizations, "
              f"L={L}, {n_periods} periods, TDVP chi={chi})...")
        results[eps] = scan_interaction_range(
            alphas, L=L, J=J, h_disorder=h_over_J * J, tau=tau,
            theta=(1.0 - eps) * float(np.pi), n_periods=n_periods,
            n_realizations=n_realizations, chi=chi, substeps=substeps,
            seed0=seed, dtype=dtype, device=device, progress=True)

    fig, ax = plt.subplots(figsize=(10, 7))
    colors = plt.get_cmap("viridis")(np.linspace(0.15, 0.8,
                                                 len(eps_values)))
    xs = [float(a) if a is not None and np.isfinite(a) else x_nn
          for a in alphas]
    for c, eps in zip(colors, eps_values):
        res = results[eps]
        ax.errorbar(xs, res["a2t"], yerr=res["a2t_std"], marker="o",
                    color=c, capsize=3, label=rf"$\epsilon = {eps:g}$")
    ax.axvline(x_nn, color="0.6", linestyle=":", linewidth=1)
    labels = [f"{x:g}" for x in xs[:-1]] + \
        ([r"NN ($\infty$)"] if alphas[-1] is None
         or not np.isfinite(alphas[-1]) else [f"{xs[-1]:g}"])
    ax.set_xticks(xs)
    ax.set_xticklabels(labels)
    ax.set_xlabel(r"Interaction-range exponent $\alpha$  "
                  r"($J(r) = J/r^\alpha$)", fontsize=16)
    ax.set_ylabel(r"Subharmonic response $A_{2T}$", fontsize=16)
    ax.set_ylim(-0.05, 1.1)
    ax.legend(fontsize=13, title="Pulse imperfection")
    ax.set_title(rf"DTC order vs interaction range  ($L={L}$, "
                 rf"$h/J={h_over_J:g}$, {n_realizations} disorder real.)",
                 fontsize=15)
    plt.tight_layout(pad=1.5)
    _save(fig, out_dir, "interaction_range_diagram")
    print(f"Interaction-range diagram saved to "
          f"{out_dir}/interaction_range_diagram.png/.pdf")
    for eps in eps_values:
        print(f"  eps={eps:g}: A2T "
              f"{np.round(results[eps]['a2t'], 3).tolist()}")
    return fig, results


def generate_phase_diagram(params: Dict, mesh="auto", out_dir: str = "figures",
                           show_progress: bool = True, device="cuda",
                           dtype=torch.complex64) -> Tuple:
    """Compute, render and save the phase diagram into
    ``out_dir``/final_phase_diagram.{png,pdf} (the reference's files)."""
    plt = _pyplot()
    hc = GRID_HARDCODED
    nh, nT = hc["n_points"]
    h_values = np.linspace(*hc["h_range"], nh)
    T_values = np.linspace(*hc["T_range"], nT)

    print("=" * 60)
    print("GENERATING PHASE DIAGRAM")
    print("=" * 60)
    print(f"Computing {nh * nT} phase diagram points (one batched program "
          f"on {device})...")
    print(f"h/J range: [{hc['h_range'][0]:.2f}, {hc['h_range'][1]:.2f}]  "
          f"T*J range: [{hc['T_range'][0]:.2f}, {hc['T_range'][1]:.2f}]")
    print(f"System size: {hc['n_sites']}, Evolution periods: {hc['n_periods']}")
    res = sweep_phase_grid(h_values, T_values, params, mesh=mesh,
                           show_progress=show_progress, device=device,
                           dtype=dtype)
    A2T = np.zeros((nT, nh))
    raw = np.zeros((nT, nh))
    success = np.zeros((nT, nh), dtype=bool)
    for rec, h, T in zip(res["records"], res["hs"], res["Ts"]):
        i = int(np.argmin(np.abs(h_values - h)))
        j = int(np.argmin(np.abs(T_values - T)))
        A2T[j, i] = rec["A2T"]
        raw[j, i] = rec["dtc_score_raw"]
        success[j, i] = rec["success"]

    fig, ax = plt.subplots(figsize=(10, 8))
    im = ax.imshow(A2T, extent=[*hc["h_range"], *hc["T_range"]],
                   aspect="auto", origin="lower", cmap="viridis",
                   interpolation="bilinear", vmin=0,
                   vmax=max(np.max(A2T), 1e-12))
    cbar = plt.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
    cbar.set_label(r"DTC Order Parameter $A_{2T}$", rotation=270,
                   labelpad=25, fontsize=18)
    cbar.ax.tick_params(labelsize=16)

    if np.max(A2T) > 0.1:
        ax.contour(h_values, T_values, A2T,
                   levels=np.linspace(0.1, np.max(A2T), 4),
                   colors="white", linewidths=0.8, alpha=0.8)
    if np.max(A2T) > 0.3:
        ax.contour(h_values, T_values, A2T, levels=[np.max(A2T) * 0.5],
                   colors="white", linewidths=2, linestyles="--")

    label_style = dict(fontsize=16, color="white", ha="center", va="center",
                       weight="bold",
                       bbox=dict(boxstyle="round,pad=0.4", facecolor="black",
                                 alpha=0.7))
    ax.text(0.1, 3.5, "Thermal\n(Fast Drive)", **label_style)
    ax.text(0.25, 2.0, "DTC", **{**label_style, "fontsize": 18})
    ax.text(0.65, 2.5, "MBL\n(High Disorder)", **label_style)
    ax.text(0.4, 1.0, "Adiabatic\n(Slow Drive)", **label_style)
    ax.axvline(x=0.5, color="red", linestyle=":", alpha=0.6, linewidth=1)
    ax.text(0.52, 3.7, "MBL transition", fontsize=16, color="red",
            rotation=90, va="top")
    ax.set_xlabel(r"Disorder strength $h/J$", fontsize=18)
    ax.set_ylabel(r"Drive period $T \cdot J$", fontsize=18)
    ax.tick_params(axis="both", which="major", labelsize=16)
    plt.tight_layout(pad=1.5)
    _save(fig, out_dir, "final_phase_diagram")

    print(f"\nPhase diagram saved to {out_dir}/final_phase_diagram.png/.pdf")
    print(f"Success rate: {np.mean(success) * 100:.1f}%")
    print(f"A2T range: [{np.min(A2T):.3f}, {np.max(A2T):.3f}]")
    print(f"Raw DTC score range: [{np.min(raw):.3f}, {np.max(raw):.3f}]")
    best = np.unravel_index(np.argmax(A2T), A2T.shape)
    print(f"Best DTC point: h/J = {h_values[best[1]]:.3f}, "
          f"T*J = {T_values[best[0]]:.3f}, A2T = {A2T[best]:.3f}")
    return fig, ax

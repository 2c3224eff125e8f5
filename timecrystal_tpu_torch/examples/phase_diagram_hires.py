"""High-resolution phase diagram: the scan config.txt asks for.  Port of
the JAX package's ``examples/phase_diagram_hires.py``.

The reference declares a 25 x 20 scan grid in config.txt (H_SCAN_POINTS /
T_SCAN_POINTS) but its phase diagram hard-codes a 12 x 10 grid.  Here the
whole 500-point grid evolves as batched programs on the card
(``analysis.phase_diagram.sweep_phase_grid``), with the per-point physics
(L=16, 80 periods, chi cap 24, Neel start, seed) of the hard-coded diagram,
so the two diagrams compare point for point.

    python -m timecrystal_tpu_torch.examples.phase_diagram_hires [--cpu]
        [--config PATH] [--out-dir figures] [--chunk-size 100]
        [--checkpoint-dir DIR]           # '' runs the grid as one program

Writes phase_diagram_hires.{png,pdf} under --out-dir (matplotlib) and
prints the summary block of the production phase diagram.  The sweep runs
in chunks of --chunk-size points, each saved under --checkpoint-dir, so a
killed scan resumes at its first missing chunk; without a checkpoint
directory the grid is one program.  Without ``--cpu`` the run needs a CUDA
device and raises when there is none.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..analysis.phase_diagram import sweep_phase_grid
from ..utils.config import read_parameters


def grid_axes(params: dict):
    """(h_values [nh], T_values [nT]) of config.txt's scan grid."""
    nh = int(params.get("H_SCAN_POINTS", 25))
    nT = int(params.get("T_SCAN_POINTS", 20))
    return (np.linspace(float(params.get("H_SCAN_MIN", 0.0)),
                        float(params.get("H_SCAN_MAX", 0.8)), nh),
            np.linspace(float(params.get("T_SCAN_MIN", 0.5)),
                        float(params.get("T_SCAN_MAX", 4.0)), nT))


def hires_grid(params: dict, chunk_size: int = 100,
               checkpoint_dir: str | None = None, show_progress: bool = False,
               device="cuda", dtype=torch.complex64) -> dict:
    """The scan grid through ``sweep_phase_grid``: in chunks of
    ``chunk_size`` points saved under ``checkpoint_dir``, or as one program
    when ``checkpoint_dir`` is None or ''.  Returns {sweep (the sweep's
    result), h_values, T_values, A2T [nT, nh], success [nT, nh], wall (s),
    points_per_second}."""
    h_values, T_values = grid_axes(params)
    t0 = time.perf_counter()
    res = sweep_phase_grid(h_values, T_values, params,
                           show_progress=show_progress,
                           checkpoint_dir=checkpoint_dir or None,
                           chunk_size=chunk_size if checkpoint_dir else None,
                           device=device, dtype=dtype)
    wall = time.perf_counter() - t0
    A2T = np.zeros((len(T_values), len(h_values)))
    success = np.zeros((len(T_values), len(h_values)), dtype=bool)
    for rec, h, T in zip(res["records"], res["hs"], res["Ts"]):
        i = int(np.argmin(np.abs(h_values - h)))
        j = int(np.argmin(np.abs(T_values - T)))
        A2T[j, i] = rec["A2T"]
        success[j, i] = rec["success"]
    return dict(sweep=res, h_values=h_values, T_values=T_values, A2T=A2T,
                success=success, wall=wall,
                points_per_second=A2T.size / wall)


def render(grid: dict, out_dir: str, dpi: int = 300) -> list:
    """phase_diagram_hires.{png,pdf} of ``hires_grid``'s result under
    ``out_dir``; returns the paths written."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    h_values, T_values, A2T = grid["h_values"], grid["T_values"], grid["A2T"]
    fig, ax = plt.subplots(figsize=(10, 8))
    im = ax.imshow(A2T, extent=[h_values[0], h_values[-1],
                                T_values[0], T_values[-1]],
                   aspect="auto", origin="lower", cmap="viridis",
                   interpolation="bilinear", vmin=0,
                   vmax=max(float(np.max(A2T)), 1e-12))
    cbar = plt.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
    cbar.set_label(r"DTC Order Parameter $A_{2T}$", rotation=270,
                   labelpad=25, fontsize=18)
    if np.max(A2T) > 0.1:
        ax.contour(h_values, T_values, A2T,
                   levels=np.linspace(0.1, float(np.max(A2T)), 6),
                   colors="white", linewidths=0.8, alpha=0.8)
    ax.set_xlabel(r"Disorder strength $h/J$", fontsize=18)
    ax.set_ylabel(r"Drive period $T \cdot J$", fontsize=18)
    ax.set_title(f"Kicked-Ising DTC phase diagram, {len(h_values)}x"
                 f"{len(T_values)} scan (config.txt resolution)", fontsize=14)
    plt.tight_layout(pad=1.5)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for ext, kw in (("png", {"dpi": dpi}), ("pdf", {})):
        paths.append(os.path.join(out_dir, f"phase_diagram_hires.{ext}"))
        fig.savefig(paths[-1], bbox_inches="tight", facecolor="white", **kw)
    plt.close(fig)
    return paths


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None, help="parameter file path")
    ap.add_argument("--out-dir", default="figures")
    ap.add_argument("--chunk-size", type=int, default=100,
                    help="phase points per device program")
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "tct_phase_hires_ckpt"),
                    help="per-chunk resume dir ('' runs one program)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU in complex128 instead of the CUDA device")
    args = ap.parse_args(argv)
    from ..main import run_device

    device, dtype = run_device(args.cpu)
    params = read_parameters(args.config) if args.config else read_parameters()
    h_values, T_values = grid_axes(params)
    print(f"High-res phase diagram: {len(h_values)} x {len(T_values)} = "
          f"{len(h_values) * len(T_values)} points (batched programs on "
          f"{device})")
    grid = hires_grid(params, chunk_size=args.chunk_size,
                      checkpoint_dir=args.checkpoint_dir, show_progress=True,
                      device=device, dtype=dtype)
    print(f"sweep wall time: {grid['wall']:.1f} s "
          f"({grid['points_per_second']:.1f} phase points/s)")
    render(grid, args.out_dir, dpi=int(params.get("DPI", 300)))
    print(f"saved {args.out_dir}/phase_diagram_hires.png/.pdf")
    A2T = grid["A2T"]
    print(f"Success rate: {np.mean(grid['success']) * 100:.1f}%")
    best = np.unravel_index(int(np.argmax(A2T)), A2T.shape)
    print(f"Best DTC point: h/J = {h_values[best[1]]:.3f}, "
          f"T*J = {T_values[best[0]]:.3f}, A2T = {A2T[best]:.3f}")


if __name__ == "__main__":
    main()

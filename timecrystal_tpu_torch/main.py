"""Figure-generation CLI of the PyTorch / CUDA port.

    python -m timecrystal_tpu_torch                 # phase diagram + figures A-D
    python -m timecrystal_tpu_torch --phase-only    # only the phase diagram
    python -m timecrystal_tpu_torch --figures-only  # only figures A-D
    python -m timecrystal_tpu_torch --drive-diagram # eps x h/J melting diagram
    python -m timecrystal_tpu_torch --range-diagram # A2T vs interaction range
    python -m timecrystal_tpu_torch --memory-diagram  # DTC memory lifetimes
    python -m timecrystal_tpu_torch --cpu ...       # on the CPU (complex128)

The flags of the JAX package's ``main.py``.  Without ``--cpu`` the run
needs a CUDA device and stops with an error when there is none; ``--cpu``
runs on the CPU in complex128.  Figures are written to ./figures and need
matplotlib.  A failed run exits with status 1.
"""

from __future__ import annotations

import argparse
import sys
import time


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m timecrystal_tpu_torch",
        description="Generate time crystal physics figures (PyTorch / CUDA)",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="""
Examples:
  python -m timecrystal_tpu_torch                 # phase diagram and figures A-D
  python -m timecrystal_tpu_torch --phase-only    # only the phase diagram
  python -m timecrystal_tpu_torch --figures-only  # only figures A-D
        """,
    )
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--phase-only", action="store_true",
                      help="Generate only the phase diagram")
    mode.add_argument("--figures-only", action="store_true",
                      help="Generate only the individual figures A-D")
    mode.add_argument("--drive-diagram", action="store_true",
                      help="Generate the drive-strength (pulse imperfection "
                           "eps x disorder h/J) DTC melting diagram")
    mode.add_argument("--range-diagram", action="store_true",
                      help="Generate the interaction-range diagram: "
                           "subharmonic response A2T vs power-law exponent "
                           "alpha (J/r^alpha couplings, TDVP-integrated)")
    mode.add_argument("--memory-diagram", action="store_true",
                      help="Generate the DTC-as-quantum-memory lifetime "
                           "figure (stored-bit lifetime vs dephasing rate "
                           "and pulse error)")
    parser.add_argument("--config", type=str, default=None,
                        help="Path to configuration file (default: ./config.txt)")
    parser.add_argument("--synthetic-multisite", action="store_true",
                        help="Reproduce the reference's synthetic Figure-D "
                             "per-site traces instead of true expectations")
    parser.add_argument("--cpu", action="store_true",
                        help="Run on the CPU in complex128 instead of the "
                             "CUDA device")
    return parser.parse_args(argv)


def _configure_matplotlib(phase_only: bool) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if phase_only:
        plt.rcParams.update({
            "font.size": 14, "axes.titlesize": 16, "axes.labelsize": 14,
            "xtick.labelsize": 12, "ytick.labelsize": 12,
            "legend.fontsize": 12, "figure.titlesize": 18,
        })
    else:
        plt.rcParams.update({
            "font.size": 9, "axes.titlesize": 10, "axes.labelsize": 9,
            "xtick.labelsize": 8, "ytick.labelsize": 8,
            "legend.fontsize": 7, "figure.titlesize": 11,
        })
    plt.rcParams.update({
        "font.family": "sans-serif",
        "font.sans-serif": ["Arial", "Helvetica", "DejaVu Sans", "sans-serif"],
        "mathtext.fontset": "dejavusans",
        "figure.dpi": 100, "savefig.dpi": 600,
        "axes.linewidth": 0.8,
        "xtick.major.width": 0.8, "ytick.major.width": 0.8,
        "xtick.minor.width": 0.5, "ytick.minor.width": 0.5,
        "lines.linewidth": 1.5, "patch.linewidth": 0.4,
        "axes.grid": False,
        "axes.spines.top": False, "axes.spines.right": False,
        "xtick.direction": "out", "ytick.direction": "out",
        "figure.facecolor": "white", "axes.facecolor": "white",
    })


def run_device(cpu: bool):
    """(device, dtype) of a run: the CPU in complex128 when asked for,
    else the CUDA device in complex64; RuntimeError when there is none."""
    import torch

    if cpu:
        return "cpu", torch.complex128
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this run needs a GPU (pass --cpu "
                           "to run on the CPU)")
    return "cuda", torch.complex64


def main(argv=None) -> None:
    args = parse_arguments(argv)
    device, dtype = run_device(args.cpu)
    run = dict(device=device, dtype=dtype)

    print("=" * 60)
    print(f"TIME CRYSTAL PHYSICS - UNIFIED FIGURE GENERATION ({device})")
    print("=" * 60)

    from .utils.config import read_parameters

    params = read_parameters(args.config)
    if not params:
        print("Failed to read parameters file.")
        sys.exit(1)
    print(f"Loaded {len(params)} parameters")

    solo = args.drive_diagram or args.range_diagram or args.memory_diagram
    generate_phase = not (args.figures_only or solo)
    generate_figures = not (args.phase_only or solo)
    mode = ("Phase diagram only" if args.phase_only else
            "Individual figures A-D only" if args.figures_only else
            "Drive-strength diagram only" if args.drive_diagram else
            "Interaction-range diagram only" if args.range_diagram else
            "Memory-lifetime figure only" if args.memory_diagram else
            "Both phase diagram and individual figures A-D")
    print(f"Mode: {mode}")

    _configure_matplotlib(phase_only=not generate_figures)
    import matplotlib.pyplot as plt

    start = time.time()
    try:
        if args.drive_diagram:
            from .analysis.phase_diagram import generate_drive_diagram
            generate_drive_diagram(params, **run)
            plt.close("all")

        if args.range_diagram:
            from .analysis.phase_diagram import generate_range_diagram
            generate_range_diagram(params, **run)
            plt.close("all")

        if args.memory_diagram:
            from .analysis.memory import generate_memory_figure
            generate_memory_figure(params, **run)
            plt.close("all")

        if generate_phase:
            from .analysis.phase_diagram import generate_phase_diagram
            generate_phase_diagram(params, **run)
            plt.close("all")

        if generate_figures:
            from .analysis.figures import generate_individual_figures
            generate_individual_figures(
                params, synthetic_parity_d=args.synthetic_multisite, **run)

        print("\n" + "=" * 60)
        print("SUCCESS: Figure generation completed!")
    except Exception as exc:
        print(f"Error generating figures: {exc}")
        import traceback
        traceback.print_exc()
        print(f"\nTotal execution time: {time.time() - start:.1f} seconds")
        sys.exit(1)

    print(f"\nTotal execution time: {time.time() - start:.1f} seconds")


if __name__ == "__main__":
    main()

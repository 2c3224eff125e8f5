"""The JAX package's three example scripts as entry points of the port.

    python -m timecrystal_tpu_torch.examples.quickstart [--cpu]
    python -m timecrystal_tpu_torch.examples.phase_diagram_hires [--cpu] ...
    python -m timecrystal_tpu_torch.examples.multihost_demo [--cpu] ...

Each keeps its script's flags, defaults, physics and printed summary. The
work lives in functions that return their numbers; ``main()`` prints them.
Without ``--cpu`` an example runs on the CUDA device and raises when there
is none; ``--cpu`` runs on the CPU in complex128.
"""

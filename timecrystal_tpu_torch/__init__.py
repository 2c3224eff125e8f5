"""timecrystal_tpu_torch: the PyTorch / CUDA port of ``timecrystal_tpu``.

Kicked-Ising Floquet TEBD on a padded MPS, written for one NVIDIA H100
(Hopper, ``sm_90a``).  Module names mirror the JAX package so each
counterpart is easy to find (``timecrystal_tpu/core/mps.py`` ->
``timecrystal_tpu_torch/core/mps.py``).  Differences in idiom:

  * native complex dtypes (complex64 on the card, complex128 for the CPU
    parity tests) instead of ``ops/cpx.py``'s (re, im) pairs, which exist
    only because the TPU backend has no complex dtype;
  * plain functions on tensors and small dataclasses for state; the
    ensemble axis that JAX adds with ``vmap`` is a written-out leading
    batch axis R;
  * every constructor takes ``device=``; randomness comes from numpy or an
    explicit ``torch.Generator``;
  * the one Pallas kernel on the main path (the one-sided Jacobi sweep)
    is a hand-written CUDA kernel, ``csrc/jacobi_sweep.cu``, with a plain
    torch twin that CPU tensors use.

Float32 matmuls run at full precision: TF32 is switched off below, the
counterpart of ``cpx.einsum``'s pinned ``precision='highest'`` (TF32 keeps
~3 decimal digits and would put physics errors at the 1e-3 level).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

# the top-level names of the JAX package
from .core.mps import MPS, create_initial_state  # noqa: E402,F401
from .core.truncate import TruncParams  # noqa: E402,F401
from .dynamics.open_system import LindbladEvolution, OpenSystemEvolution  # noqa: E402,F401
from .dynamics.tdvp import TDVPEvolution, TDVPFloquetEvolution  # noqa: E402,F401
from .dynamics.tebd import CustomFloquet, TEBDEvolution  # noqa: E402,F401
from .models.kicked_ising import KickedIsingModel  # noqa: E402,F401

__all__ = [
    "MPS", "create_initial_state", "TruncParams", "CustomFloquet",
    "TEBDEvolution", "TDVPEvolution", "TDVPFloquetEvolution",
    "LindbladEvolution", "OpenSystemEvolution", "KickedIsingModel",
]

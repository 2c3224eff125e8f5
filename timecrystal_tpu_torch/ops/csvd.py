"""Top-k truncated complex SVD for the two-site update.

Port of ``csvd_topk`` from ``timecrystal_tpu/ops/csvd.py``.  Methods:

  * ``'native'``: ``torch.linalg.svd`` (LAPACK on CPU);
  * ``'jacobi'``: ``ops.jacobi_svd.jacobi_sv`` (the CUDA sweep kernel on a
    CUDA tensor, its torch twin on a CPU tensor) plus top-k slicing;
  * ``'auto'``: ``'native'`` for CPU tensors, ``'jacobi'`` for CUDA tensors.

The JAX package's other methods are not ported yet and raise
``NotImplementedError`` naming the ROADMAP item: nothing reroutes silently.
The Gram/eigh methods exist there only because the TPU backend has no SVD.
"""

from __future__ import annotations

import torch

from .jacobi_svd import jacobi_sv

_PROJECTED = "ROADMAP.md queue 1, 'jacobi_proj / jacobi_core'"
_V_KERNEL = "ROADMAP.md queue 1, 'Kernel 2: _jacobi_sweep_v_kernel'"
_ALIASES = "ROADMAP.md queue 1, 'csvd and the Gram/eigh method names'"
_NOT_PORTED = {
    "jacobi_full": _V_KERNEL,
    "jacobi_proj": _PROJECTED,
    "jacobi_core": _PROJECTED,
    "jacobi_core_fast": _PROJECTED,
    "gram_eigh": _ALIASES,
    "gram_eigh_gs": _ALIASES,
}


def csvd_topk(theta: torch.Tensor, k: int, method: str = "auto",
              jacobi_sweeps: int = 0):
    """Top-k truncated SVD of theta [..., m, n]: (S [..., k], Vh [..., k, n],
    disc [...]) with disc the discarded weight sum(S[k:]^2).
    ``jacobi_sweeps``: sweep cap of the Jacobi method, 0 = dtype default."""
    m, n = theta.shape[-2:]
    if method == "auto":
        method = "native" if theta.device.type == "cpu" else "jacobi"
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"csvd_topk method {method!r} is not ported yet: "
            f"{_NOT_PORTED[method]}")
    if method == "jacobi":
        if m != n or n % 2:
            raise NotImplementedError(
                "rectangular / odd-width panels need the V-accumulating "
                f"kernel: {_NOT_PORTED['jacobi_full']}")
        S, V = jacobi_sv(theta, max_sweeps=jacobi_sweeps or None, polish=k)
        Vh = V.mH
    elif method == "native":
        _, S, Vh = torch.linalg.svd(theta, full_matrices=False)
    else:
        raise ValueError(f"unknown csvd_topk method: {method}")
    disc = (S[..., k:] ** 2).sum(-1)
    return S[..., :k], Vh[..., :k, :], disc

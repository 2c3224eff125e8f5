"""Complex SVD and Hermitian eigendecomposition for the MPS updates.

Port of ``timecrystal_tpu/ops/csvd.py``.  SVD methods:

  * ``'native'``: ``torch.linalg.svd`` (LAPACK on CPU);
  * ``'jacobi'``: the one-sided Jacobi of ``ops.jacobi_svd`` -- on a CUDA
    tensor the CUDA sweep kernels, on a CPU tensor their torch twins.
    ``csvd_topk`` takes the V-free ``jacobi_sv`` for square even-width
    panels and the V-accumulating ``jacobi_svd`` for the rest; ``csvd``
    always takes ``jacobi_svd`` (it returns U);
  * ``'jacobi_full'`` (``csvd_topk`` only): ``jacobi_svd`` for every panel;
  * ``'jacobi_proj'``, ``'jacobi_core'``, ``'jacobi_core_fast'``
    (``csvd_topk`` only): the projected top-k SVDs of the saturated-chi
    steady state (``jacobi_proj`` / ``jacobi_core``, kernel 1 on k-column
    panels or the k x k core) with the JAX package's tuned configurations;
    an odd k or k > min(m, n) takes ``'jacobi'``, as in the JAX package;
  * ``'auto'``: ``'native'`` for CPU tensors, ``'jacobi'`` otherwise.  The
    JAX package's ``'auto'`` picks a Gram/eigh SVD on the TPU only because
    that backend has no SVD.
  * ``'gram_eigh'``, ``'gram_eigh_gs'``: aliases of what ``'auto'`` resolves
    to on the tensor's device (``'native'`` on the CPU, ``'jacobi'`` --
    kernel 1 or 2 -- on CUDA).  The JAX package's Gram/eigh SVDs exist only
    because the TPU backend has no complex SVD; an alias never reaches
    cuSOLVER, whose junk small sigmas would feed the chi-staged escalation
    (``dynamics.tebd._stage_decision``).  In ``heigh`` both are aliases of
    ``'native'``, its only method.

``heigh`` / ``hermitian_invsqrt`` / ``cqr_tall`` (TDVP's canonical splits)
use ``torch.linalg.eigh`` on every device; the JAX package's real-embedded
eigh exists only because the TPU has no complex dtype.
"""

from __future__ import annotations

import torch

from .jacobi_svd import jacobi_core, jacobi_proj, jacobi_sv, jacobi_svd

GRAM_EIGH_ALIASES = frozenset({"gram_eigh", "gram_eigh_gs"})
# The matmul precision of jacobi_core_fast's quintic polar stage in
# complex64 (complex128 keeps 'highest').  The JAX package runs it as
# single-pass bf16 on the TPU.  On the H100 cuBLAS runs complex64 matmuls on
# TF32 tensor cores when allowed: chip_smoke.py times both modes of
# ops.jacobi_svd.QUINTIC_PRECISIONS and gates the one named here with the
# 50-period closed-loop steady check and the dense-spectrum orthonormality
# defect (PERF.md).
FAST_QUINTIC_PRECISION = "tf32"


def _resolve(method: str, x: torch.Tensor) -> str:
    if method == "auto" or method in GRAM_EIGH_ALIASES:
        method = "native" if x.device.type == "cpu" else "jacobi"
    return method


def csvd_topk(theta: torch.Tensor, k: int, method: str = "auto",
              jacobi_sweeps: int = 0):
    """Top-k truncated SVD of theta [..., m, n]: (S [..., k], Vh [..., k, n],
    disc [...]) with disc the discarded weight sum(S[k:]^2) -- for the
    projected methods ||theta||_F^2 - sum S^2, which includes the
    projection leak.  ``jacobi_sweeps``: sweep cap of the Jacobi methods,
    0 = dtype default."""
    m, n = theta.shape[-2:]
    method = _resolve(method, theta)
    sweeps = jacobi_sweeps or None
    if (method in ("jacobi_proj", "jacobi_core", "jacobi_core_fast")
            and (k % 2 or k > min(m, n))):
        method = "jacobi"          # panels the projected SVDs do not take
    if method == "jacobi_proj":
        # the JAX package's tuned configurations: complex128 polish 6 + 6
        # at the default tols; complex64 tol 1e-6 on both panels, polish
        # 4 + 4
        tuned = (dict(polish_b_iters=6, polish_iters=6)
                 if theta.dtype == torch.complex128 else
                 dict(tol=1e-6, tol_b=1e-6, polish_b_iters=4, polish_iters=4))
        S, V, disc = jacobi_proj(theta, k, max_sweeps=sweeps, polish=k, **tuned)
        return S, V.mH, disc
    if method in ("jacobi_core", "jacobi_core_fast"):
        # jacobi_core_fast (complex64 only): the fixed 4-iteration polish and
        # the quintic at FAST_QUINTIC_PRECISION
        tuned = (dict(quintic_precision=FAST_QUINTIC_PRECISION, polish_iters=4,
                      polish_adaptive=False)
                 if method == "jacobi_core_fast"
                 and theta.dtype != torch.complex128 else {})
        S, V, disc = jacobi_core(theta, k, max_sweeps=sweeps, **tuned)
        return S, V.mH, disc
    if method == "jacobi" and m == n and n % 2 == 0:
        S, V = jacobi_sv(theta, max_sweeps=sweeps, polish=k)
        Vh = V.mH
    elif method in ("jacobi", "jacobi_full"):
        _, S, Vh = jacobi_svd(theta, n_sweeps=sweeps)
    elif method == "native":
        _, S, Vh = torch.linalg.svd(theta, full_matrices=False)
    else:
        raise ValueError(f"unknown csvd_topk method: {method}")
    disc = (S[..., k:] ** 2).sum(-1)
    return S[..., :k], Vh[..., :k, :], disc


def csvd(theta: torch.Tensor, method: str = "auto"):
    """Batched complex SVD: theta [..., m, n] -> (U, S, Vh), S descending.

    'native' returns LAPACK's thin shapes (U [..., m, min], Vh [..., min, n]);
    'jacobi' returns ``jacobi_svd``'s (U [..., m, n], Vh [..., n, n]), as the
    JAX package does."""
    method = _resolve(method, theta)
    if method == "jacobi":
        return jacobi_svd(theta)
    if method == "native":
        return torch.linalg.svd(theta, full_matrices=False)
    raise ValueError(f"unknown csvd method: {method}")


def heigh(G: torch.Tensor, method: str = "auto"):
    """Complex Hermitian eigendecomposition G = V diag(w) V^H, w ascending,
    batched over leading axes."""
    if method == "auto" or method in GRAM_EIGH_ALIASES:
        method = "native"
    if method != "native":
        raise ValueError(f"unknown heigh method: {method}")
    return torch.linalg.eigh(G)


def hermitian_invsqrt(G: torch.Tensor, rel_eps: float | None = None,
                      method: str = "auto"):
    """(G^{-1/2}, G^{1/2}) for Hermitian PSD G [n, n] with padded-rank
    masking: eigenvalues below rel_eps * w_max are exact zeros (their
    directions stay zero, the padded-MPS convention).  Default rel_eps =
    16 * machine eps."""
    w, V = heigh(G, method=method)
    if rel_eps is None:
        rel_eps = 16.0 * torch.finfo(w.dtype).eps
    wmax = w.max() + 1e-300
    ok = w > rel_eps * wmax
    zero = torch.zeros_like(w)
    inv = torch.where(ok, 1.0 / torch.sqrt(torch.clamp(w, min=1e-300)), zero)
    sq = torch.where(ok, torch.sqrt(torch.clamp(w, min=0.0)), zero)
    Vh = V.mH
    return (V * inv.to(V.dtype)) @ Vh, (V * sq.to(V.dtype)) @ Vh


def cqr_tall(M: torch.Tensor, method: str = "auto"):
    """Isometric factorization M = Q R for tall M [m, n] (m >= n): Q^H Q = I
    on the numerical range, R [n, n] Hermitian PSD (not triangular -- TDVP
    needs some isometric split, and the JAX package's Hermitian square root
    is kept so both packages split alike).  Cholesky-QR via eigh,
    G = M^H M, Q = M G^{-1/2}, R = G^{1/2}, plus one refinement pass.
    Rank-deficient directions give zero columns of Q and zero rows/columns
    of R."""
    inv_sqrt, sqrt = hermitian_invsqrt(M.mH @ M, method=method)
    Q = M @ inv_sqrt
    inv2, sq2 = hermitian_invsqrt(Q.mH @ Q, method=method)
    return Q @ inv2, sq2 @ sqrt

"""One-sided complex Jacobi (S, V) for the TEBD two-site update.

Port of the ``jacobi_sv`` half of ``timecrystal_tpu/ops/pallas/jacobi_svd.py``.
The sweep -- the one Pallas kernel on the main path, ``_jacobi_sweep_kernel``
-- is the hand-written CUDA kernel ``csrc/jacobi_sweep.cu``; beside it lives
its plain torch twin ``_jacobi_sweep_torch``, the same sweep vectorized over
the pairs with the Pallas body's slice-and-concatenate tournament cycle.

Dispatch rule (``_sweep``): a CPU tensor runs the twin, a CUDA tensor
launches the kernel (or raises); there is no fallback between the two.
``KERNEL_LAUNCHES`` counts kernel launches and nothing else.

Everything around the sweep -- the sweep-until-converged loop, the sigma
sort and 64*eps floor, column normalization and the Newton-Schulz polish --
is plain torch, as it is plain XLA outside the Pallas kernel in JAX.

Layout: the JAX code orthogonalizes the columns of A = theta^H.  Column j of
A is row j of X = conj(theta), so the port works on X [B, n, m] row-major:
every column is a contiguous row (what the kernel wants), and no transpose
copy is made.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

# sweep-kernel launches (one per sweep on a CUDA tensor); the twin never counts
KERNEL_LAUNCHES = 0
# jacobi_sv calls that ran the sweep loop on a CUDA tensor
CUDA_SV_CALLS = 0

_SCHEDULES: dict = {}


def _pair_rotation(a, b, c):
    """Complex Jacobi rotation for column pairs with norms a, b (real) and
    overlap c = <L, R> (complex): returns (cs, w1, w2, t, |c|) for
    u' = cs u - w1 v ; v' = w2 u + cs v with w1 = sn conj(ph), w2 = sn ph.

    The sign at tau = 0 is taken POSITIVE: equal-norm parallel pairs need
    the full 45-degree rotation, and ``torch.sign(0) == 0`` would skip it.
    |c| is guarded at 1e-30 (representable in float32)."""
    absc = torch.sqrt(c.real * c.real + c.imag * c.imag)
    safe = absc > 1e-30
    tau = torch.where(safe, (b - a) / torch.clamp(2 * absc, min=1e-30),
                      torch.zeros_like(absc))
    sgn = torch.where(tau >= 0, 1.0, -1.0).to(tau.dtype)
    t = sgn / (torch.abs(tau) + torch.sqrt(1 + tau * tau))
    t = torch.where(safe, t, torch.zeros_like(t))
    cs = 1.0 / torch.sqrt(1 + t * t)
    sn = cs * t
    ph = torch.where(safe, c / torch.clamp(absc, min=1e-30),
                     torch.ones_like(c))
    return cs, sn * ph.conj(), sn * ph, t, absc


def _cycle(L, R, dim: int):
    """The tournament (circle) step of the Pallas body: with k = L.size(dim),
    new L = [L0, R0, L1..L_{k-2}], new R = [R1..R_{k-1}, L_{k-1}].  One
    element stays, the other n-1 rotate, so n-1 steps return to the start."""
    k = L.shape[dim]
    newL = torch.cat([L.narrow(dim, 0, 1), R.narrow(dim, 0, 1),
                      L.narrow(dim, 1, k - 2)], dim)
    newR = torch.cat([R.narrow(dim, 1, k - 1), L.narrow(dim, k - 1, 1)], dim)
    return newL, newR


def tournament_schedule(n: int) -> np.ndarray:
    """int32 [n-1, n]: the row sitting in each slot (0..k-1 = L, k..n-1 = R)
    at each step of a sweep, from replaying ``_cycle`` on row indices."""
    k = n // 2
    cur = torch.arange(n)
    rows = []
    for _ in range(n - 1):
        rows.append(cur.clone())
        L, R = _cycle(cur[:k], cur[k:], 0)
        cur = torch.cat([L, R])
    if not torch.equal(cur, torch.arange(n)):
        raise AssertionError("tournament cycle did not return to the start")
    return torch.stack(rows).numpy().astype(np.int32)


def _jacobi_sweep_torch(X: torch.Tensor):
    """Plain torch twin of the sweep kernel: ONE tournament sweep over the
    rows of X [B, n, m] (n even, n >= 4).  Returns (rotated X, measure [B])
    with measure = max over the sweep's pairs of |c|^2 / maxn2^2.

    As in the kernel, rows are stored in X's precision and all arithmetic
    is done in float64 (complex128), each rotated value rounded once."""
    B, n, m = X.shape
    k = n // 2
    dtype = X.dtype
    X = X.to(torch.complex128)
    nrm = (X.real * X.real + X.imag * X.imag).sum(-1)          # [B, n]
    maxn2 = nrm.amax(-1, keepdim=True)
    inv_maxn2_sq = 1.0 / torch.clamp(maxn2 * maxn2, min=1e-30)
    a, b = nrm[:, :k], nrm[:, k:]
    L, R = X[:, :k], X[:, k:]
    measure = torch.zeros(B, dtype=torch.float64, device=X.device)
    for _ in range(n - 1):
        c = torch.linalg.vecdot(L, R)                           # <L, R>, [B, k]
        abs2c = c.real * c.real + c.imag * c.imag
        measure = torch.maximum(measure, (abs2c * inv_maxn2_sq).amax(-1))
        cs, w1, w2, t, absc = _pair_rotation(a, b, c)
        cs, w1, w2 = cs[..., None], w1[..., None], w2[..., None]
        # round to the storage precision after every step, as the kernel does
        XL = (cs * L - w1 * R).to(dtype).to(torch.complex128)
        XR = (w2 * L + cs * R).to(dtype).to(torch.complex128)
        L, R = _cycle(XL, XR, 1)
        a, b = _cycle(a - t * absc, b + t * absc, 1)
    return torch.cat([L, R], 1).to(dtype), measure


def _schedule_on(n: int, device: torch.device) -> torch.Tensor:
    key = (n, str(device))
    if key not in _SCHEDULES:
        _SCHEDULES[key] = torch.as_tensor(tournament_schedule(n),
                                          device=device).contiguous()
    return _SCHEDULES[key]


def _jacobi_sweep_cuda(X: torch.Tensor):
    """Launch the CUDA sweep kernel on X [B, n, m] (complex64/128, CUDA,
    contiguous), rotating X IN PLACE.  Returns (X, measure [B] float64).
    One launch is one sweep, enqueued on the current stream."""
    global KERNEL_LAUNCHES
    from .cuda_build import load_kernel_library

    if X.device.type != "cuda":
        raise ValueError(f"CUDA sweep needs a CUDA tensor, got {X.device}")
    if X.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"CUDA sweep takes complex64/complex128, got {X.dtype}")
    if X.dim() != 3 or not X.is_contiguous() or X.is_conj():
        raise ValueError("CUDA sweep needs a contiguous, conj-resolved "
                         "[B, n, m] tensor")
    B, n, m = X.shape
    if n % 2 or n < 4:
        raise ValueError(f"CUDA sweep needs even n >= 4, got n={n}")
    lib, _ = load_kernel_library("jacobi_sweep")
    fn = (lib.tct_jacobi_sweep_c64 if X.dtype == torch.complex64
          else lib.tct_jacobi_sweep_c128)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sched = _schedule_on(n, X.device)
    measure = torch.empty(B, dtype=torch.float64, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = fn(X.data_ptr(), sched.data_ptr(), measure.data_ptr(), B, n, m,
                 stream)
    if err != 0:
        raise RuntimeError(f"jacobi_sweep kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return X, measure


def _sweep(X: torch.Tensor):
    """The dispatch rule: twin for CPU tensors, kernel for CUDA tensors."""
    if X.device.type == "cpu":
        return _jacobi_sweep_torch(X)
    return _jacobi_sweep_cuda(X)


def _rotate_single_pair(X: torch.Tensor) -> torch.Tensor:
    """Exact one-rotation Jacobi for a single column pair (n = 2): the
    tournament cycle is undefined for one pair, and one rotation
    orthogonalizes it.  Same rotation convention as the sweep."""
    L, R = X[:, :1], X[:, 1:]
    a = (L.real * L.real + L.imag * L.imag).sum(-1)
    b = (R.real * R.real + R.imag * R.imag).sum(-1)
    c = torch.linalg.vecdot(L, R)
    cs, w1, w2, _, _ = _pair_rotation(a, b, c)
    return torch.cat([cs[..., None] * L - w1[..., None] * R,
                      w2[..., None] * L + cs[..., None] * R], 1)


def _orthogonalize_columns(X: torch.Tensor, max_sweeps: int, tol: float,
                           sweep) -> torch.Tensor:
    """Sweep X [B, n, m] (rows = the columns of A) until every pair overlap
    of a whole sweep is below tol * sigma_max^2, or max_sweeps, running
    ``sweep`` (the dispatcher or the twin) once per sweep.  All
    matrices of the call run the same number of sweeps (the exit reads the
    batch max, as the JAX while_loop does).  Returns rows = left singular
    vectors of A scaled by its singular values (unsorted).

    The exit test reads the measure on the host: one device sync per sweep.
    """
    n = X.shape[1]
    if n % 2:
        raise ValueError("row count must be even for the tournament")
    if n == 2:
        return _rotate_single_pair(X)
    # JAX compares the float32 measure with float32(tol^2)
    threshold = float(np.float32(tol * tol))
    # one fresh contiguous buffer with the conjugation applied: the CUDA
    # kernel rotates it in place
    X = torch.empty(X.shape, dtype=X.dtype, device=X.device).copy_(X)
    for _ in range(max_sweeps):
        X, measure = sweep(X)
        if float(measure.amax().to(torch.float32)) < threshold:
            break
    return X


def _sigma_sort_floor(X: torch.Tensor):
    """Row norms -> descending (stable) sort -> 64*eps*sigma_max resolution
    floor.  Sigma below the floor is rotation noise in this dtype; both the
    sigma and (through the returned inv) the row are zeroed.  The floor
    comes BEFORE normalization.  Returns (S, X_sorted, inv)."""
    S = torch.sqrt((X.real * X.real + X.imag * X.imag).sum(-1))  # [B, n]
    order = torch.argsort(-S, dim=-1, stable=True)
    S = torch.gather(S, -1, order)
    X = torch.gather(X, 1, order[..., None].expand_as(X))
    floor = 64.0 * torch.finfo(S.dtype).eps
    keep = S > floor * S[..., :1]
    S = torch.where(keep, S, torch.zeros_like(S))
    inv = torch.where(keep, 1.0 / torch.clamp(S, min=1e-30),
                      torch.zeros_like(S))
    return S, X, inv


def _ns_polish(V: torch.Tensor, pk: int, iters: int = 12) -> torch.Tensor:
    """Newton-Schulz re-orthonormalization of V's leading pk columns
    (converges to the nearest partial isometry).  The 1/sqrt(2) prescale --
    the float32-rounded constant the JAX code multiplies by -- keeps
    pairwise-parallel columns inside the convergence region."""
    X = V[..., :, :pk] * float(np.float32(1.0 / np.sqrt(2)))
    eye = torch.eye(pk, dtype=V.dtype, device=V.device)
    for _ in range(iters):
        P = X.mH @ X
        X = X @ (1.5 * eye - 0.5 * P)
    return torch.cat([X, V[..., :, pk:]], -1)


def _cols_to_sv(X: torch.Tensor, polish: int):
    """Converged rows X [B, n, m] (= V's columns times sigma) ->
    (S [B, n] descending, V [B, m, n] with normalized columns)."""
    S, X, inv = _sigma_sort_floor(X)
    V = (X * inv[..., None]).transpose(-1, -2)
    if polish:
        V = _ns_polish(V, min(polish, V.shape[-1]))
    return S, V


def _jacobi_sv(theta, max_sweeps, tol, polish, sweep):
    if max_sweeps is None:
        max_sweeps = 24 if theta.dtype == torch.complex128 else 12
    if tol is None:
        # absolute measure: exit once max_pairs |<L,R>| <= tol * sigma_max^2
        tol = 1e-14 if theta.dtype == torch.complex128 else 3e-8
    squeeze = theta.dim() == 2
    if squeeze:
        theta = theta[None]
    lead = theta.shape[:-2]
    m, n = theta.shape[-2:]
    if m != n or n % 2:
        raise ValueError(f"jacobi_sv requires square even-n theta, got {m}x{n}")
    X = theta.reshape(-1, m, n).conj()      # rows of X = columns of theta^H
    S, V = _cols_to_sv(_orthogonalize_columns(X, max_sweeps, tol, sweep),
                       polish)
    S, V = S.reshape(*lead, n), V.reshape(*lead, n, n)
    if squeeze:
        S, V = S[0], V[0]
    return S, V


def jacobi_sv(theta: torch.Tensor, max_sweeps: int | None = None,
              tol: float | None = None, polish: int = 0):
    """(S, V) of square theta [..., n, n] (n even) -- the TEBD-update path.

    SVD(theta^H) = V S U^H, so orthogonalizing the columns of A = theta^H
    yields V directly as the normalized rotated columns (no V accumulator).
    S descending; V's columns for sigma ~ 0 carry direction noise (masked
    by truncation downstream).  Defaults: 12 sweeps / tol 3e-8 for
    complex64, 24 / 1e-14 for complex128.  A CUDA tensor runs the CUDA
    sweep kernel, a CPU tensor its torch twin.
    """
    global CUDA_SV_CALLS
    if theta.device.type == "cuda" and theta.shape[-1] > 2:
        CUDA_SV_CALLS += 1
    return _jacobi_sv(theta, max_sweeps, tol, polish, _sweep)


def jacobi_sv_plain(theta: torch.Tensor, max_sweeps: int | None = None,
                    tol: float | None = None, polish: int = 0):
    """``jacobi_sv`` through the torch twin on any device: the plain
    version the CUDA kernel is held against."""
    return _jacobi_sv(theta, max_sweeps, tol, polish, _jacobi_sweep_torch)

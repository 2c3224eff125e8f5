"""One-sided complex Jacobi SVD: (S, V) for the TEBD two-site update and
the full (U, S, Vh).

Port of ``timecrystal_tpu/ops/pallas/jacobi_svd.py``'s ``jacobi_sv`` and
``jacobi_svd``.  Both Pallas sweep kernels are hand-written CUDA kernels in
``csrc/jacobi_sweep.cu``: ``_jacobi_sweep_kernel`` (V-free, kernel 1) and
``_jacobi_sweep_v_kernel`` (also rotates the accumulator V, kernel 2).
Beside them lives their plain torch twin (``_jacobi_sweep_torch``,
``_jacobi_sweep_v_torch``), the same sweep vectorized over the pairs with
the Pallas body's slice-and-concatenate tournament cycle.

Dispatch rule: a CPU tensor runs the twin, any other tensor goes to a CUDA
wrapper, which launches a kernel or raises; there is no fallback between
them, nor between two kernels.  The launch counters count kernel launches
and nothing else.

``jacobi_sv`` (``_sweep_loop``) has two kernel-1 variants, picked by shape
(``_sv_variant``): a matrix that fits one SM's shared memory
(``_sv_smem_fits``: complex64 up to n = 168, complex128 up to n = 120 -- the
TEBD window) runs the shared-memory variant, any other the cluster variant
(a cluster of CTAs per matrix -- the n = 512 leg).  Both take the exit rule
on the device: the host enqueues ``max_sweeps`` launches and reads nothing;
each launch first reads the previous one's batch-max measure and returns
at once after the exit (``_device_sweep_loop``).  The sweeps run are added
into ``sweep_counter(device)``.  The shared-memory variant skips the pairs
with a zero row and the 8-column chunks zero in every row, which leaves the
result as it was; it adds the pair-steps it ran on two live rows and the
pair-steps scheduled into ``pair_step_counter(device)``.

``jacobi_proj`` / ``jacobi_core`` (the saturated-chi steady leg's top-k
SVDs) project theta onto k-column panels with matmuls and orthogonalize the
panels -- or the k x k core -- with the same ``_sweep_loop``: on a CUDA
tensor kernel 1 with its device exit, on a CPU tensor the twin.  Their
matmul stages (``_poly_polar``, the Newton-Schulz polishes) are plain
torch, as they are plain XLA in JAX.

``jacobi_svd`` has two kernel-2 variants (``_orthogonalize_v``): one matrix
whose X and W fit in one SM's shared memory (``_resident_fits``: complex64
up to n = 120, complex128 up to n = 84 -- TDVP's splits) runs the resident
kernel, which runs the whole sweep loop and its exit test in one launch;
every other CUDA call runs the per-sweep kernel, one launch and one host
read of the exit measure per sweep.  On a CPU tensor both are the twin
loop.

Everything around the sweep -- the sweep-until-converged loop of the
per-sweep kernels, the sigma sort and 64*eps floor, column normalization
and the Newton-Schulz polish -- is plain torch, as it is plain XLA outside
the Pallas kernel in JAX.

Layout: the kernels orthogonalize rows.  ``jacobi_sv`` works on the columns
of A = theta^H: column j of A is row j of X = conj(theta), so X [B, n, m] is
theta's own memory order and no transpose copy is made.  ``jacobi_svd``
works on the columns of theta itself: X = theta^T [B, n, m], and V is kept
as W = V^T [B, n, n] (row j = column j of V), so the same rotation acts on
rows of X and rows of W.  Then U = normalized rows of X, transposed, and
Vh = conj(W).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

# kernel-1 launches on a CUDA tensor, of either variant (max_sweeps per
# jacobi_sv call: the launches after the exit return at once), and of each
# variant; the twin never counts
KERNEL_LAUNCHES = 0
SV_SMEM_LAUNCHES = 0
SV_CLUSTER_LAUNCHES = 0
# jacobi_sv calls that ran the sweep loop on a CUDA tensor
CUDA_SV_CALLS = 0
# host reads of the adaptive Newton-Schulz polish's batch-max defect that
# lies off the CPU (one per iteration, each a device sync)
NS_HOST_READS = 0
# reads of a sweep measure that lies off the CPU by jacobi_sv's host loop
# (each one a device sync); the CUDA path makes none
SV_HOST_READS = 0
# V-accumulating kernel launches on a CUDA tensor, of either kernel: one per
# sweep of the per-sweep kernel, one per jacobi_svd call of the resident
# kernel; the twin never counts
V_KERNEL_LAUNCHES = 0
# launches of the resident kernel alone (one per jacobi_svd call it takes)
V_RESIDENT_LAUNCHES = 0
# jacobi_svd calls that ran the sweep loop on a CUDA tensor
CUDA_SVD_CALLS = 0

# shared memory one block can use on Hopper (sm_90)
SHARED_BYTES_PER_BLOCK = 232448
# rows the shared-memory kernel-1 variant takes: 8 lanes per pair, 672 threads
SMEM_MAX_ROWS = 168

_SCHEDULES: dict = {}
_SWEEPS: dict = {}
_PAIR_STEPS: dict = {}
_RESIDENT_SWEEPS: dict = {}
_CLUSTER_PLANS: dict = {}
_PROJ_BASES: dict = {}


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


def _jacobi_sweep_v_torch(X: torch.Tensor, W: torch.Tensor | None):
    """Plain torch twin of the sweep kernels: ONE tournament sweep over the
    rows of X [B, n, m] (n even, n >= 4), rotating the rows of W [B, n, n]
    (V's columns) alongside when W is given.  Returns (rotated X, rotated W
    or None, measure [B]) with measure = max over the sweep's pairs of
    |c|^2 / maxn2^2.

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
    if W is not None:
        W = W.to(torch.complex128)
        WL, WR = W[:, :k], W[:, k:]
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
        if W is not None:
            VL = (cs * WL - w1 * WR).to(dtype).to(torch.complex128)
            VR = (w2 * WL + cs * WR).to(dtype).to(torch.complex128)
            WL, WR = _cycle(VL, VR, 1)
        a, b = _cycle(a - t * absc, b + t * absc, 1)
    if W is not None:
        W = torch.cat([WL, WR], 1).to(dtype)
    return torch.cat([L, R], 1).to(dtype), W, measure


def _jacobi_sweep_torch(X: torch.Tensor):
    """Plain torch twin of the V-free sweep kernel: (rotated X, measure)."""
    X, _, measure = _jacobi_sweep_v_torch(X, None)
    return X, measure


def _schedule_on(n: int, device: torch.device) -> torch.Tensor:
    key = (n, str(device))
    if key not in _SCHEDULES:
        _SCHEDULES[key] = torch.as_tensor(tournament_schedule(n),
                                          device=device).contiguous()
    return _SCHEDULES[key]


def _check_cuda_rows(X: torch.Tensor, what: str = "CUDA sweep") -> None:
    """What the CUDA sweep kernels take: a contiguous, conj-resolved complex
    [B, n, m] CUDA tensor with even n >= 4."""
    if X.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {X.device}")
    if X.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"{what} takes complex64/complex128, got {X.dtype}")
    if X.dim() != 3 or not X.is_contiguous() or X.is_conj():
        raise ValueError(f"{what} needs a contiguous, conj-resolved "
                         "[B, n, m] tensor")
    n = X.shape[1]
    if n % 2 or n < 4:
        raise ValueError(f"{what} needs even n >= 4, got n={n}")


def _sv_smem_fits(n: int, m: int, itemsize: int) -> bool:
    """Kernel 1's shared-memory fit rule, for X [B, n, m] of complex items of
    ``itemsize`` bytes: one matrix [n, m], its norms [n] and 32 doubles of
    reduction scratch in one block's shared memory (complex64 up to
    n = 168, complex128 up to n = 120 when square), and 8 lanes for each of
    the n/2 pairs within the kernel's 672 threads (n up to 168)."""
    return (n <= SMEM_MAX_ROWS
            and n * m * itemsize + (n + 32) * 8 <= SHARED_BYTES_PER_BLOCK)


def _sv_variant(B: int, n: int, m: int, itemsize: int) -> str:
    """The kernel-1 variant that takes X [B, n, m]: 'smem' if a matrix fits
    one SM's shared memory, else 'cluster'."""
    return "smem" if _sv_smem_fits(n, m, itemsize) else "cluster"


def _device_counter(store: dict, device, shape=()) -> torch.Tensor:
    key = str(torch.device(device))
    if key not in store:
        store[key] = torch.zeros(shape, dtype=torch.int64, device=device)
    return store[key]


def sweep_counter(device) -> torch.Tensor:
    """The int64 counter on ``device`` (a CUDA device with its index) to
    which every kernel-1 launch that runs its sweep adds one on the device,
    so that counting reads nothing on the host.  Reset it with
    ``zero_()``."""
    return _device_counter(_SWEEPS, device)


def pair_step_counter(device) -> torch.Tensor:
    """The int64 [2] counter on ``device`` (a CUDA device with its index)
    into which every sweep of the shared-memory variant adds, on the
    device, the pair-steps it ran on two live rows and the pair-steps its
    tournament scheduled (B (n-1) n/2): 1 - live / scheduled is the share
    of the pair work it skipped.  Reset it with ``zero_()``."""
    return _device_counter(_PAIR_STEPS, device, (2,))


def cluster_plan(B: int, n: int, m: int, dtype, device) -> tuple:
    """(cluster size, co-resident clusters) of the cluster variant for
    X [B, n, m]: the largest size up to 8 CTAs per matrix for which the
    card keeps all B clusters resident at once (else 1), and the card's
    count of co-resident clusters of that size
    (cudaOccupancyMaxActiveClusters).  Cached per shape and device."""
    from .cuda_build import load_kernel_library

    key = (B, n, m, dtype, str(torch.device(device)))
    if key not in _CLUSTER_PLANS:
        lib, _ = load_kernel_library("jacobi_sweep")
        fn = (lib.tct_jacobi_sweep_cluster_plan_c64 if dtype == torch.complex64
              else lib.tct_jacobi_sweep_cluster_plan_c128)
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
        fn.restype = ctypes.c_int
        size, active = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            err = fn(B, n, m, ctypes.byref(size), ctypes.byref(active))
        if err != 0:
            raise RuntimeError(f"jacobi_sweep cluster plan failed: CUDA error {err}")
        _CLUSTER_PLANS[key] = (size.value, active.value)
    return _CLUSTER_PLANS[key]


def smem_occupancy(n: int, m: int, dtype, device) -> int:
    """CTAs of the shared-memory variant one SM holds at once for an [n, m]
    matrix (cudaOccupancyMaxActiveBlocksPerMultiprocessor): a batch above
    the card's SM count times this runs in more than one wave."""
    from .cuda_build import load_kernel_library

    lib, _ = load_kernel_library("jacobi_sweep")
    fn = (lib.tct_jacobi_sweep_smem_occupancy_c64 if dtype == torch.complex64
          else lib.tct_jacobi_sweep_smem_occupancy_c128)
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = fn(n, m, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"jacobi_sweep occupancy query failed: CUDA error {err}")
    return blocks.value


def _launch_sweep_cuda(X: torch.Tensor, prev, measure: torch.Tensor,
                       done: torch.Tensor, threshold: float,
                       variant: str) -> None:
    """Enqueue one kernel-1 launch of ``variant`` ('smem' or 'cluster') on
    X [B, n, m] (complex64/128, CUDA, contiguous, 16-byte aligned), rotating
    X IN PLACE by one sweep unless the exit test skips it.  ``prev`` [B]
    float64 holds the measures of the loop's previous launch (None for its
    first: no exit test); ``measure`` [B] float64 receives this sweep's;
    ``done`` is the loop's int32 exit flag (0 before its first launch);
    ``threshold`` the float32 exit threshold."""
    global KERNEL_LAUNCHES, SV_SMEM_LAUNCHES, SV_CLUSTER_LAUNCHES
    from .cuda_build import load_kernel_library

    _check_cuda_rows(X)
    B, n, m = X.shape
    if X.data_ptr() % 16:
        raise ValueError("CUDA sweep needs a 16-byte aligned X")
    lib, _ = load_kernel_library("jacobi_sweep")
    c64 = X.dtype == torch.complex64
    if variant == "smem":
        if not _sv_smem_fits(n, m, X.element_size()):
            raise ValueError(f"the shared-memory sweep does not take {X.dtype} "
                             f"{list(X.shape)}")
        fn = lib.tct_jacobi_sweep_c64 if c64 else lib.tct_jacobi_sweep_c128
        # the live pairs of every step, which the sweep lists for itself
        pairs = torch.empty((B, n - 1, n // 2), dtype=torch.int16, device=X.device)
        scratch = [pairs.data_ptr(), pair_step_counter(X.device).data_ptr()]
        extra = []
    elif variant == "cluster":
        fn = (lib.tct_jacobi_sweep_cluster_c64 if c64
              else lib.tct_jacobi_sweep_cluster_c128)
        scratch = []
        extra = [cluster_plan(B, n, m, X.dtype, X.device)[0]]
    else:
        raise ValueError(f"unknown kernel-1 variant {variant!r}")
    fn.argtypes = ([ctypes.c_void_p] * (6 + len(scratch)) + [ctypes.c_int] * 3
                   + [ctypes.c_float] + [ctypes.c_int] * len(extra)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    sched = _schedule_on(n, X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = fn(X.data_ptr(), sched.data_ptr(),
                 None if prev is None else prev.data_ptr(), measure.data_ptr(),
                 done.data_ptr(), sweep_counter(X.device).data_ptr(), *scratch,
                 B, n, m, threshold, *extra, stream)
    if err != 0:
        raise RuntimeError(f"jacobi_sweep ({variant}) kernel launch failed: "
                           f"CUDA error {err}")
    KERNEL_LAUNCHES += 1
    if variant == "smem":
        SV_SMEM_LAUNCHES += 1
    else:
        SV_CLUSTER_LAUNCHES += 1


def _jacobi_sweep_cuda(X: torch.Tensor, variant: str | None = None):
    """One kernel-1 sweep on X [B, n, m] (complex64/128, CUDA, contiguous),
    rotating X IN PLACE, on ``variant`` (default: the one the shape picks).
    Returns (X, measure [B] float64), enqueued on the current stream."""
    _check_cuda_rows(X)
    B, n, m = X.shape
    measure = torch.empty(B, dtype=torch.float64, device=X.device)
    done = torch.zeros((), dtype=torch.int32, device=X.device)
    _launch_sweep_cuda(X, None, measure, done, 0.0,
                       variant or _sv_variant(B, n, m, X.element_size()))
    return X, measure


def _jacobi_sweep_v_cuda(X: torch.Tensor, W: torch.Tensor):
    """Launch the V-accumulating CUDA sweep kernel on X [B, n, m] and
    W [B, n, n] (same complex dtype, CUDA, contiguous), rotating both IN
    PLACE.  Returns (X, W, measure [B] float64).  One launch is one sweep,
    enqueued on the current stream."""
    global V_KERNEL_LAUNCHES
    from .cuda_build import load_kernel_library

    _check_cuda_rows(X)
    B, n, m = X.shape
    if (W.device != X.device or W.dtype != X.dtype or W.shape != (B, n, n)
            or not W.is_contiguous() or W.is_conj()):
        raise ValueError(f"CUDA V sweep needs W [{B}, {n}, {n}] contiguous, "
                         f"conj-resolved, {X.dtype} on {X.device}")
    lib, _ = load_kernel_library("jacobi_sweep")
    fn = (lib.tct_jacobi_sweep_v_c64 if X.dtype == torch.complex64
          else lib.tct_jacobi_sweep_v_c128)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sched = _schedule_on(n, X.device)
    measure = torch.empty(B, dtype=torch.float64, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = fn(X.data_ptr(), W.data_ptr(), sched.data_ptr(),
                 measure.data_ptr(), B, n, m, stream)
    if err != 0:
        raise RuntimeError(f"jacobi_sweep_v kernel launch failed: CUDA error {err}")
    V_KERNEL_LAUNCHES += 1
    return X, W, measure


def _resident_fits(B: int, n: int, m: int, itemsize: int) -> bool:
    """The resident kernel's fit rule, for X [B, n, m] of complex items of
    ``itemsize`` bytes (n already padded even): one matrix (one CTA holds it,
    and the exit reads the batch max), with X [n, m] and W [n, n], the norms
    [n] and 32 doubles of reduction scratch in one block's shared memory."""
    return (B == 1 and n * (m + n) * itemsize + (n + 32) * 8
            <= SHARED_BYTES_PER_BLOCK)


def resident_sweep_counter(device) -> torch.Tensor:
    """The int64 counter on ``device`` (a CUDA device with its index) into
    which the resident kernel's wrapper adds each call's sweep count on the
    device, so that counting reads nothing on the host.  Reset it with
    ``zero_()``."""
    return _device_counter(_RESIDENT_SWEEPS, device)


def _exit_threshold(tol: float) -> float:
    """The sweep loop's exit threshold: JAX compares the float32 measure with
    float32(tol^2)."""
    return float(np.float32(tol * tol))


def _jacobi_svd_resident_cuda(X: torch.Tensor, n_sweeps: int, tol: float):
    """Launch the resident CUDA kernel on X [1, n, m] (complex64/128, CUDA,
    contiguous, within ``_resident_fits``): ONE launch runs the whole sweep
    loop of ``_orthogonalize_columns_v`` -- W = I, sweeps until a sweep's
    measure is below float32(tol^2) or ``n_sweeps`` -- rotating X IN PLACE.
    Returns (X, W).  Nothing is read on the host: the sweeps run are added
    into ``resident_sweep_counter(X.device)`` on the device."""
    global V_KERNEL_LAUNCHES, V_RESIDENT_LAUNCHES
    from .cuda_build import load_kernel_library

    what = "CUDA resident sweep loop"
    _check_cuda_rows(X, what)
    B, n, m = X.shape
    if not _resident_fits(B, n, m, X.element_size()):
        raise ValueError(f"{what} takes one matrix whose X and W fit in "
                         f"{SHARED_BYTES_PER_BLOCK} bytes of shared memory, "
                         f"got {X.dtype} {list(X.shape)}")
    if X.data_ptr() % 16:
        raise ValueError(f"{what} needs a 16-byte aligned X")
    lib, _ = load_kernel_library("jacobi_sweep")
    fn = (lib.tct_jacobi_svd_resident_c64 if X.dtype == torch.complex64
          else lib.tct_jacobi_svd_resident_c128)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    sched = _schedule_on(n, X.device)
    W = torch.empty((B, n, n), dtype=X.dtype, device=X.device)
    sweeps = torch.empty((), dtype=torch.int32, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = fn(X.data_ptr(), W.data_ptr(), sched.data_ptr(), sweeps.data_ptr(),
                 n, m, n_sweeps, _exit_threshold(tol), stream)
    if err != 0:
        raise RuntimeError(f"jacobi_svd_resident kernel launch failed: CUDA "
                           f"error {err}")
    V_KERNEL_LAUNCHES += 1
    V_RESIDENT_LAUNCHES += 1
    resident_sweep_counter(X.device).add_(sweeps)
    return X, W


def _sweep_v(X: torch.Tensor, W: torch.Tensor):
    """The dispatch rule of the V-accumulating sweep: twin for CPU tensors,
    the per-sweep kernel for any other."""
    if X.device.type == "cpu":
        return _jacobi_sweep_v_torch(X, W)
    return _jacobi_sweep_v_cuda(X, W)


def _rotate_single_pair(X: torch.Tensor):
    """Exact one-rotation Jacobi for a single column pair (n = 2): the
    tournament cycle is undefined for one pair, and one rotation
    orthogonalizes it.  Same rotation convention as the sweep, computed in
    X's dtype as the JAX package does.  Returns (X', W) with W the rotation
    in the V-as-rows layout: V = [[cs, w2], [-w1, cs]], W = V^T."""
    L, R = X[:, :1], X[:, 1:]
    a = (L.real * L.real + L.imag * L.imag).sum(-1)
    b = (R.real * R.real + R.imag * R.imag).sum(-1)
    c = torch.linalg.vecdot(L, R)
    cs, w1, w2, _, _ = _pair_rotation(a, b, c)
    Xr = torch.cat([cs[..., None] * L - w1[..., None] * R,
                    w2[..., None] * L + cs[..., None] * R], 1)
    cs = cs.to(X.dtype)
    W = torch.stack([torch.cat([cs, -w1], -1), torch.cat([w2, cs], -1)], -2)
    return Xr, W


def _host_sweep_loop(X: torch.Tensor, max_sweeps: int, threshold: float,
                     sweep) -> torch.Tensor:
    """The sweep loop on the host: ``sweep(X) -> (X, measure)`` once per
    sweep, stopping after the first sweep whose batch-max measure, rounded
    to float32, is below ``threshold`` (the JAX while_loop's rule), or at
    ``max_sweeps``.  Each test reads the measure: a device sync when it lies
    off the CPU (counted in ``SV_HOST_READS``)."""
    global SV_HOST_READS
    for _ in range(max_sweeps):
        X, measure = sweep(X)
        if measure.device.type != "cpu":
            SV_HOST_READS += 1
        if float(measure.amax().to(torch.float32)) < threshold:
            break
    return X


def _device_sweep_loop(X: torch.Tensor, max_sweeps: int, threshold: float,
                       launch) -> torch.Tensor:
    """The same loop with its exit on the device: ``max_sweeps`` calls of
    ``launch(X, prev, measure, done, threshold)``, each handed the previous
    call's measures (None for the first), a fresh [B] float64 row to write
    its own into, and the loop's int32 ``done`` flag.  A launch that finds
    ``done`` set, or the previous batch max below ``threshold``, sets
    ``done`` and leaves X alone; so X and the sweeps run are the host
    loop's, and nothing is read on the host."""
    measures = torch.empty((2, X.shape[0]), dtype=torch.float64, device=X.device)
    done = torch.zeros((), dtype=torch.int32, device=X.device)
    for s in range(max_sweeps):
        launch(X, measures[(s - 1) % 2] if s else None, measures[s % 2], done,
               threshold)
    return X


def _sweep_loop(X: torch.Tensor, max_sweeps: int, threshold: float):
    """The dispatch rule of ``jacobi_sv``'s sweep loop: a CPU tensor runs the
    twin on the host; any other tensor runs the kernel-1 variant its shape
    picks, with the exit on the device."""
    if X.device.type == "cpu":
        return _host_sweep_loop(X, max_sweeps, threshold, _jacobi_sweep_torch)
    B, n, m = X.shape
    return _device_sweep_loop(X, max_sweeps, threshold, functools.partial(
        _launch_sweep_cuda, variant=_sv_variant(B, n, m, X.element_size())))


_plain_sweep_loop = functools.partial(_host_sweep_loop, sweep=_jacobi_sweep_torch)


def _orthogonalize_columns(X: torch.Tensor, max_sweeps: int, tol: float,
                           loop) -> torch.Tensor:
    """Sweep X [B, n, m] (rows = the columns of A) with ``loop`` (X,
    max_sweeps, threshold) until every pair overlap of a whole sweep is
    below tol * sigma_max^2, or max_sweeps.  All matrices of the call run
    the same number of sweeps (the exit reads the batch max, as the JAX
    while_loop does).  Returns rows = left singular vectors of A scaled by
    its singular values (unsorted)."""
    n = X.shape[1]
    if n % 2:
        raise ValueError("row count must be even for the tournament")
    if n == 2:
        return _rotate_single_pair(X)[0]
    # one fresh contiguous buffer with the conjugation applied: the CUDA
    # kernels rotate it in place
    X = torch.empty(X.shape, dtype=X.dtype, device=X.device).copy_(X)
    return loop(X, max_sweeps, _exit_threshold(tol))


def _sigma_sort_floor(X: torch.Tensor, extras=()):
    """Row norms -> descending (stable) sort (the rows of every ``extras``
    tensor co-sorted) -> 64*eps*sigma_max resolution floor.  Sigma below the
    floor is rotation noise in this dtype; both the sigma and (through the
    returned inv) the row are zeroed.  The floor comes BEFORE normalization.
    Returns (S, X_sorted, inv, extras_sorted)."""
    S = torch.sqrt((X.real * X.real + X.imag * X.imag).sum(-1))  # [B, n]
    order = torch.argsort(-S, dim=-1, stable=True)
    S = torch.gather(S, -1, order)
    X = torch.gather(X, 1, order[..., None].expand_as(X))
    extras = tuple(torch.gather(e, 1, order[..., None].expand_as(e))
                   for e in extras)
    floor = 64.0 * torch.finfo(S.dtype).eps
    keep = S > floor * S[..., :1]
    S = torch.where(keep, S, torch.zeros_like(S))
    inv = torch.where(keep, 1.0 / torch.clamp(S, min=1e-30),
                      torch.zeros_like(S))
    return S, X, inv, extras


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
    S, X, inv, _ = _sigma_sort_floor(X)
    V = (X * inv[..., None]).transpose(-1, -2)
    if polish:
        V = _ns_polish(V, min(polish, V.shape[-1]))
    return S, V


def _jacobi_sv(theta, max_sweeps, tol, polish, loop):
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
    S, V = _cols_to_sv(_orthogonalize_columns(X, max_sweeps, tol, loop),
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
    complex64, 24 / 1e-14 for complex128.  A CUDA tensor runs a kernel-1
    variant with the exit on the device (``_sweep_loop``), a CPU tensor the
    torch twin.
    """
    global CUDA_SV_CALLS
    if theta.device.type == "cuda" and theta.shape[-1] > 2:
        CUDA_SV_CALLS += 1
    return _jacobi_sv(theta, max_sweeps, tol, polish, _sweep_loop)


def jacobi_sv_plain(theta: torch.Tensor, max_sweeps: int | None = None,
                    tol: float | None = None, polish: int = 0):
    """``jacobi_sv`` through the torch twin and the host loop on any device:
    the plain version the CUDA kernels are held against."""
    return _jacobi_sv(theta, max_sweeps, tol, polish, _plain_sweep_loop)


def _fixed_projection_basis(n: int, k: int, dtype, device) -> torch.Tensor:
    """Deterministic orthonormal basis Q0 [n, k] of the projected SVDs: the
    JAX package's constant bit for bit (NumPy ``default_rng(0x7C0FFEE)``,
    a complex Gaussian [n, k], ``np.linalg.qr``, each part rounded to the
    working precision), cached per (n, k, dtype, device) on the device."""
    key = (n, k, dtype, str(torch.device(device)))
    if key not in _PROJ_BASES:
        rng = np.random.default_rng(0x7C0FFEE)
        Q, _ = np.linalg.qr(rng.standard_normal((n, k))
                            + 1j * rng.standard_normal((n, k)))
        _PROJ_BASES[key] = torch.as_tensor(Q).to(dtype=dtype, device=device)
    return _PROJ_BASES[key]


def _ns_polish_adaptive(V: torch.Tensor, pk: int, max_iters: int,
                        tol: float) -> torch.Tensor:
    """``_ns_polish`` of V's leading pk columns with the JAX while_loop's
    exit: after each iteration whose batch-max defect (of the X it started
    from) is below float(tol) in V's precision, or at ``max_iters``.

    The defect is NULL-SAFE: max(off-diagonal |Re| + |Im| of X^H X,
    4 |p_ii (1 - p_ii)|) -- a null column's zero diagonal would read as
    defect 1 forever under max|X^H X - I|, and both terms vanish at the
    fixed points (column norms 0 or 1).  The defect is read on the host
    once per iteration (``NS_HOST_READS`` counts the reads off the CPU)."""
    global NS_HOST_READS
    X = V[..., :, :pk] * float(np.float32(1.0 / np.sqrt(2)))
    eye = torch.eye(pk, dtype=V.real.dtype, device=V.device)
    threshold = float(np.float32(tol) if V.dtype == torch.complex64 else tol)
    for _ in range(max_iters):
        P = X.mH @ X
        diag = P.real.diagonal(dim1=-2, dim2=-1)
        off = ((P.real - eye * P.real).abs() + P.imag.abs()).amax()
        d = torch.maximum(off, (4.0 * (diag * (1.0 - diag)).abs()).amax())
        X = X @ (1.5 * eye - 0.5 * P)
        if d.device.type != "cpu":
            NS_HOST_READS += 1
        if float(d) < threshold:
            break
    return torch.cat([X, V[..., :, pk:]], -1)


# Muon-class quintic p(x) = a x + b x^3 + c x^5 of _poly_polar: slope a at 0
# (small sigmas grow ~3.4x per iteration), |p| <= ~1.09 on [0, 1.09]
_QUINTIC_A, _QUINTIC_B, _QUINTIC_C = 3.4445, -4.7750, 2.0315
# matmul precisions of _poly_polar's quintic stage: 'highest' (full fp32,
# the package's setting) and 'tf32' (cuBLAS may use TF32 tensor cores)
QUINTIC_PRECISIONS = ("highest", "tf32")


@contextlib.contextmanager
def _tf32_allowed():
    """TF32 allowed in cuBLAS matmuls inside the block only (the package
    keeps it off, ``__init__.py``)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _qmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b at the quintic stage's ``precision``."""
    if precision == "highest":
        return a @ b
    if precision == "tf32":
        with _tf32_allowed():
            return a @ b
    raise ValueError(f"unknown quintic precision {precision!r}; one of "
                     f"{QUINTIC_PRECISIONS}")


def _poly_polar(X: torch.Tensor, q_iters: int, c_iters: int,
                q_precision: str = "highest") -> torch.Tensor:
    """Polynomial polar orthonormalization of X [B, m, k], all matmuls:
    W^H W ~ I on the span of X's non-null directions, exact zero singular
    values stay zero (p(0) = 0).  The Frobenius prescale puts sigma_max
    <= 1; ``q_iters`` quintic iterations grow the small sigmas toward 1
    (their matmuls at ``q_precision``: they only mix within span(W)), then
    ``c_iters`` cubic Newton-Schulz iterations, always at full precision,
    contract the defect quadratically to the dtype floor."""
    nrm = torch.sqrt((X.real * X.real + X.imag * X.imag).sum((-2, -1),
                                                             keepdim=True))
    inv = torch.where(nrm > 0, 1.0 / torch.clamp(nrm, min=1e-30),
                      torch.zeros_like(nrm))
    W = X * inv
    eye = torch.eye(X.shape[-1], dtype=X.real.dtype, device=X.device)
    for _ in range(q_iters):
        G = _qmul(W.mH, W, q_precision)
        G2 = _qmul(G, G, q_precision)
        W = _qmul(W, _QUINTIC_A * eye + _QUINTIC_B * G + _QUINTIC_C * G2,
                  q_precision)
    for _ in range(c_iters):
        W = W @ (1.5 * eye - 0.5 * (W.mH @ W))
    return W


def _flat_batch(theta: torch.Tensor, k: int, what: str):
    """theta [..., m, n] -> (theta [B, m, n], leading shape, squeeze flag),
    checking the projected SVDs' precondition: k even, k <= min(m, n)."""
    squeeze = theta.dim() == 2
    if squeeze:
        theta = theta[None]
    lead = theta.shape[:-2]
    m, n = theta.shape[-2:]
    if k % 2 or k > min(m, n):
        raise ValueError(f"{what} needs even k <= min(m, n), got k={k} for "
                         f"{m}x{n}")
    return theta.reshape(-1, m, n), lead, squeeze


def _unflat(S, V, disc, lead, squeeze):
    S, V, disc = (S.reshape(*lead, *S.shape[1:]), V.reshape(*lead, *V.shape[1:]),
                  disc.reshape(lead))
    if squeeze:
        S, V, disc = S[0], V[0], disc[0]
    return S, V, disc


def _discarded(theta: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """disc = ||theta||_F^2 - sum S^2, clamped at 0 (the projection leak
    included: conservative)."""
    disc = ((theta.real * theta.real + theta.imag * theta.imag).sum((-2, -1))
            - (S * S).sum(-1))
    return torch.clamp(disc, min=0.0)


def _jacobi_proj(theta, k, max_sweeps, tol, tol_b, polish, polish_b_iters,
                 polish_iters, loop):
    f64 = theta.dtype == torch.complex128
    if max_sweeps is None:
        max_sweeps = 24 if f64 else 12
    if tol is None:
        tol = 1e-14 if f64 else 3e-8
    if tol_b is None:
        tol_b = tol
    theta, lead, squeeze = _flat_batch(theta, k, "jacobi_proj")
    Q0 = _fixed_projection_basis(theta.shape[-1], k, theta.dtype, theta.device)
    T = theta @ Q0                                        # [B, m, k]
    # rows of the sweep = the columns of T
    _, Uhat = _cols_to_sv(_orthogonalize_columns(T.mT, max_sweeps, tol_b, loop),
                          polish=0)
    if polish_b_iters:
        Uhat = _ns_polish(Uhat, k, iters=polish_b_iters)
    Y = theta.mH @ Uhat                                   # [B, n, k]
    S, V = _cols_to_sv(_orthogonalize_columns(Y.mT, max_sweeps, tol, loop),
                       polish=0)
    if polish:
        V = _ns_polish(V, min(polish, k), iters=polish_iters)
    return _unflat(S, V, _discarded(theta, S), lead, squeeze)


def jacobi_proj(theta: torch.Tensor, k: int, max_sweeps: int | None = None,
                tol: float | None = None, tol_b: float | None = None,
                polish: int = 0, polish_b_iters: int = 12,
                polish_iters: int = 12):
    """Chained half-power projected top-k SVD of theta [..., m, n]:
    (S [..., k], V [..., n, k], disc [...]), the saturated-chi steady
    leg's panel path.

      1. T = theta Q0 [m, k] (Q0 the fixed basis);
      2. the Jacobi sweep loop on T's columns (tol_b) -> U-hat, normalized
         and NS-polished (``polish_b_iters``);
      3. Y = theta^H U-hat [n, k];
      4. the sweep loop on Y's columns (tol): S = column norms, V = the
         normalized columns, polished (``polish``, ``polish_iters``).

    disc = ||theta||_F^2 - sum S^2, clamped at 0.  Needs k even and
    k <= min(m, n).  Defaults as ``jacobi_sv`` (12 sweeps / tol 3e-8 for
    complex64, 24 / 1e-14 for complex128).  A CUDA tensor runs kernel 1
    (``_sweep_loop``), a CPU tensor the twin."""
    return _jacobi_proj(theta, k, max_sweeps, tol, tol_b, polish,
                        polish_b_iters, polish_iters, _sweep_loop)


def jacobi_proj_plain(theta: torch.Tensor, k: int, max_sweeps: int | None = None,
                      tol: float | None = None, tol_b: float | None = None,
                      polish: int = 0, polish_b_iters: int = 12,
                      polish_iters: int = 12):
    """``jacobi_proj`` through the torch twin and the host loop on any
    device: the plain version kernel 1 is held against."""
    return _jacobi_proj(theta, k, max_sweeps, tol, tol_b, polish,
                        polish_b_iters, polish_iters, _plain_sweep_loop)


def _jacobi_core(theta, k, q_iters, c_iters, max_sweeps, tol, polish_iters,
                 quintic_precision, polish_adaptive, loop):
    f64 = theta.dtype == torch.complex128
    if q_iters is None:
        q_iters = 16 if f64 else 10
    if c_iters is None:
        c_iters = 8 if f64 else 4
    if max_sweeps is None:
        max_sweeps = 24 if f64 else 12
    if tol is None:
        tol = 1e-14 if f64 else 1e-6
    if quintic_precision is None:
        quintic_precision = "highest"
    theta, lead, squeeze = _flat_batch(theta, k, "jacobi_core")
    Q0 = _fixed_projection_basis(theta.shape[-1], k, theta.dtype, theta.device)
    W = _poly_polar(theta @ Q0, q_iters, c_iters, quintic_precision)  # [B, m, k]
    Z = _poly_polar(theta.mH @ W, q_iters, c_iters, quintic_precision)
    K = W.mH @ (theta @ Z)                                # [B, k, k]
    # the sweep runs on the columns of K^H: its rows are conj(K)
    S, Vk = _cols_to_sv(_orthogonalize_columns(K.conj(), max_sweeps, tol, loop),
                        polish=0)
    V = Z @ Vk                                            # [B, n, k]
    if polish_iters and polish_adaptive:
        V = _ns_polish_adaptive(V, k, polish_iters, 1e-12 if f64 else 5e-6)
    elif polish_iters:
        V = _ns_polish(V, k, iters=polish_iters)
    return _unflat(S, V, _discarded(theta, S), lead, squeeze)


def jacobi_core(theta: torch.Tensor, k: int, q_iters: int | None = None,
                c_iters: int | None = None, max_sweeps: int | None = None,
                tol: float | None = None, polish_iters: int = 12,
                quintic_precision: str | None = None,
                polish_adaptive: bool = True):
    """Core-matrix projected top-k SVD of theta [..., m, n]: (S [..., k],
    V [..., n, k], disc [...]), the saturated-chi steady leg's fastest path.

      1. W = polar(theta Q0) [m, k] (``_poly_polar``: matmuls only);
      2. Z = polar(theta^H W) [n, k];
      3. K = W^H theta Z [k, k] (sigma-weighted: no Gram squaring);
      4. the Jacobi sweep loop on the columns of K^H -> S, Vk;
      5. V = Z Vk, then the NS polish: adaptive (``_ns_polish_adaptive``,
         the default: the orthonormal-V contract holds for every input) or
         fixed ``polish_iters``.

    Defaults: q_iters 10 / 16, c_iters 4 / 8, 12 / 24 sweeps, tol 1e-6 /
    1e-14 (complex64 / complex128), ``quintic_precision='highest'``
    (``QUINTIC_PRECISIONS``).  disc as ``jacobi_proj``'s.  A CUDA tensor
    runs kernel 1 on the core, a CPU tensor the twin."""
    return _jacobi_core(theta, k, q_iters, c_iters, max_sweeps, tol,
                        polish_iters, quintic_precision, polish_adaptive,
                        _sweep_loop)


def jacobi_core_plain(theta: torch.Tensor, k: int, q_iters: int | None = None,
                      c_iters: int | None = None, max_sweeps: int | None = None,
                      tol: float | None = None, polish_iters: int = 12,
                      quintic_precision: str | None = None,
                      polish_adaptive: bool = True):
    """``jacobi_core`` through the torch twin and the host loop on any
    device: the plain version kernel 1 is held against."""
    return _jacobi_core(theta, k, q_iters, c_iters, max_sweeps, tol,
                        polish_iters, quintic_precision, polish_adaptive,
                        _plain_sweep_loop)


def _orthogonalize_columns_v(X: torch.Tensor, max_sweeps: int, tol: float,
                             sweep_v):
    """``_orthogonalize_columns`` with the V accumulator: sweep X [B, n, m]
    and W = I [B, n, n] with ``sweep_v`` until converged, one host read of
    the batch-max measure per sweep.  Returns (X, W).  With the twin it is
    the plain version of the resident kernel."""
    B, n, _ = X.shape
    if n == 2:
        return _rotate_single_pair(X)
    W = torch.zeros((B, n, n), dtype=X.dtype, device=X.device)
    W.diagonal(dim1=-2, dim2=-1).fill_(1.0)
    threshold = _exit_threshold(tol)
    for _ in range(max_sweeps):
        X, W, measure = sweep_v(X, W)
        if float(measure.amax().to(torch.float32)) < threshold:
            break
    return X, W


def _orthogonalize_v(X: torch.Tensor, max_sweeps: int, tol: float):
    """The dispatch rule of ``jacobi_svd``'s sweep loop: a CPU tensor runs the
    twin loop; any other tensor that ``_resident_fits`` runs the resident
    kernel (one launch, no host read); any other runs the per-sweep kernel
    (one launch and one host read per sweep).  n = 2 is the analytic pair."""
    B, n, m = X.shape
    if (X.device.type != "cpu" and n > 2
            and _resident_fits(B, n, m, X.element_size())):
        return _jacobi_svd_resident_cuda(X, max_sweeps, tol)
    return _orthogonalize_columns_v(X, max_sweeps, tol, _sweep_v)


_orthogonalize_v_plain = functools.partial(_orthogonalize_columns_v,
                                           sweep_v=_jacobi_sweep_v_torch)


def _usv_from_rotated(X: torch.Tensor, W: torch.Tensor):
    """(U [B, m, n], S [B, n], Vh [B, n, n]) from the orthogonalized rows X
    [B, n, m] and the accumulated rotation W = V^T [B, n, n]: the shared
    ``_sigma_sort_floor`` convention (W's rows co-sorted), then normalize.
    Rows below the floor give zero sigma AND zero U columns."""
    S, X, inv, (W,) = _sigma_sort_floor(X, (W,))
    U = (X * inv[..., None]).transpose(-1, -2)
    return U, S, W.conj().resolve_conj()


def _jacobi_svd(theta, n_sweeps, tol, orthogonalize):
    if n_sweeps is None:
        n_sweeps = 24 if theta.dtype == torch.complex128 else 12
    if tol is None:
        tol = 1e-14 if theta.dtype == torch.complex128 else 3e-8
    squeeze = theta.dim() == 2
    if squeeze:
        theta = theta[None]
    lead = theta.shape[:-2]
    m, n0 = theta.shape[-2:]
    theta = theta.reshape(-1, m, n0)
    # odd column counts: one zero column appended.  It never rotates (|c| = 0
    # pairs get the identity rotation) and rows never move, so it stays at
    # row n-1 with W row e_{n-1}; dropping both afterwards is exact.
    n = n0 + n0 % 2
    # a fresh contiguous X = theta^T: the CUDA kernels rotate it in place
    X = torch.zeros((theta.shape[0], n, m), dtype=theta.dtype,
                    device=theta.device)
    X[:, :n0] = theta.transpose(-1, -2)
    X, W = orthogonalize(X, n_sweeps, tol)
    U, S, Vh = _usv_from_rotated(X[:, :n0], W[:, :n0, :n0])
    U, S, Vh = (U.reshape(*lead, m, n0), S.reshape(*lead, n0),
                Vh.reshape(*lead, n0, n0))
    if squeeze:
        U, S, Vh = U[0], S[0], Vh[0]
    return U, S, Vh


def jacobi_svd(theta: torch.Tensor, n_sweeps: int | None = None,
               tol: float | None = None):
    """Full one-sided Jacobi SVD: theta [..., m, n] -> (U [..., m, n],
    S [..., n], Vh [..., n, n]), any m and n.

    S descending; U's columns for sigma below the 64*eps floor are zero.
    Sweeps are adaptive, with ``jacobi_sv``'s exit rule: stop once a sweep's
    max pair overlap is below tol * sigma_max^2, at most ``n_sweeps``
    (default 12 / tol 3e-8 for complex64, 24 / 1e-14 for complex128).  A CPU
    tensor runs the torch twin, any other tensor one of the CUDA
    V-accumulating kernels by the rule of ``_orthogonalize_v`` (or
    raises)."""
    global CUDA_SVD_CALLS
    if theta.device.type == "cuda" and theta.shape[-1] > 2:
        CUDA_SVD_CALLS += 1
    return _jacobi_svd(theta, n_sweeps, tol, _orthogonalize_v)


def jacobi_svd_plain(theta: torch.Tensor, n_sweeps: int | None = None,
                     tol: float | None = None):
    """``jacobi_svd`` through the torch twin on any device: the plain
    version the CUDA kernels are held against."""
    return _jacobi_svd(theta, n_sweeps, tol, _orthogonalize_v_plain)

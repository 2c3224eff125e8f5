#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``timecrystal_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device (cuda:0), nvcc, and the repository checkout around
it; it imports only the port, torch, numpy and the numpy-only dense oracle
tests/exact_reference.py.  Phases:

  1. device: torch's device name and nvidia-smi's name and power limit;
  2. build: the Jacobi kernels from timecrystal_tpu_torch/csrc/ (one
     source, one nvcc, sm_90a): kernel 1's shared-memory and cluster
     variants, kernel 2's per-sweep and resident variants; the ptxas report
     must show no spills for kernel 1 and the resident kernel;
  3. kernel 1 (V-free sweep) checks: jacobi_sv on complex64 [4, 512, 512]
     against LAPACK, both variants against the torch twin (float64 one
     sweep; float32 at every width of the
     chi ladder, with the device exit's sweeps against the host loop's and
     the twin's), with times per call and one sweep at the window's three
     call shapes and the n=512 leg's, beside the bound and torch.linalg.svd;
  4. kernel 2 (V-accumulating sweep) checks: jacobi_svd on the same input
     against LAPACK, the kernel against its twin (float64 one sweep;
     float32 full calls at the TDVP, tall, wide, odd and n=2 shapes), one
     sweep timed beside its bound and torch.linalg.svd; then its resident
     variant (one launch per call for one matrix that fits in shared
     memory): float64 X and W after 1 and 3 sweeps against the twin's,
     float32 full calls against the twin loop up to the fit limit n=120,
     LAPACK at [1, 96, 96], and one whole call timed against the per-sweep
     call it replaces and torch.linalg.svd;
  5. tests/golden/entangling_L10.npz through CustomFloquet on the GPU;
  6. the TEBD path at the real size: the chi-staged ensemble window of
     bench.py's CONFIG (L=40, chi cap 256, R=16, 20 merged periods), then 3
     fixed chi=256 merged periods of one chain (kernel 1 at n=512), each
     with its kernel-1 launches and sweeps (device counter) and its host
     syncs (torch's sync debug mode); then a profile of the window;
  7. the saturated-chi steady leg: jacobi_proj, jacobi_core and
     csvd_topk('jacobi_core_fast') on complex64 [4, 512, 512] against LAPACK
     at the JAX package's compiled-kernel thresholds, with the quintic
     stage's precisions timed and their dense-spectrum defect; kernel 1 on
     this path's shapes against the host loop and the twin, timed; bench.py's
     settled L=40, chi=256 state (40 merged periods on 'jacobi'), then 5
     timed periods per SVD method, the 50-period closed-loop gate against
     'jacobi', chi=512 on 'jacobi_core', and the exact chi=512 leg
     (svd_method 'auto': kernel 1 at [20/19, 1024, 1024]) against
     'jacobi_core' over the same periods; kernel 1 at n = 768 and 1024
     against the host loop, the twin (complex128) and float64 LAPACK;
  8. the fixed-chi ensemble: the phase diagram's 120-point grid (L=16,
     chi_pad=32, 80 periods) and one 40-point chunk of the drive-strength
     diagram (a kick per realization, chi_pad=48), each with A2T against
     the host recipe;
  9. the application layer (analysis/, config.txt): the phase diagram's
     120 points through sweep_phase_grid and its scoring, the drive
     diagram's default 12 x 10 grid through sweep_drive_grid, the
     correlation trace of evolve_batch, and Figures A-D's four simulations
     at the reference's sizes, each against complex128 on the host CPU
     (matplotlib is not needed: nothing is rendered);
 10. the open-system and ground-state dynamics: the memory figure's scans
     at generate_memory_figure's defaults with config.txt (the bit, coherence
     and eps legs, 216 rows of L=16, chi=48 for 100 periods each; T2 against
     1/(2 gamma), exact protection at eps = 0, five rows against complex128
     on the host CPU with the same noise), the superket Lindblad solver at
     L=6, chi=64 against the dense Strang product, the imaginary-time ground
     state of two L=12 chains against exact diagonalization, the dephasing
     baseline (L=12, 100 periods) against complex128 and the channel average
     of 600 trajectories, and the two-time correlator of four phase-grid
     points against complex128 with its structure-factor peak;
 11. kill and resume, scale-out and profiling: child processes running
     the CONFIG window (evolve_batch_auto), Figure A's chain
     (evolve_floquet_auto) and the phase grid in eight chunks
     (sweep_phase_grid) through checkpoint_dir are sent SIGKILL mid-run and
     resumed here, against uninterrupted runs; two Gloo ranks on the card run
     evolve_batch_multihost and the staged evolution with per-rank
     checkpoints (killed and resumed) on the phase grid's batch, and one
     CONFIG chain split 20 + 20 (evolve_floquet_sharded), each against the
     same work in one process; PhaseTimer and device_trace on one window
     chunk;
 12. the JAX package's three examples as the port's entry points
     (timecrystal_tpu_torch.examples): the quickstart's five sections at
     its widths (the TDVP section 10 of its 16 periods, one of its two
     realizations) (the single chain and two ensemble members against
     complex128 on the host CPU), the hires 25 x 20 phase grid as one
     program and in five checkpointed chunks (its corners against
     complex128), and the multihost demo's two Gloo ranks sharing the card
     against one process;
 13. the long-range TDVP path against the dense oracle (L=10, chi=32, 4
     periods, theta = pi and the entangling 0.92 pi, the latter also against
     a complex128 CPU run of the same TDVP), then at the interaction-range
     diagram's widths (L=12, chi=48, 10 periods, alpha in {1.5, None};
     every split on the resident kernel 2 at n=96), with a profile of its
     time.

Any failed check raises, so the exit code is not 0.  The last two lines are
a JSON summary of the kernels (kernel 1's two variants, kernel 2's resident
one) and the device JSON.
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden" / "entangling_L10.npz"
LADDER = (64, 96, 144, 216, 328, 496, 512)   # n = 2 chi, chi 32 -> 256 x1.5
CONFIG = dict(L=40, chi=256, theta_frac=0.9, h=0.3, tau=1.0, seed=42, R=16,
              n_periods=20, chi_start=32, chunk=5, growth=1.5, svd_min=1e-7)
# the interaction-range diagram (main.py --range-diagram with config.txt:
# J=1, T_DRIVE=2 -> tau=1, H_MAX=0.3, seed 42) at its eps=0.05 curve, cut
# from its 24 periods to 10 (the script's time limit; at 8 periods, 9
# samples, the A2T recipe has no bin near f_drive/2 and reads 0)
RANGE = dict(L=12, chi=48, n_periods=10, substeps=2, J=1.0, h=0.3, tau=1.0,
             theta_frac=0.95, seed=42, alphas=(1.5, None))
# the card's peaks (H100 SXM data sheet): HBM bytes/s, float32 and float64
# FLOP/s outside the tensor cores
PEAK_BYTES, PEAK_F32, PEAK_F64 = 3.35e12, 67e12, 34e12
SMS = 132                                    # streaming multiprocessors
# batches of more elements warm torch.linalg.svd up on one matrix
LIBRARY_WARM_FULL = 1 << 22
# torch CPU threads of the references run on the host (_host_threads)
HOST_REFERENCE_THREADS = 1


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


@contextlib.contextmanager
def _host_threads():
    """torch's CPU ops on HOST_REFERENCE_THREADS threads for a reference run
    on the host made of small ops (one chain, a TDVP chain, a figure's
    chain), where the default pool (one thread a core) spins on the shared
    host and runs them several times slower.  Batched references (the
    grids, the memory rows) keep the default pool."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(HOST_REFERENCE_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _timed(fn, reps: int = 1):
    """(result, median seconds) of fn() on the GPU, synchronized."""
    import torch

    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times))


def sweep_bound(B: int, n: int, m: int, with_v: bool, itemsize: int = 8):
    """(bound_ms, bound_by, fp64_ms) of ONE sweep over B matrices of n rows
    of length m (with the n x n V rows when with_v): the larger of the
    bytes moved once (X and V read and written, the schedule read, the
    measure written) over the memory rate and the FLOPs -- (n-1)(n/2)
    pairs; per element of a row pair, 8 for the overlap conj(u) v and 20
    for the rotation (each of u' = cs u - w1 v and v' = w2 u + cs v is a
    real x complex product, a complex product and a complex add: 2 + 6 + 2),
    and 20 per element of the two V rows -- over the float32 peak (the
    inputs' type).  fp64_ms is the FLOP time at the float64 peak, the
    arithmetic the kernels do."""
    flops = B * (n - 1) * (n // 2) * (28 * m + (20 * n if with_v else 0))
    nbytes = (2 * B * n * m * itemsize + (2 * B * n * n * itemsize if with_v
                                          else 0) + (n - 1) * n * 4 + 8 * B)
    t_ops, t_bytes = flops / PEAK_F32, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops / PEAK_F64 * 1e3)


def _event_ms(fn, args_list):
    """Mean ms per call of fn(*args) over args_list, CUDA events, after one
    warm-up call."""
    import torch

    fn(*args_list[0])
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for args in args_list[1:]:
        fn(*args)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (len(args_list) - 1)


def _library_ms(M, reps=3):
    """torch.linalg.svd of the batch M (mean of ``reps`` calls after a
    warm-up call): the yardstick of a sweep kernel (the port never calls it
    on these paths).  Above LIBRARY_WARM_FULL elements the warm-up runs on
    M's first matrix only, which loads the solver for the shape at 1/B of
    the batch's seconds."""
    import torch

    def svd(x):
        return torch.linalg.svd(x, full_matrices=False)

    warm = M if M.numel() <= LIBRARY_WARM_FULL else M[:1]
    return _event_ms(svd, [(warm,)] + [(M,)] * reps)


def _tebd_like(gen, B: int, n: int, dtype):
    """[B, n, n] = U diag(s) V^H with Haar-random U, V and a Schmidt-like
    spectrum: rank r = 15/16 of chi = n/2 (the staged evolution's grow-ahead
    occupancy), s_i = 10^(-7 sqrt(i / r)) from 1 down to 1e-7 (the bench's
    svd_min).  Jacobi converges on these in 7-9 sweeps, as on TEBD thetas."""
    import torch

    real = dtype.to_real()
    r = 15 * (n // 2) // 16
    s = torch.zeros(n, dtype=real, device="cuda")
    s[:r] = 10.0 ** (-7.0 * torch.sqrt(torch.arange(r, dtype=real,
                                                    device="cuda") / r))
    Q, _ = torch.linalg.qr(torch.randn(2, B, n, n, dtype=dtype, device="cuda",
                                       generator=gen))
    return (Q[0] * s) @ Q[1].mH


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    _check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"[device] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s); "
          f"nvidia-smi: {smi_line}", flush=True)
    return name, smi_line


_KERNEL_NAME = re.compile(r"(jacobi_[a-z_]+_kernel)I([fd])((?:Li\d+E)*)E")


def _kernel_label(ln: str):
    """Short name of the kernel instantiation whose mangled name is in ln,
    e.g. jacobi_sv_cluster<f32, 16>; None when ln names none."""
    m = _KERNEL_NAME.search(ln)
    if m is None:
        return None
    args = ["f32" if m.group(2) == "f" else "f64"] + re.findall(r"Li(\d+)E", m.group(3))
    return f"{m.group(1)[:-len('_kernel')]}<{', '.join(args)}>"


# the kernel instantiations of jacobi_sweep.cu: kernel 1's shared-memory
# and cluster variants, kernel 2's per-sweep and resident (two group sizes)
# variants, for both types
KERNEL1 = ("jacobi_sv_smem", "jacobi_sv_cluster")
N_INSTANTIATIONS = 10


def phase_build():
    from timecrystal_tpu_torch.ops.cuda_build import load_kernel_library

    t0 = time.perf_counter()
    _, info = load_kernel_library("jacobi_sweep")
    # pair each kernel instantiation with its ptxas register and spill lines
    ptxas, spills, label = {}, {}, None
    for ln in info.log.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            label = _kernel_label(ln)
        elif "spill stores" in ln and label:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            spills[label] = nums[1] + nums[2]     # stack frame, stores, loads
        elif "registers" in ln and label:
            ptxas[label] = ln.split(":", 1)[1].strip()
    print(f"[build] {info.path.relative_to(REPO)} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {info.seconds:.1f} s): {' '.join(info.command[1:4])}; ptxas: "
          f"{' | '.join(f'{k}: {v}, spill bytes {spills.get(k)}' for k, v in ptxas.items())}",
          flush=True)
    _check("arch=compute_90a,code=sm_90a" in info.command, "not built for sm_90a")
    if info.seconds:
        _check(len(ptxas) == N_INSTANTIATIONS,
               f"expected {N_INSTANTIATIONS} kernel instantiations, got {list(ptxas)}")
        checked = [k for k in ptxas
                   if k.startswith(KERNEL1 + ("jacobi_svd_resident",))]
        _check(len(checked) == 8 and all(spills.get(k) == 0 for k in checked),
               f"a kernel-1 variant or the resident kernel spills: {spills}")


def _kernel1_call(th, **kwargs):
    """(jacobi_sv(th) on the card; the kernel-1 variant that ran; its sweeps,
    read from the device counter).  The call itself must read nothing on
    the host and run one variant."""
    from timecrystal_tpu_torch.ops import jacobi_svd as J

    counter = J.sweep_counter(th.device)
    s0, a0, c0, h0 = (int(counter), J.SV_SMEM_LAUNCHES, J.SV_CLUSTER_LAUNCHES,
                      J.SV_HOST_READS)
    out = J.jacobi_sv(th, **kwargs)
    smem, cluster = J.SV_SMEM_LAUNCHES - a0, J.SV_CLUSTER_LAUNCHES - c0
    _check(J.SV_HOST_READS == h0, "jacobi_sv read a sweep measure on the host")
    _check((smem > 0) != (cluster > 0),
           f"a jacobi_sv call ran {smem} smem and {cluster} cluster launches")
    return out, "smem" if smem else "cluster", int(counter) - s0


def _counted_host_loop(sweep):
    """(the sweep loop on the host over ``sweep``, one host read per sweep;
    a list whose first item counts the sweeps it runs)."""
    from timecrystal_tpu_torch.ops import jacobi_svd as J

    count = [0]

    def counted(X):
        count[0] += 1
        return sweep(X)

    return functools.partial(J._host_sweep_loop, sweep=counted), count


def _host_loop_sv(th, sweep, max_sweeps=None, polish=0, tol=None):
    """(jacobi_sv(th) with the sweep loop on the host over ``sweep``; the
    number of sweeps it ran).  tol=0 runs exactly ``max_sweeps``."""
    from timecrystal_tpu_torch.ops import jacobi_svd as J

    loop, count = _counted_host_loop(sweep)
    return J._jacobi_sv(th, max_sweeps, tol, polish, loop), count[0]


# the widest n at which the window's call shape [320, n, n] is held against
# the twin loop over the whole batch; above it the twin loop takes every
# TWIN320_STRIDE-th matrix (the twin's batch-320 loop costs ~7.6 s a sweep
# at n = 512)
TWIN320_MAX_N = 216
TWIN320_STRIDE = 8
# one sweep timed at the window's three call shapes (R * bonds = 320
# matrices at chi 32, 48, 72) and the n=512 leg's
SWEEP_SHAPES = ((320, 64), (320, 96), (320, 144), (20, 512))


def phase_kernels():
    import torch

    from timecrystal_tpu_torch.ops import jacobi_svd as J

    # (a) the compiled-kernel acceptance of the JAX package
    # (tests/test_tpu_smoke.py::test_compiled_jacobi_sv_vs_lapack)
    rng = np.random.RandomState(7)
    B, n, k = 4, 512, 256
    M = np.zeros((B, n, n), np.complex64)
    for i in range(B):
        q1, _ = np.linalg.qr(rng.randn(n, n) + 1j * rng.randn(n, n))
        q2, _ = np.linalg.qr(rng.randn(n, n) + 1j * rng.randn(n, n))
        M[i] = (q1 * np.logspace(0, -7, n)) @ q2.conj().T
    calls0 = J.CUDA_SV_CALLS
    (S, V), variant, sweeps = _kernel1_call(torch.as_tensor(M, device="cuda"),
                                            polish=k)
    _check(sweeps > 0 and J.CUDA_SV_CALLS == calls0 + 1,
           "jacobi_sv on a CUDA tensor did not run kernel 1")
    S = S.cpu().numpy()
    Sref = np.linalg.svd(M.astype(np.complex128), compute_uv=False)
    serr = float(np.max(np.abs(S - Sref)) / Sref.max())
    Vk = V.cpu().numpy()[..., :k].astype(np.complex128)
    G = np.einsum("bji,bjk->bik", Vk.conj(), Vk)
    dg = np.einsum("bii->bi", G).real
    off = float(np.abs(G - np.einsum("bi,ij->bij", dg, np.eye(k))).max())
    print(f"[kernel-vs-lapack] complex64 [4, 512, 512] logspace(0,-7): "
          f"S err {serr:.2e} x sigma_max (< 5e-5), kept-V Gram off-diag "
          f"{off:.2e} (< 5e-5), {sweeps} sweeps ({variant} variant)", flush=True)
    _check(variant == "cluster", "[4, 512, 512] did not run the cluster variant")
    _check(serr < 5e-5, f"S error {serr} vs LAPACK")
    _check(bool(np.allclose(dg, np.round(dg), atol=1e-4)), "V Gram diagonal")
    _check(off < 5e-5, f"V Gram off-diagonal {off}")

    # (b) float64: one sweep of each variant against the twin (rows of unit
    # norm on average, so the absolute bound is a relative one), at n=64
    # and at the shared-memory fit limit n=120; then the cluster variant at
    # n=300, where 299 dependent steps spread the twin's other summation
    # order further.
    gen = torch.Generator(device="cuda").manual_seed(1)
    for B, n, bound in ((4, 64, 1e-12), (4, 120, 1e-12), (2, 300, 1e-10)):
        X = torch.randn(B, n, n, dtype=torch.complex128, device="cuda",
                        generator=gen) / np.sqrt(n)
        Xt, mt = J._jacobi_sweep_torch(X.clone())
        res = {}
        for variant in ("smem", "cluster") if n <= 120 else ("cluster",):
            Xk, mk = J._jacobi_sweep_cuda(X.clone(), variant)
            res[variant] = (float((Xk - Xt).abs().max()),
                            float(((mk - mt).abs() / mt.abs().clamp_min(1e-300)).max()))
        print(f"[kernel-vs-twin f64] one sweep [{B}, {n}, {n}]: "
              + ", ".join(f"{v} max |dX| {d:.2e}, measure rel {m:.2e}"
                          for v, (d, m) in res.items())
              + f" (< {bound:.0e}, < 1e-9)", flush=True)
        for v, (d, m) in res.items():
            _check(d < bound, f"f64 {v} sweep differs from the twin at n={n}: {d}")
            _check(m < 1e-9, f"f64 {v} sweep measure differs at n={n}: {m}")
    X = torch.randn(4, 64, 64, dtype=torch.complex128, device="cuda", generator=gen)
    (Sk, _), _, _ = _kernel1_call(X, polish=32)
    St, _ = J.jacobi_sv_plain(X, polish=32)
    s64_err = float((Sk - St).abs().max() / St.max())
    print(f"[kernel-vs-twin f64] jacobi_sv [4, 64, 64]: S err {s64_err:.2e} x "
          f"sigma_max (< 1e-10)", flush=True)
    _check(s64_err < 1e-10, f"f64 S differs from the twin: {s64_err}")

    # (c) float32 at every ladder width, at the single-chain call shape (20
    # bonds).  One sweep: the convergence measure (all pair overlaps of the
    # sweep) must agree, and the rotations must be unitary (X^H X is
    # invariant; rotated rows themselves may differ by a rotation inside a
    # near-degenerate pair, a gauge freedom).  Full calls run to
    # convergence (max_sweeps=24) so S compares the arithmetic, not where a
    # 12-sweep cap cuts two rounding paths.  The device exit must give the
    # host loop's result over the same kernel bit for bit, with the same
    # sweeps; against the twin loop the count may differ by one, since the
    # exit measure (tol 3e-8: |c| / sigma_max^2 ~ 3e-8) sits at float32
    # rounding and the twin sums in another order.  The window's call shape
    # (R * bonds = 16 * 20 = 320 matrices) is checked the same way at the
    # default cap, and its calls are timed.
    worst = 0.0
    for n in LADDER:
        th = _tebd_like(gen, 20, n, torch.complex64)
        X = th.conj().resolve_conj().contiguous()
        Xk, mk = J._jacobi_sweep_cuda(X.clone())
        _, mt = J._jacobi_sweep_torch(X.clone())
        meas_rel = float(((mk - mt).abs() / mt.clamp_min(1e-300)).max())
        G0 = X.to(torch.complex128).mH @ X.to(torch.complex128)
        Gk = Xk.to(torch.complex128).mH @ Xk.to(torch.complex128)
        gram = float((Gk - G0).abs().max() / G0.abs().max())
        (Sk, _), variant, sw = _kernel1_call(th, max_sweeps=24, polish=n // 2)
        (Sh, _), sw_host = _host_loop_sv(th, J._jacobi_sweep_cuda, 24, n // 2)
        (St, _), sw_twin = _host_loop_sv(th, J._jacobi_sweep_torch, 24, n // 2)
        err = float((Sk - St).abs().max() / St.max())
        worst = max(worst, float((Sk - St).abs().max()))
        _check(meas_rel < 1e-6, f"f32 sweep measure at n={n}: {meas_rel}")
        _check(gram < 1e-5, f"f32 sweep not unitary at n={n}: {gram}")
        _check(err < 1e-5, f"f32 S at n={n} differs from the twin: {err}")
        same = bool(torch.equal(Sk, Sh))
        _check(sw == sw_host and same,
               f"device exit at n={n}: {sw} sweeps, host loop {sw_host}")
        _check(abs(sw - sw_twin) <= 1, f"sweeps at n={n}: {sw}, twin {sw_twin}")
        _check(variant == J._sv_variant(20, n, n, 8), f"n={n} ran {variant}")
        # the window's call shape (R * bonds = 320 matrices), default cap,
        # timed: the device exit reads 320 measures and the launches run in
        # waves.  The same checks: the sweeps and S against the host loop
        # over the same kernel, S and the sweeps against the twin loop.
        # Above TWIN320_MAX_N the twin loop runs every TWIN320_STRIDE-th
        # matrix (spread over the batch's clusters and waves) for exactly the
        # device exit's sweeps: S is held against those matrices' S, and
        # its sweeps, fixed so, are not compared
        th = _tebd_like(gen, 320, n, torch.complex64)
        ((Sk, _), v320, sw320), t_k = _timed(
            lambda: _kernel1_call(th, polish=n // 2))
        (Sh, _), sw_host320 = _host_loop_sv(th, J._jacobi_sweep_cuda, None, n // 2)
        whole = n <= TWIN320_MAX_N
        sub = slice(None) if whole else slice(None, None, TWIN320_STRIDE)
        if whole:
            ((St, _), sw_twin320), t_t = _timed(
                lambda: _host_loop_sv(th, J._jacobi_sweep_torch, None, n // 2))
        else:
            ((St, _), sw_twin320), t_t = _timed(lambda: _host_loop_sv(
                th[sub].contiguous(), J._jacobi_sweep_torch, sw320, n // 2,
                tol=0.0))
        twin_of = ("the twin loop" if whole else
                   f"the twin loop over every {TWIN320_STRIDE}th matrix "
                   f"({St.shape[0]}) for the device exit's sweeps")
        err320 = float((Sk[sub] - St).abs().max() / St.max())
        worst = max(worst, float((Sk[sub] - St).abs().max()))
        print(f"[kernel-vs-twin f32] n={n} ({variant}): one sweep [20, {n}, {n}] "
              f"measure rel {meas_rel:.2e} (< 1e-6), X^H X drift {gram:.2e} (< 1e-5); "
              f"jacobi_sv S err {err:.2e} x sigma_max (< 1e-5); sweeps: device exit "
              f"{sw}, host loop over the kernel {sw_host} (S identical: "
              f"{same}), twin loop {sw_twin}; at [320, {n}, {n}] "
              f"({v320}, default cap): S err {err320:.2e} x sigma_max (< 1e-5) "
              f"against {twin_of}, sweeps: device exit {sw320}, host loop "
              f"over the kernel {sw_host320}, twin loop {sw_twin320}; per call "
              f"kernel {t_k * 1e3:.1f} ms, twin {t_t * 1e3:.1f} ms "
              f"({St.shape[0]} matrices)", flush=True)
        _check(err320 < 1e-5, f"f32 S at [320, {n}, {n}] differs from the twin: "
               f"{err320}")
        _check(sw320 == sw_host320 and torch.equal(Sk, Sh),
               f"device exit at [320, {n}, {n}]: {sw320} sweeps, host loop "
               f"{sw_host320}")
        if whole:
            _check(abs(sw320 - sw_twin320) <= 1,
                   f"sweeps at [320, {n}, {n}]: {sw320}, twin {sw_twin320}")
        _check(v320 == J._sv_variant(320, n, n, 8), f"[320, {n}, {n}] ran {v320}")
        del th, Sk, Sh, St

    # (d) one sweep, CUDA events, twice, at the window's call shapes and the
    # n=512 leg's, beside the sweep's bound and one torch.linalg.svd of the
    # same batch
    times = {}
    for B, n in SWEEP_SHAPES:
        th = _tebd_like(gen, B, n, torch.complex64)
        X = th.conj().resolve_conj().contiguous()
        variant = J._sv_variant(B, n, n, X.element_size())
        ms = [_event_ms(lambda x: J._jacobi_sweep_cuda(x, variant),
                        [(X.clone(),) for _ in range(6)]) for _ in range(2)]
        twin = _event_ms(J._jacobi_sweep_torch, [(X.clone(),) for _ in range(3)])
        lib = _library_ms(th, reps=1)
        bound, by, f64 = sweep_bound(B, n, n, with_v=False)
        layout = _layout(B, n, n, variant, X)
        times[(B, n)] = dict(ms=float(np.mean(ms)), plain_ms=twin,
                             bound_ms=bound, bound_by=by, library_ms=lib,
                             variant=variant)
        print(f"[sweep time] one sweep, complex64 [{B}, {n}, {n}], {variant} "
              f"variant ({layout}): {' / '.join(f'{t:.4f}' for t in ms)} ms; "
              f"twin {twin:.3f} ms, bound {bound:.4f} ms ({by}; FP64 "
              f"FLOPs {f64:.4f} ms), torch.linalg.svd {lib:.3f} ms", flush=True)
        del th, X
    # the float <-> double conversions' share: complex128 rows convert
    # nothing (but move twice the bytes); the same sweep in both types
    per_dtype = {}
    for dtype in (torch.complex64, torch.complex128):
        X = torch.randn(320, 64, 64, dtype=dtype, device="cuda", generator=gen)
        per_dtype[dtype] = _event_ms(J._jacobi_sweep_cuda,
                                     [(X.clone(),) for _ in range(6)])
    print(f"[sweep time] smem variant, one sweep at [320, 64, 64]: complex64 "
          f"{per_dtype[torch.complex64]:.4f} ms, complex128 "
          f"{per_dtype[torch.complex128]:.4f} ms", flush=True)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {variant: dict(
        max_abs_err=worst, **{k: times[shape][k] for k in keys},
        ms_by_shape={f"{B}x{n}x{n}": t["ms"] for (B, n), t in times.items()
                     if t["variant"] == variant})
        for variant, shape in (("smem", (320, 64)), ("cluster", (20, 512)))}


def _usv_rel(U, S, Vh, M):
    """||U diag(S) Vh - M||_F / ||M||_F in float64."""
    import torch

    U, Vh, M = (x.to(torch.complex128) for x in (U, Vh, M))
    rec = (U * S.to(torch.float64)[..., None, :].to(U.dtype)) @ Vh
    return float(torch.linalg.norm(rec - M) / torch.linalg.norm(M))


def phase_v_kernels():
    """Kernel 2, the V-accumulating sweep, through jacobi_svd."""
    import torch

    from timecrystal_tpu_torch.ops import jacobi_svd as J

    # (a) LAPACK acceptance on the input of kernel 1's: S, the orthonormality
    # of V, and the reconstruction
    rng = np.random.RandomState(7)
    B, n = 4, 512
    M = np.zeros((B, n, n), np.complex64)
    for i in range(B):
        q1, _ = np.linalg.qr(rng.randn(n, n) + 1j * rng.randn(n, n))
        q2, _ = np.linalg.qr(rng.randn(n, n) + 1j * rng.randn(n, n))
        M[i] = (q1 * np.logspace(0, -7, n)) @ q2.conj().T
    Mt = torch.as_tensor(M, device="cuda")
    launches0, calls0 = J.V_KERNEL_LAUNCHES, J.CUDA_SVD_CALLS
    U, S, Vh = J.jacobi_svd(Mt)
    sweeps = J.V_KERNEL_LAUNCHES - launches0
    _check(sweeps > 0 and J.CUDA_SVD_CALLS == calls0 + 1,
           "jacobi_svd on a CUDA tensor did not launch kernel 2")
    Sref = np.linalg.svd(M.astype(np.complex128), compute_uv=False)
    serr = float(np.max(np.abs(S.cpu().numpy() - Sref)) / Sref.max())
    _, St, _ = J.jacobi_svd_plain(Mt)
    serr_twin = float(np.max(np.abs(St.cpu().numpy() - Sref)) / Sref.max())
    Vh64 = Vh.to(torch.complex128)
    eye = torch.eye(n, dtype=torch.complex128, device="cuda")
    orth = float((Vh64 @ Vh64.mH - eye).abs().max())
    rec = _usv_rel(U, S, Vh, Mt)
    print(f"[v-kernel-vs-lapack] complex64 [4, 512, 512] logspace(0,-7): "
          f"S err {serr:.3e} x sigma_max (< 5e-5), max |V^H V - I| "
          f"{orth:.2e} (< 5e-5), |U S Vh - M|/|M| {rec:.2e} (< 1e-4), "
          f"{sweeps} sweeps; the twin's S err {serr_twin:.3e}", flush=True)
    _check(serr < 5e-5, f"kernel 2 S error {serr} vs LAPACK")
    _check(orth < 5e-5, f"kernel 2 V not orthonormal: {orth}")
    _check(rec < 1e-4, f"kernel 2 reconstruction {rec}")
    del U, S, Vh, Vh64, Mt

    # (b) float64, one sweep on a rectangular panel: rows (n=96, unit norm on
    # average, so the absolute bound is a relative one) and V
    gen = torch.Generator(device="cuda").manual_seed(2)
    X = torch.randn(4, 96, 80, dtype=torch.complex128, device="cuda",
                    generator=gen) / np.sqrt(80)
    W = torch.eye(96, dtype=torch.complex128, device="cuda").expand(
        4, 96, 96).contiguous()
    Xk, Wk, mk = J._jacobi_sweep_v_cuda(X.clone(), W.clone())
    Xt, Wt, mt = J._jacobi_sweep_v_torch(X.clone(), W.clone())
    dX, dW = float((Xk - Xt).abs().max()), float((Wk - Wt).abs().max())
    meas_rel = float(((mk - mt).abs() / mt.abs().clamp_min(1e-300)).max())
    print(f"[v-kernel-vs-twin f64] one sweep X [4, 96, 80] (unit rows), W [4, 96, 96]: "
          f"max |dX| {dX:.2e}, max |dW| {dW:.2e} (< 1e-12), measure rel "
          f"{meas_rel:.2e}", flush=True)
    _check(dX < 1e-12 and dW < 1e-12, f"f64 V sweep differs: {dX} {dW}")
    _check(meas_rel < 1e-9, f"f64 V sweep measure differs: {meas_rel}")

    # (c) float32 full calls run to convergence, kernel against twin, by S and
    # by the U S Vh reconstruction ([1, 96, 96] fits the resident variant,
    # the others run the per-sweep one)
    worst = 0.0
    for shape in ((1, 96, 96), (1, 128, 128), (2, 96, 64), (2, 64, 96),
                  (2, 96, 95), (4, 5, 2)):
        M = torch.randn(*shape, dtype=torch.complex64, device="cuda",
                        generator=gen)
        (Uk, Sk, Vhk), variant, sw = _kernel2_call(M, n_sweeps=24)
        Ut, St, Vht = J.jacobi_svd_plain(M, n_sweeps=24)
        err = float((Sk - St).abs().max() / St.max())
        worst = max(worst, float((Sk - St).abs().max()))
        rec_k, rec_t = _usv_rel(Uk, Sk, Vhk, M), _usv_rel(Ut, St, Vht, M)
        print(f"[v-kernel-vs-twin f32] {list(shape)}: S err {err:.2e} x "
              f"sigma_max (< 1e-5), |U S Vh - M|/|M| kernel {rec_k:.2e}, twin "
              f"{rec_t:.2e} (< 1e-5), {sw} sweeps ({variant})", flush=True)
        _check(err < 1e-5, f"f32 kernel-2 S at {shape} differs: {err}")
        _check(rec_k < 1e-5 and rec_t < 1e-5, f"f32 USVh at {shape}")
        _check(sw > 0 or shape[-1] == 2, f"kernel 2 not launched at {shape}")

    # (d) one sweep, CUDA events: TDVP's call [1, 96, 96] (the summary's "ms")
    # and a batch that fills the card [320, 64, 64]
    ms = {}
    for B, n in ((1, 96), (320, 64)):
        M = torch.randn(B, n, n, dtype=torch.complex64, device="cuda",
                        generator=gen)
        X = M.transpose(-1, -2).contiguous()
        W = torch.eye(n, dtype=M.dtype, device="cuda").expand(B, n, n).contiguous()
        for name, fn in (("kernel", J._jacobi_sweep_v_cuda),
                         ("twin", J._jacobi_sweep_v_torch)):
            ms[(name, B, n)] = _event_ms(
                fn, [(X.clone(), W.clone()) for _ in range(6)])
        ms[("library", B, n)] = _library_ms(M)
        bound, by, f64 = sweep_bound(B, n, n, with_v=True)
        ms[("bound", B, n)] = (bound, by)
        print(f"[sweep time] kernel 2, one sweep, complex64 [{B}, {n}, {n}]: "
              f"kernel {ms[('kernel', B, n)]:.4f} ms, twin "
              f"{ms[('twin', B, n)]:.3f} ms, bound {bound:.5f} ms ({by}; FP64 "
              f"FLOPs {f64:.5f} ms), torch.linalg.svd "
              f"{ms[('library', B, n)]:.3f} ms", flush=True)
    return dict(max_abs_err=worst, per_sweep_ms=ms[("kernel", 1, 96)],
                plain_ms=ms[("twin", 1, 96)], bound_ms=ms[("bound", 1, 96)][0],
                bound_by=ms[("bound", 1, 96)][1],
                library_ms=ms[("library", 1, 96)])


def _kernel2_call(M, svd=None, **kwargs):
    """(svd(M) on the card, jacobi_svd by default; the kernel-2 variant that
    ran; its sweeps): the resident kernel's sweeps are read from its device
    counter, the per-sweep kernel's are its launches."""
    from timecrystal_tpu_torch.ops import jacobi_svd as J

    counter = J.resident_sweep_counter(M.device)
    l0, r0, s0 = J.V_KERNEL_LAUNCHES, J.V_RESIDENT_LAUNCHES, int(counter)
    usv = (svd or J.jacobi_svd)(M, **kwargs)
    resident = J.V_RESIDENT_LAUNCHES - r0
    per_sweep = J.V_KERNEL_LAUNCHES - l0 - resident
    _check(resident + per_sweep == 0 or (resident == 1) != (per_sweep > 0),
           "one jacobi_svd call ran both kernel-2 variants")
    if resident:
        return usv, "resident", int(counter) - s0
    return usv, "per-sweep", per_sweep


def _host_loop_svd(M, sweep_v, n_sweeps=None):
    """jacobi_svd(M) with the sweep loop on the host, one sweep_v call per
    sweep, whatever the shape."""
    from timecrystal_tpu_torch.ops import jacobi_svd as J

    return J._jacobi_svd(M, n_sweeps, None, functools.partial(
        J._orthogonalize_columns_v, sweep_v=sweep_v))


def _twin_svd(M, n_sweeps=None):
    """jacobi_svd_plain(M) with the number of sweeps its twin loop ran."""
    from timecrystal_tpu_torch.ops import jacobi_svd as J

    count = [0]

    def sweep_v(X, W):
        count[0] += 1
        return J._jacobi_sweep_v_torch(X, W)

    return _host_loop_svd(M, sweep_v, n_sweeps), count[0]


def _per_sweep_svd(M):
    """jacobi_svd through the per-sweep kernel 2: the call the resident
    kernel replaces (one launch and one host read per sweep)."""
    from timecrystal_tpu_torch.ops import jacobi_svd as J

    return _host_loop_svd(M, J._sweep_v)


def phase_v_resident():
    """Kernel 2's resident variant: one launch runs a whole jacobi_svd sweep
    loop of one matrix held in shared memory."""
    import torch

    from timecrystal_tpu_torch.ops import jacobi_svd as J

    counter = J.resident_sweep_counter("cuda:0")
    gen = torch.Generator(device="cuda").manual_seed(3)

    # (a) float64 with no exit (tol 0): X and W after 1 and 3 sweeps against
    # as many twin sweeps from W = I; rows of unit norm on average, so the
    # absolute bound is a relative one
    for n, m in ((64, 64), (80, 64)):
        X = torch.randn(1, n, m, dtype=torch.complex128, device="cuda",
                        generator=gen) / np.sqrt(m)
        W0 = torch.eye(n, dtype=X.dtype, device="cuda")[None].contiguous()
        for n_sweeps in (1, 3):
            s0 = int(counter)
            Xk, Wk = J._jacobi_svd_resident_cuda(X.clone(), n_sweeps, 0.0)
            ran = int(counter) - s0
            Xt, Wt = X.clone(), W0.clone()
            for _ in range(n_sweeps):
                Xt, Wt, _ = J._jacobi_sweep_v_torch(Xt, Wt)
            dX, dW = float((Xk - Xt).abs().max()), float((Wk - Wt).abs().max())
            print(f"[v-resident-vs-twin f64] X [1, {n}, {m}], {n_sweeps} "
                  f"sweep(s) ({ran} run): max |dX| {dX:.2e}, max |dW| {dW:.2e} "
                  f"(< 1e-12)", flush=True)
            _check(ran == n_sweeps, f"resident kernel ran {ran} of {n_sweeps} sweeps")
            _check(dX < 1e-12 and dW < 1e-12,
                   f"f64 resident sweeps differ from the twin: {dX} {dW}")

    # (b) float32 full calls to convergence (n_sweeps=24) against the twin
    # loop, at the TDVP shapes, tall, wide, odd, the fit limit and n=4
    worst = 0.0
    for shape in ((1, 96, 96), (1, 64, 64), (1, 96, 64), (1, 64, 96),
                  (1, 96, 95), (1, 120, 120), (1, 4, 4)):
        M = torch.randn(*shape, dtype=torch.complex64, device="cuda",
                        generator=gen)
        (Uk, Sk, Vhk), variant, sw = _kernel2_call(M, n_sweeps=24)
        (Ut, St, Vht), sw_t = _twin_svd(M, 24)
        err = float((Sk - St).abs().max() / St.max())
        worst = max(worst, float((Sk - St).abs().max()))
        rec_k, rec_t = _usv_rel(Uk, Sk, Vhk, M), _usv_rel(Ut, St, Vht, M)
        print(f"[v-resident-vs-twin f32] {list(shape)}: S err {err:.2e} x "
              f"sigma_max (< 1e-5), |U S Vh - M|/|M| kernel {rec_k:.2e}, twin "
              f"{rec_t:.2e} (< 1e-5); {sw} sweeps, twin {sw_t} (within 1); "
              f"{variant} kernel", flush=True)
        _check(err < 1e-5, f"f32 resident S at {shape} differs: {err}")
        _check(rec_k < 1e-5 and rec_t < 1e-5, f"f32 resident USVh at {shape}")
        _check(abs(sw - sw_t) <= 1, f"resident sweeps {sw} vs twin {sw_t} at {shape}")
        _check(variant == "resident", f"{shape} did not run the resident kernel")

    # (c) LAPACK acceptance at the TDVP shape: complex64 [1, 96, 96] with a
    # logspace(0,-7) spectrum, default 12 sweeps; the per-sweep variant on the
    # same input beside it
    rng = np.random.RandomState(7)
    n = 96
    q1, _ = np.linalg.qr(rng.randn(n, n) + 1j * rng.randn(n, n))
    q2, _ = np.linalg.qr(rng.randn(n, n) + 1j * rng.randn(n, n))
    M = ((q1 * np.logspace(0, -7, n)) @ q2.conj().T).astype(np.complex64)[None]
    Mt = torch.as_tensor(M, device="cuda")
    Sref = np.linalg.svd(M.astype(np.complex128), compute_uv=False)
    eye = torch.eye(n, dtype=torch.complex128, device="cuda")
    res = {}
    for variant, call in (("resident", lambda: _kernel2_call(Mt)),
                          ("per-sweep", lambda: _kernel2_call(Mt, _per_sweep_svd))):
        (U, S, Vh), _, sw = call()
        Vh64 = Vh.to(torch.complex128)
        res[variant] = (float(np.max(np.abs(S.cpu().numpy() - Sref)) / Sref.max()),
                        float((Vh64 @ Vh64.mH - eye).abs().max()),
                        _usv_rel(U, S, Vh, Mt), sw)
    serr, orth, rec, sw = res["resident"]
    print(f"[v-resident-vs-lapack] complex64 [1, 96, 96] logspace(0,-7): S err "
          f"{serr:.3e} x sigma_max (< 5e-5), max |V^H V - I| {orth:.2e} (< 5e-5), "
          f"|U S Vh - M|/|M| {rec:.2e} (< 1e-4), {sw} sweeps; per-sweep variant: "
          f"S err {res['per-sweep'][0]:.3e}, |V^H V - I| {res['per-sweep'][1]:.2e}, "
          f"rec {res['per-sweep'][2]:.2e}, {res['per-sweep'][3]} sweeps", flush=True)
    _check(serr < 5e-5, f"resident S error {serr} vs LAPACK")
    _check(orth < 5e-5, f"resident V not orthonormal: {orth}")
    _check(rec < 1e-4, f"resident reconstruction {rec}")

    # (d) whole calls at [1, 96, 96] on a TDVP-like theta, CUDA events: the
    # resident call, the per-sweep call it replaces and torch.linalg.svd; ms
    # per sweep from fixed sweep counts with no exit, (t(9) - t(1)) / 8
    M = _tebd_like(gen, 1, n, torch.complex64)
    _, _, sweeps = _kernel2_call(M)
    _, _, sweeps_ps = _kernel2_call(M, _per_sweep_svd)
    call_ms = _event_ms(J.jacobi_svd, [(M,)] * 6)
    ps_ms = _event_ms(_per_sweep_svd, [(M,)] * 6)
    lib_ms = _library_ms(M)
    X = M.transpose(-1, -2).contiguous()
    t1, t9 = (_event_ms(J._jacobi_svd_resident_cuda,
                        [(X.clone(), s, 0.0) for _ in range(6)]) for s in (1, 9))
    ms_sweep = (t9 - t1) / 8
    bound, by, f64 = sweep_bound(1, n, n, with_v=True)
    print(f"[v-call time] complex64 [1, 96, 96] TDVP-like: resident call "
          f"{call_ms:.3f} ms ({sweeps} sweeps), per-sweep call {ps_ms:.3f} ms "
          f"({sweeps_ps} sweeps), torch.linalg.svd {lib_ms:.3f} ms; resident "
          f"{ms_sweep:.4f} ms per sweep (t(1 sweep) {t1:.4f} ms, t(9) {t9:.4f} "
          f"ms); card-wide bound {sweeps * bound:.5f} ms ({sweeps} x {bound:.5f}, "
          f"{by}), one-SM FP64 floor {sweeps * f64 * SMS:.4f} ms ({sweeps} x "
          f"{f64 * SMS:.4f})", flush=True)
    _check(call_ms < ps_ms, f"resident call {call_ms} ms not faster than the "
           f"per-sweep call {ps_ms} ms")
    # the float <-> double conversions' share: complex64 rows are converted
    # on every read and write, complex128 rows never: the same sweep in both
    # at [1, 64, 64], where complex128 fits too
    per_dtype = {}
    for dtype in (torch.complex64, torch.complex128):
        X = torch.randn(1, 64, 64, dtype=dtype, device="cuda", generator=gen)
        t1, t9 = (_event_ms(J._jacobi_svd_resident_cuda,
                            [(X.clone(), s, 0.0) for _ in range(6)]) for s in (1, 9))
        per_dtype[dtype] = (t9 - t1) / 8
    print(f"[v-call time] resident ms per sweep at [1, 64, 64]: complex64 "
          f"{per_dtype[torch.complex64]:.4f}, complex128 "
          f"{per_dtype[torch.complex128]:.4f} (one-SM FP64 floor "
          f"{sweep_bound(1, 64, 64, with_v=True)[2] * SMS:.4f})", flush=True)
    return dict(max_abs_err=worst, ms=ms_sweep, call_ms=call_ms,
                sweeps_per_call=sweeps)


def phase_golden():
    import torch

    from timecrystal_tpu_torch.core.mps import create_initial_state
    from timecrystal_tpu_torch.core.truncate import TruncParams
    from timecrystal_tpu_torch.dynamics.tebd import CustomFloquet
    from timecrystal_tpu_torch.models.kicked_ising import KickedIsingModel
    from timecrystal_tpu_torch.ops import jacobi_svd as J

    with np.load(GOLDEN) as z:
        L, chi, n = int(z["L"]), int(z["chi"]), int(z["n"])
        tau, theta, hf = float(z["tau"]), float(z["theta"]), z["h_fields"]
        sz_ref, le_ref = z["sz_sites"], z["loschmidt_echo"]
    m = KickedIsingModel(L, 1.0, float(np.max(np.abs(hf))), tau, h_fields=hf,
                         theta=theta, chi=chi, dtype=torch.complex64,
                         device="cuda")
    psi0 = create_initial_state(L, "neel", chi=chi, dtype=torch.complex64,
                                device="cuda")
    counter = J.sweep_counter("cuda:0")
    s0, c0 = int(counter), J.CUDA_SV_CALLS
    tp = TruncParams.reference_hot_path()._replace(svd_method="jacobi")
    tr, _, info = CustomFloquet(m, tp).evolve_floquet_traces(psi0, n)
    d_sz = float(np.max(np.abs(tr["sz_sites"] - sz_ref)))
    d_le = float(np.max(np.abs(tr["loschmidt_echo"] - le_ref)))
    sweeps = int(counter) - s0
    print(f"[golden] entangling_L10 (L={L}, chi={chi}, {n} periods, complex64, "
          f"kernel): max |d sz| {d_sz:.2e}, max |d LE| {d_le:.2e} (< 1e-4); "
          f"{J.CUDA_SV_CALLS - c0} SVD calls, {sweeps} sweeps, "
          f"{info['periods_per_second']:.1f} periods/s", flush=True)
    _check(sweeps > 0, "golden run did not run kernel 1")
    _check(d_sz < 1e-4 and d_le < 1e-4, "golden trace mismatch")


def _reset_kernel1_counts():
    """Set kernel 1's counts to 0: the launches of each variant, the CUDA
    jacobi_sv calls, its host reads and the device counter of sweeps."""
    from timecrystal_tpu_torch.ops import jacobi_svd as J

    J.KERNEL_LAUNCHES = J.SV_SMEM_LAUNCHES = J.SV_CLUSTER_LAUNCHES = 0
    J.CUDA_SV_CALLS = J.SV_HOST_READS = 0
    J.sweep_counter("cuda:0").zero_()


def _kernel1_counts():
    from timecrystal_tpu_torch.ops import jacobi_svd as J

    return dict(launches=J.KERNEL_LAUNCHES, smem=J.SV_SMEM_LAUNCHES,
                cluster=J.SV_CLUSTER_LAUNCHES, calls=J.CUDA_SV_CALLS,
                host_reads=J.SV_HOST_READS,
                sweeps=int(J.sweep_counter("cuda:0")))


def _with_sync_count(fn):
    """(fn(), host syncs during it by torch's sync debug mode)."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum(1 for w in caught if "synchroniz" in str(w.message))


def _window_problem():
    """(h_fields [R, L], spec) of bench.py's CONFIG window."""
    from timecrystal_tpu_torch.core.truncate import TruncParams
    from timecrystal_tpu_torch.models.kicked_ising import draw_disorder_reference
    from timecrystal_tpu_torch.parallel.sweep import SweepSpec

    c = CONFIG
    h = np.stack([draw_disorder_reference(c["L"], c["h"], c["seed"] + r)
                  for r in range(c["R"])])
    spec = SweepSpec(L=c["L"], chi=c["chi"], n_periods=c["n_periods"],
                     theta=c["theta_frac"] * float(np.pi),
                     tp=TruncParams(chi_max=0, svd_min=c["svd_min"]),
                     dtype="float32", frame="merged")
    return h, spec


def _window_run(checkpoint_dir=None):
    """evolve_batch_auto on the CONFIG window (traces, info)."""
    from timecrystal_tpu_torch.parallel.sweep import (_basis_indices,
                                                      evolve_batch_auto)

    c = CONFIG
    h, spec = _window_problem()
    return evolve_batch_auto(
        h, np.full(c["R"], c["tau"]), _basis_indices(c["L"], "neel"), spec,
        chi_start=c["chi_start"], chunk_periods=c["chunk"],
        growth=c["growth"], checkpoint_dir=checkpoint_dir, device="cuda")


def phase_real_size():
    import torch

    from timecrystal_tpu_torch.core.mps import create_initial_state
    from timecrystal_tpu_torch.dynamics.tebd import evolve_floquet_scan
    from timecrystal_tpu_torch.models.kicked_ising import make_floquet_gates

    c = CONFIG
    L, R, n_periods = c["L"], c["R"], c["n_periods"]
    h, spec = _window_problem()
    torch.cuda.reset_peak_memory_stats()
    _reset_kernel1_counts()              # the window's counts start here
    (traces, info), win_syncs = _with_sync_count(_window_run)
    win = _kernel1_counts()
    for k, v in traces.items():
        _check(bool(np.all(np.isfinite(v))), f"non-finite trace {k}")
    _check(traces["sz_sites"].shape == (R, n_periods + 1, L), "sz shape")
    le = traces["loschmidt_echo"]
    _check(float(le.min()) >= 0.0 and float(le.max()) <= 1.0 + 1e-5,
           f"LE outside [0, 1]: {le.min()} {le.max()}")
    _check(int(traces["max_chi"].max()) <= c["chi"], "max_chi above the cap")
    _check(win["smem"] > 0 and win["sweeps"] > 0,
           "the window ran no shared-memory kernel-1 sweep")
    _check(win["smem"] + win["cluster"] == win["launches"], "kernel-1 launch count")
    _check(win["host_reads"] == 0, f"{win['host_reads']} jacobi_sv host reads")
    schedule = [c["chi_start"]] + [e["to"] for e in info["chi_escalations"]]
    n_chunks = (-(-n_periods // c["chunk"])
                + sum(1 for e in info["chi_escalations"] if not e.get("ahead")))
    print(f"[window] L={L} R={R} {n_periods} merged periods: "
          f"{info['chain_periods_per_second']:.2f} chain-periods/s "
          f"({info['wall_time']:.1f} s); chi schedule {schedule} "
          f"(escalations {info['chi_escalations']}); {win['calls']} SVD calls, "
          f"{win['sweeps']} sweeps ({win['sweeps'] / max(win['calls'], 1):.2f} per "
          f"call, device counter) in {win['launches']} launches ({win['smem']} "
          f"smem, {win['cluster']} cluster); host syncs {win_syncs} "
          f"({win['host_reads']} sweep-exit reads, {n_chunks} chunks); max_chi "
          f"{int(traces['max_chi'].max())}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    # n = 512: three fixed chi=256 merged periods of one chain
    gates = make_floquet_gates(1.0, torch.as_tensor(h[0], device="cuda"),
                               c["tau"], theta=spec.theta,
                               dtype=torch.complex64)
    psi0 = create_initial_state(L, "neel", chi=c["chi"], dtype=torch.complex64,
                                device="cuda")
    _reset_kernel1_counts()              # the n512 leg's counts start here
    ((psi, tr), leg_syncs), dt = _timed(lambda: _with_sync_count(
        lambda: evolve_floquet_scan(psi0, gates, 3,
                                    spec.tp._replace(svd_method="jacobi"),
                                    frame="merged")))
    leg = _kernel1_counts()
    sz = tr["sz_sites"].cpu().numpy()
    _check(bool(np.all(np.isfinite(sz))) and sz.shape == (3, L), "n512 traces")
    _check(psi.chi == c["chi"] and leg["cluster"] > 0 and leg["sweeps"] > 0,
           "the n512 leg ran no cluster kernel-1 sweep")
    _check(leg["host_reads"] == 0, f"{leg['host_reads']} jacobi_sv host reads")
    print(f"[n512] one chain, chi=256, 3 merged periods: {3 / dt:.3f} "
          f"periods/s ({dt:.2f} s incl. frame entry/exit); {leg['calls']} SVD "
          f"calls at n=512, {leg['sweeps']} sweeps ({leg['sweeps'] / max(leg['calls'], 1):.2f} "
          f"per call, device counter) in {leg['launches']} launches "
          f"({leg['smem']} smem, {leg['cluster']} cluster); host syncs "
          f"{leg_syncs} ({leg['host_reads']} sweep-exit reads)", flush=True)
    return ({v: win[v] + leg[v] for v in ("smem", "cluster")},
            info["wall_time"], (traces, info))


# device-time classes of the profiles: (label, fragments of the kernel's
# lower-case name); a kernel falls in the first class that names it
KERNEL1_CLASSES = (("kernel 1 smem", ("jacobi_sv_smem",)),
                   ("kernel 1 cluster", ("jacobi_sv_cluster",)))
MATMUL_CLASS = ("matmul / einsum", ("gemm", "gemv", "xmma", "cutlass", "bmm",
                                    "dot"))


def _profile(fn, classes):
    """torch.profiler over fn(), synchronized: (wall ms, device ms by class,
    launches by class, CUDA runtime synchronize calls).  Kernels no class
    names go to 'other'.  The CUDA activity alone (kernels and runtime
    calls): recording every CPU operator as well made the post-processing
    of one TDVP period take tens of seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ms = {label: 0.0 for label, _ in classes}
    ms["other"] = 0.0
    launches = dict.fromkeys(ms, 0)
    n_sync = 0
    for evt in prof.key_averages():
        if evt.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize"):
            n_sync += evt.count
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = evt.key.lower()
        label = next((lb for lb, frags in classes
                      if any(f in name for f in frags)), "other")
        ms[label] += float(getattr(evt, "self_device_time_total", 0.0)) / 1e3
        launches[label] += evt.count
    return wall, ms, launches, n_sync


def _profile_line(wall, ms, unprofiled_ms):
    """The profiled wall, device busy time and idle share (also against the
    unprofiled run's ms: the profiler slows the host) and the device time
    by class."""
    busy = sum(ms.values())
    parts = ", ".join(f"{k} {v:.1f} ms ({v / max(busy, 1e-9):.0%})"
                      for k, v in ms.items())
    return (f"wall {wall:.1f} ms (profiled), device busy {busy:.1f} ms, idle "
            f"share {1 - busy / wall:.3f} (against the unprofiled "
            f"{unprofiled_ms:.1f} ms: {1 - busy / unprofiled_ms:.3f}); {parts}")


def phase_window_profile(window_s: float):
    """Where the window's time goes: torch.profiler over a second run of the
    window (the kernels built and the chi ladder's schedules cached),
    device time by class, the device's idle share and the runtime's
    synchronize calls; ``window_s`` is the unprofiled window's seconds."""
    from timecrystal_tpu_torch.core.truncate import TruncParams
    from timecrystal_tpu_torch.models.kicked_ising import draw_disorder_reference
    from timecrystal_tpu_torch.parallel.sweep import (SweepSpec, _basis_indices,
                                                      evolve_batch_auto)

    c = CONFIG
    L, R = c["L"], c["R"]
    h = np.stack([draw_disorder_reference(L, c["h"], c["seed"] + r)
                  for r in range(R)])
    spec = SweepSpec(L=L, chi=c["chi"], n_periods=c["n_periods"],
                     theta=c["theta_frac"] * float(np.pi),
                     tp=TruncParams(chi_max=0, svd_min=c["svd_min"]),
                     dtype="float32", frame="merged")
    wall, ms, launches, n_sync = _profile(lambda: evolve_batch_auto(
        h, np.full(R, c["tau"]), _basis_indices(L, "neel"), spec,
        chi_start=c["chi_start"], chunk_periods=c["chunk"],
        growth=c["growth"], device="cuda"), KERNEL1_CLASSES + (MATMUL_CLASS,))
    k1 = {k: v for k, v in launches.items() if k.startswith("kernel 1")}
    print(f"[window-profile] {R * c['n_periods']} chain-periods: "
          f"{_profile_line(wall, ms, window_s * 1e3)}; kernel-1 launches {k1}; "
          f"{n_sync} CUDA runtime synchronize calls", flush=True)
    _check(k1["kernel 1 smem"] > 0, "the profiled window ran no kernel 1")


def _load_oracle():
    """tests/exact_reference.py, loaded by path: a top-level 'tests' package
    elsewhere on sys.path would shadow the checkout's tests/ directory."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "exact_reference", REPO / "tests" / "exact_reference.py")
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    return oracle


def _oracle_traces(oracle, L, couplings, h_fields, tau, theta, n):
    """sz [n+1, L] and LE [n+1] of the dense oracle from the Neel state."""
    U = oracle.long_range_floquet_unitary(L, couplings, h_fields, tau,
                                          theta=theta)
    psi = oracle.product_statevector(oracle.neel_indices(L))
    psi_0 = psi.copy()
    sz, le = [oracle.sz_expectations(psi, L)], [1.0]
    for _ in range(n):
        psi = U @ psi
        sz.append(oracle.sz_expectations(psi, L))
        le.append(abs(np.vdot(psi_0, psi)) ** 2)
    return np.asarray(sz), np.asarray(le)


def _trace_err(tr, sz, le):
    return (float(np.max(np.abs(tr["sz_sites"] - sz))),
            float(np.max(np.abs(tr["loschmidt_echo"] - le))))


def phase_tdvp_oracle():
    """LongRangeKickedIsing in complex64 on the card against the dense
    oracle on the fitted couplings (tests/test_long_range.py's check, at
    L=10 and full rank), for the exact pi kick and for theta = 0.92 pi.

    The pi kick keeps the Neel state a product state (rank-1 thetas, one
    sweep per split): the traces are exact up to rounding, bound 1e-4.  At
    0.92 pi the thetas entangle and two-site TDVP has a genuine splitting
    error (9.09e-5 in sz, 8.02e-5 in LE over 10 periods with the port's
    complex128 Jacobi twin on the CPU, the same as with LAPACK splits).  So
    that leg is also run in complex128 on the CPU with LAPACK splits, an
    SVD independent of the kernel: the card must agree with it to 1e-5
    (complex64 rounding), and with the oracle to that run's own error plus
    1e-5."""
    import torch

    oracle = _load_oracle()
    from timecrystal_tpu_torch.core.mps import create_initial_state
    from timecrystal_tpu_torch.models.long_range import (LongRangeKickedIsing,
                                                         fitted_couplings)
    from timecrystal_tpu_torch.ops import jacobi_svd as J

    L, chi, alpha, tau, n = 10, 32, 1.3, 0.4, 4

    def run(theta, dtype, device):
        model = LongRangeKickedIsing(L, 1.0, 0.3, tau, alpha=alpha,
                                     disorder_seed=42, theta=theta, chi=chi,
                                     substeps=2, dtype=dtype, device=device)
        psi0 = create_initial_state(L, "neel", chi=chi, dtype=dtype,
                                    device=device)
        traces, _, info = model.evolve(psi0, n)
        return model, traces, info

    counter = J.resident_sweep_counter("cuda:0")
    for frac in (1.0, 0.92):
        theta = frac * float(np.pi)
        l0, r0, c0 = J.V_KERNEL_LAUNCHES, J.V_RESIDENT_LAUNCHES, J.CUDA_SVD_CALLS
        s0 = int(counter)
        model, traces, info = run(theta, torch.complex64, "cuda")
        launches, calls = J.V_KERNEL_LAUNCHES - l0, J.CUDA_SVD_CALLS - c0
        resident, sweeps = J.V_RESIDENT_LAUNCHES - r0, int(counter) - s0
        sz, le = _oracle_traces(oracle, L, fitted_couplings(L, 1.0, alpha),
                                model.h_fields, tau, theta, n)
        d_sz, d_le = _trace_err(traces, sz, le)
        line = (f"[tdvp-oracle] long-range L={L} chi={chi} alpha={alpha} "
                f"tau={tau} theta={frac} pi, {n} periods, complex64: max |d sz| "
                f"{d_sz:.2e}, max |d LE| {d_le:.2e}")
        _check(launches > 0, f"the TDVP oracle leg at {frac} pi launched no kernel 2")
        _check(resident == calls == launches,
               f"not every split at {frac} pi ran the resident kernel: {calls} "
               f"calls, {resident} resident of {launches} launches")
        if frac == 1.0:
            bound = (1e-4, 1e-4)
            line += " (< 1e-4)"
        else:
            # the same TDVP, complex128 on the CPU with LAPACK splits
            with _host_threads():
                _, ref, _ = run(theta, torch.complex128, "cpu")
            e_sz, e_le = _trace_err(ref, sz, le)
            c_sz, c_le = _trace_err(traces, ref["sz_sites"], ref["loschmidt_echo"])
            bound = (e_sz + 1e-5, e_le + 1e-5)
            line += (f" (< {bound[0]:.2e}, {bound[1]:.2e}: the complex128 CPU "
                     f"run's splitting error {e_sz:.2e}, {e_le:.2e} + 1e-5); "
                     f"against the complex128 CPU run {c_sz:.2e}, {c_le:.2e} "
                     f"(< 1e-5)")
            _check(c_sz < 1e-5 and c_le < 1e-5,
                   f"TDVP at {frac} pi differs from the complex128 CPU run")
            _check(sweeps > calls, f"rank-1 splits only at {frac} pi")
        print(f"{line}; {calls} SVD calls, {resident} resident kernel-2 "
              f"launches, {sweeps} sweeps ({sweeps / max(calls, 1):.2f} per "
              f"call); {info['periods_per_second']:.2f} periods/s", flush=True)
        _check(d_sz < bound[0] and d_le < bound[1],
               f"TDVP trace mismatch with the oracle at {frac} pi")


def phase_range():
    """The interaction-range diagram's scan at its own widths: kernel 2's
    main path.  Host syncs are counted with torch's sync debug mode; each
    run's traces are recorded by wrapping ``LongRangeKickedIsing.evolve``
    for the duration of the scan."""
    import torch

    from timecrystal_tpu_torch.models import long_range as LR
    from timecrystal_tpu_torch.ops import jacobi_svd as J

    c = RANGE
    n_runs = len(c["alphas"])
    torch.cuda.reset_peak_memory_stats()
    counter = J.resident_sweep_counter("cuda:0")
    counter.zero_()                  # the main path's counts start here
    J.V_KERNEL_LAUNCHES = 0
    J.V_RESIDENT_LAUNCHES = 0
    J.CUDA_SVD_CALLS = 0
    runs, evolve = [], LR.LongRangeKickedIsing.evolve

    def recorded(self, psi, n_periods):
        out = evolve(self, psi, n_periods)
        runs.append(out)
        return out

    LR.LongRangeKickedIsing.evolve = recorded
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            out = LR.scan_interaction_range(
                c["alphas"], L=c["L"], J=c["J"], h_disorder=c["h"],
                tau=c["tau"], theta=c["theta_frac"] * float(np.pi),
                n_periods=c["n_periods"], n_realizations=1, chi=c["chi"],
                substeps=c["substeps"], seed0=c["seed"],
                dtype=torch.complex64, device="cuda")
            wall = time.perf_counter() - t0
            torch.cuda.set_sync_debug_mode(0)
    finally:
        LR.LongRangeKickedIsing.evolve = evolve
    launches, calls = J.V_KERNEL_LAUNCHES, J.CUDA_SVD_CALLS
    resident, sweeps = J.V_RESIDENT_LAUNCHES, int(counter)
    syncs = sum(1 for w in caught if "synchroniz" in str(w.message))
    n_per = n_runs * c["n_periods"]
    _check(len(runs) == n_runs, f"{len(runs)} runs recorded, not {n_runs}")
    for tr, _, _ in runs:
        for k, v in tr.items():
            _check(bool(np.all(np.isfinite(v))), f"non-finite trace {k}")
        _check(tr["sz_sites"].shape == (c["n_periods"] + 1, c["L"]),
               "sz shape")
        le = tr["loschmidt_echo"]
        _check(float(le.min()) >= 0.0 and float(le.max()) <= 1.0 + 1e-5,
               f"LE outside [0, 1]: {le.min()} {le.max()}")
    _check(bool(np.all(np.isfinite(out["a2t"]))), "non-finite A2T")
    _check(calls > 0 and resident == calls == launches,
           f"the range scan did not run the resident kernel on every split: "
           f"{calls} SVD calls, {resident} resident of {launches} kernel-2 launches")
    rates = [info["periods_per_second"] for _, _, info in runs]
    print(f"[range] L={c['L']} chi={c['chi']} (n={2 * c['chi']}) n_exp=12 "
          f"substeps={c['substeps']} theta=0.95 pi, {c['n_periods']} periods "
          f"x alpha {list(c['alphas'])}: A2T {np.round(out['a2t'], 4).tolist()}; "
          f"{n_per / wall:.3f} periods/s ({wall:.1f} s; per run "
          f"{[round(r, 3) for r in rates]}); {calls} SVD calls "
          f"({calls / n_per:.1f} per period), all on the resident kernel 2 "
          f"({resident} launches), {sweeps} sweeps ({sweeps / max(calls, 1):.2f} "
          f"per call, device counter); host syncs {syncs} "
          f"({syncs / n_per:.1f} per period); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    return resident, wall / n_per


def phase_range_profile(period_s: float):
    """Where the TDVP period's time goes: torch.profiler over one period of
    the range leg's alpha=1.5 model, kernel device time by class.  The
    profiler slows the host, so the idle share is also given against
    ``period_s``, the range leg's unprofiled seconds per period."""
    import torch

    from timecrystal_tpu_torch.core.mps import create_initial_state
    from timecrystal_tpu_torch.models.long_range import LongRangeKickedIsing

    c = RANGE
    model = LongRangeKickedIsing(
        c["L"], c["J"], c["h"], c["tau"], alpha=c["alphas"][0],
        disorder_seed=c["seed"], theta=c["theta_frac"] * float(np.pi),
        chi=c["chi"], substeps=c["substeps"], dtype=torch.complex64,
        device="cuda")
    psi = create_initial_state(c["L"], "neel", chi=c["chi"],
                               dtype=torch.complex64, device="cuda")
    for _ in range(4):                         # past the low-rank start
        psi = model.floquet_step(psi)
    eigh = ("syevd", "sytrd", "stedc", "ormtr", "syevj", "heevd", "hetrd",
            "lapack", "eigh", "steqr", "sterf", "larf")
    wall, ms, _, n_sync = _profile(lambda: model.floquet_step(psi), (
        ("kernel 2 resident", ("jacobi_svd_resident",)),
        ("kernel 2 per-sweep", ("jacobi_sweep",)), ("eigh (cuSOLVER)", eigh),
        MATMUL_CLASS))
    print(f"[range-profile] 1 period, alpha={c['alphas'][0]}: "
          f"{_profile_line(wall, ms, period_s * 1e3)}; {n_sync} CUDA runtime "
          f"synchronize calls", flush=True)


# --- the saturated-chi steady leg and the fixed-chi ensemble ---------------

# the projected SVDs' compiled-kernel acceptance of the JAX package
# (tests/test_tpu_smoke.py: jacobi_proj / jacobi_core against LAPACK, the
# jacobi_core_fast certificate check), run on the card: [4, 512, 512]
# panels, k = 256
PROJ_N, PROJ_K = 512, 256
# bench.py's certificate slack per bond update: 2x the kept-weight
# overshoot ceiling that [proj-vs-lapack] asserts on the card
CERT_SLACK_PER_BOND = 1e-4
OVERSHOOT_CEILING = 5e-5
# the closed-loop class the reference recorded (max |d stag|, max |d LE|
# over 50 steady periods against 'jacobi': bench.py:156 for jacobi_core,
# ops/csvd.py:437 of the JAX package for the tuned jacobi_proj) and the
# bound applied here, CLOSED_LOOP_FACTOR times it
CLOSED_LOOP_CLASS = {"jacobi_core": (4.7e-4, 1.5e-3),
                     "jacobi_core_fast": (4.7e-4, 1.5e-3),
                     "jacobi_proj": (1.1e-3, 7.5e-4)}
CLOSED_LOOP_FACTOR = 2.0
# n_steady: 5 of bench.py's 10 timed steady periods (the script's time
# limit); n_closed: bench.py's 50 closed-loop periods, over which the class
# was recorded
STEADY = dict(n_settle=40, n_steady=5, n_closed=50, n_settle512=10,
              n_steady512=3, n_exact512=2)
STEADY_METHODS = ("jacobi_core_fast", "jacobi_core", "jacobi_proj", "jacobi")
# the phase diagram (analysis/phase_diagram.py GRID_HARDCODED with
# config.txt: SVD_MIN 1e-12, SVD_CUTOFF 1e-7, RANDOM_SEED 42) and one
# 40-point chunk of its drive-strength diagram (chi_pad 48, T_DRIVE 2)
GRID = dict(L=16, chi=32, n_periods=80, chi_max=24, svd_min=1e-12,
            trunc_cut=1e-7, h=(0.0, 0.8, 12), T=(0.8, 4.0, 10), seed=42,
            n_profiled=10, n_reference=4)
# a grid's points on the card against the same points in complex128 on the
# host CPU with LAPACK splits, max |d sz| and |d LE|: over the periods before
# the reference first discards more than GRID_EXACT_TRUNC on a bond
# (complex64 rounding only: a wrong kick shows from the first period), and
# over the whole run, where truncation at chi_max amplifies the float32
# Jacobi's rounding in the small singular vectors (PERF.md)
GRID_EXACT_TRUNC = 1e-8
GRID_REFERENCE_TOL = dict(exact=1e-4, truncated=1e-2)
DRIVE = dict(chi=48, eps=(0.0, 0.2, 8), h=(0.0, 0.8, 5))
# kernel 1 on the shapes the paths after the window launch (B, rows, row
# length, exit tolerance; None = the complex64 default 3e-8), each even and
# odd bond layer: jacobi_proj's panel and the k x k core of the steady leg;
# the phase grid and diagram (120 points x 8 / 7 bonds, chi_pad 32); the
# 40-point drive grid's odd layer (its [320, 96, 96] is the window's);
# the drive diagram (120 points, chi_pad 48); [correlation] (4 points);
# Figures A-C (L=64) and D (L=16) at chi_pad 16; the memory figure's
# legs (216 rows x 8 / 7 bonds at chi 48); the Lindblad superket (L=6,
# n = 4 chi = 256); the ground state and the dephasing baseline (L=12, chi
# 32); [two-time]'s pairs (2 x 4 points); the channel average (600
# trajectories, L=4, chi 8); [multihost]'s rank of the phase grid (60
# points x 8 / 7 bonds); [site-shard]'s 20-site block at chi 64 (10 / 9
# local bonds) and its boundary bond; the exact leg's chi=512 thetas
# ([steady-exact-chi512], n = 1024) and the chi-staged ladder's rung above
# 256 (_next_chi(256, 512, 1.5) = 384, n = 768), 20 even bonds of L=40;
# [hires]'s one program (500 points x 8 even bonds at chi_pad 32)
NEW_SHAPES = ((20, 256, 512, 1e-6), (20, 256, 256, 1e-6),
              (960, 64, 64, None), (840, 64, 64, None), (280, 96, 96, None),
              (960, 96, 96, None), (840, 96, 96, None), (32, 64, 64, None),
              (28, 64, 64, None), (32, 32, 32, None), (31, 32, 32, None),
              (8, 32, 32, None), (7, 32, 32, None),
              (1728, 96, 96, None), (1512, 96, 96, None), (3, 256, 256, None),
              (2, 256, 256, None), (6, 64, 64, None), (5, 64, 64, None),
              (64, 64, 64, None), (56, 64, 64, None), (1200, 16, 16, None),
              (600, 16, 16, None), (480, 64, 64, None), (420, 64, 64, None),
              (10, 128, 128, None), (9, 128, 128, None), (1, 128, 128, None),
              (20, 768, 768, None), (20, 1024, 1024, None), (4000, 64, 64, None))
# the odd bond layer beside three of them, one sweep and one call timed:
# the exact leg's and the rung's 19 odd bonds, and the hires grid's one
# program (500 points x 7 odd bonds of L=16)
ODD_LAYER = {(20, 768, 768): 19, (20, 1024, 1024): 19, (4000, 64, 64): 3500}
# the shapes whose torch.linalg.svd is timed here: this slice's (the
# earlier shapes' library times were taken in earlier runs and stand in
# PERF.md; timing them again cost ~45 s of the script's limit)
LIBRARY_TIMED = set(ODD_LAYER)
# from this row count up the twin loops run on the batch's first
# TWIN_SUBSET matrices, beside the device exit over the same matrices (the
# twin's batch-20 sweep takes seconds at n = 1024); the device exit and the
# host loop over the kernel, the converged S, the timings and the library
# run on the whole batch
TWIN_SUBSET_N, TWIN_SUBSET = 768, 2


# the Lindblad superket's shapes (n = 256, the cluster variant): in
# complex64 a converged float32 Jacobi sweep loop leaves S ~1e-5 sigma_max
# from exact there (the twin 7.7-8.5e-6, the kernel 7.5e-6-1.1e-5, complex64
# torch.linalg.svd 2.1-2.2e-5 from float64 LAPACK, measured on an H100), so
# kernel and twin can differ by more than the 1e-5 of the other shapes.
# These shapes are held instead to the twin in complex128 (the same
# algorithm in exact arithmetic, to 1e-9 sigma_max) and, in complex64, to
# float64 LAPACK within twice the complex64 library SVD's own distance
# (float32 rounding grows with n: the same rule holds at n = 768 and 1024,
# for the batch's first TWIN_SUBSET matrices).  Their complex128 leg runs
# kernel 1 and the twin on the complex128 copy of the same input, both held
# to complex128 LAPACK of it: (1) at jacobi_sv's complex128 exit and cap
# (tol 1e-14, 24 sweeps), each loop by its own exit, to 1e-9 sigma_max
# where the value is True (the n = 256 shapes; reported at n = 768 and 1024,
# where the exit leaves the twin itself ~2e-9 sigma_max from LAPACK on the
# kept sigma and more on the ~n/2 sigma below 1e-7 sigma_max that the
# complex64 input's rounding leaves); (2) both loops run to convergence
# (WITNESS_SWEEPS sweeps, tol 0), to 1e-9 sigma_max of each other and of
# LAPACK over every sigma, at every shape.  WITNESS_KEPT splits the report
# at the bench's svd_min
WITNESS_SHAPES = {(3, 256, 256): True, (2, 256, 256): True,
                  (20, 768, 768): False, (20, 1024, 1024): False}
WITNESS_SWEEPS, WITNESS_KEPT = 40, 1e-7


def _proj_panels(spectra, B=4, seed=11, unit=False):
    """complex64 [B, n, n] = Q1 diag(s) Q2^H for each spectrum s of length
    n: the JAX package's compiled-kernel inputs (RandomState(seed) Haar
    draws, one stream for all spectra); ``unit`` scales s to unit Frobenius
    norm."""
    rng = np.random.RandomState(seed)
    out = []
    for s in spectra:
        n = len(s)
        s = s / max(np.linalg.norm(s), 1e-30) if unit else s
        M = np.zeros((B, n, n), np.complex64)
        for i in range(B):
            q1, _ = np.linalg.qr(rng.randn(n, n) + 1j * rng.randn(n, n))
            q2, _ = np.linalg.qr(rng.randn(n, n) + 1j * rng.randn(n, n))
            M[i] = (q1 * s) @ q2.conj().T
        out.append(M)
    return out


def _proj_errors(Sref, S, V, disc):
    """(S error x sigma_max, max |V^H V - I|, disc conservative) of a
    projected top-k SVD against LAPACK's ``Sref``, as the JAX package's
    smoke tier measures them (disc may undershoot the true tail by the
    float32 Frobenius reduction's noise, 1e-4 ||theta||^2)."""
    k = S.shape[-1]
    serr = float(np.max(np.abs(S.cpu().numpy() - Sref[:, :k])) / Sref.max())
    Vk = V.cpu().numpy().astype(np.complex128)
    off = float(np.abs(np.einsum("bji,bjk->bik", Vk.conj(), Vk)
                       - np.eye(Vk.shape[-1])[None]).max())
    d_true = np.sum(Sref[:, k:] ** 2, axis=1)
    cons = bool(np.all(disc.cpu().numpy()
                       >= d_true - 1e-4 * np.sum(Sref ** 2, axis=1)))
    return serr, off, cons


def phase_projected():
    """jacobi_proj, jacobi_core and csvd_topk('jacobi_core_fast') on complex64
    [4, 512, 512] against LAPACK, each through kernel 1 (its launch
    counters move); the kept-weight overshoot behind the certificate slack;
    and, for both quintic precisions, the stage's time at [20, 512, 256]
    and the dense-spectrum orthonormality defect of jacobi_core with it.
    Returns the overshoots and the per-mode numbers."""
    import torch

    from timecrystal_tpu_torch.ops import csvd as CS
    from timecrystal_tpu_torch.ops import jacobi_svd as J

    n, k = PROJ_N, PROJ_K
    (M,) = _proj_panels([np.logspace(0, -7, n)])
    Sref = np.linalg.svd(M.astype(np.complex128), compute_uv=False)
    th = torch.as_tensor(M, device="cuda")
    proj_kw = dict(polish=k, polish_b_iters=6, polish_iters=6)
    for name, fn, plain in (
            ("jacobi_proj", J.jacobi_proj, J.jacobi_proj_plain),
            ("jacobi_core", J.jacobi_core, J.jacobi_core_plain)):
        kw = proj_kw if name == "jacobi_proj" else {}
        a0, c0 = J.SV_SMEM_LAUNCHES, J.SV_CLUSTER_LAUNCHES
        s0 = int(J.sweep_counter("cuda:0"))
        S, V, disc = fn(th, k, **kw)
        smem, cluster = J.SV_SMEM_LAUNCHES - a0, J.SV_CLUSTER_LAUNCHES - c0
        launches = smem + cluster
        sweeps = int(J.sweep_counter("cuda:0")) - s0
        serr, off, cons = _proj_errors(Sref, S, V, disc)
        # against the same function through the twin and the host loop, on
        # the card, both converged (jacobi_core's tol 1e-6 stops the core's
        # loop unconverged, where two rounding paths differ by ~7e-5 in S)
        conv = dict(kw, tol=3e-8, max_sweeps=24)
        Sp = plain(th, k, **conv)[0]
        perr = float((fn(th, k, **conv)[0] - Sp).abs().max() / Sp.max())
        print(f"[proj-vs-lapack] {name} complex64 [4, {n}, {n}] logspace(0,-7), "
              f"k={k}: S err {serr:.2e} x sigma_max (< 5e-4), max |V^H V - I| "
              f"{off:.2e} (< 5e-5), disc conservative {cons}; converged (tol "
              f"3e-8, cap 24) against its plain version (twin, host loop) S err "
              f"{perr:.2e} x sigma_max (< 1e-4); "
              f"kernel 1: {launches} launches ({cluster} cluster, {smem} smem), "
              f"{sweeps} sweeps", flush=True)
        _check(launches > 0 and sweeps > 0, f"{name} did not run kernel 1")
        _check(serr < 5e-4, f"{name} S error {serr}")
        _check(off < 5e-5, f"{name} V defect {off}")
        _check(cons, f"{name} disc below the true tail")
        _check(perr < 1e-4, f"{name} S differs from its plain version: {perr}")
    # the overshoot sum S^2 - (true top-k weight) of the shipped
    # jacobi_core_fast on unit-norm steep and rank-deficient panels
    over = {}
    for tag, P in zip(("steep", "rankdef"), _proj_panels(
            [np.logspace(0, -7, n),
             np.concatenate([np.linspace(1, 0.01, n // 4), np.zeros(n - n // 4)])],
            unit=True)):
        S, _, _ = CS.csvd_topk(torch.as_tensor(P, device="cuda"), k,
                               method="jacobi_core_fast")
        S = S.cpu().numpy().astype(np.float64)
        Sp = np.linalg.svd(P.astype(np.complex128), compute_uv=False)
        serr = float(np.max(np.abs(S - Sp[:, :k])) / Sp.max())
        over[tag] = float(np.max(np.sum(S ** 2, 1) - np.sum(Sp[:, :k] ** 2, 1)))
        print(f"[proj-vs-lapack] csvd_topk jacobi_core_fast ("
              f"{CS.FAST_QUINTIC_PRECISION} quintic) unit-norm {tag}: S err "
              f"{serr:.2e} x sigma_max (< 1e-3), kept-weight overshoot "
              f"{over[tag]:.2e} per bond (< {OVERSHOOT_CEILING:.0e})", flush=True)
        if tag == "steep":
            _check(serr < 1e-3, f"jacobi_core_fast S error {serr}")
        _check(over[tag] < OVERSHOOT_CEILING,
               f"jacobi_core_fast overshoot {over[tag]} ({tag})")
    # the quintic stage per precision: its time on the steady leg's
    # [20, 512, 256] panel T = theta Q0, whether it changes a complex64
    # matmul at all, and the dense-spectrum defect of jacobi_core run with
    # it (adaptive polish: a defect that survives the polish is a collapsed
    # span); then jacobi_core_fast's own configuration (fixed polish)
    gen = torch.Generator(device="cuda").manual_seed(5)
    T = (_tebd_like(gen, 20, n, torch.complex64)
         @ J._fixed_projection_basis(n, k, torch.complex64, "cuda"))
    G_full = T.mH @ T
    modes = {}
    for mode in J.QUINTIC_PRECISIONS:
        ms = _event_ms(lambda x, mode=mode: J._poly_polar(x, 10, 4, mode),
                       [(T,)] * 6)
        gram_diff = float((J._qmul(T.mH, T, mode) - G_full).abs().max()
                          / G_full.abs().max())
        _, off, _ = _proj_errors(Sref, *J.jacobi_core(th, k, quintic_precision=mode))
        modes[mode] = dict(ms=ms, gram_diff=gram_diff, defect=off)
        print(f"[proj-vs-lapack] quintic {mode}: _poly_polar [20, {n}, {k}] "
              f"(10 quintic + 4 cubic) {ms:.3f} ms; one Gram T^H T differs from "
              f"full fp32 by {gram_diff:.2e} (relative max); jacobi_core dense-"
              f"spectrum defect max |V^H V - I| {off:.2e}", flush=True)
    _, Vh, _ = CS.csvd_topk(th, k, method="jacobi_core_fast")
    Vk = Vh.mH.cpu().numpy().astype(np.complex128)
    fast_off = float(np.abs(np.einsum("bji,bjk->bik", Vk.conj(), Vk)
                            - np.eye(k)[None]).max())
    fast = CS.FAST_QUINTIC_PRECISION
    print(f"[proj-vs-lapack] jacobi_core_fast runs the quintic at '{fast}': "
          f"dense-spectrum defect of jacobi_core at it {modes[fast]['defect']:.2e} "
          f"(< 5e-5); jacobi_core_fast itself (fixed 4-iteration polish) "
          f"{fast_off:.2e} on the dense spectrum (not gated: the JAX "
          f"package gates it on the steady spectrum class)", flush=True)
    _check(modes[fast]["defect"] < 5e-5,
           f"the '{fast}' quintic leaves a dense-spectrum defect "
           f"{modes[fast]['defect']}")
    return over, modes


def _sweep_loops_counted():
    """(counter, restore): every call of kernel 1's sweep loop
    (``_sweep_loop``) adds one to counter[0] until restore()."""
    from timecrystal_tpu_torch.ops import jacobi_svd as J

    count, loop = [0], J._sweep_loop

    def counted(X, max_sweeps, threshold):
        count[0] += 1
        return loop(X, max_sweeps, threshold)

    J._sweep_loop = counted

    def restore():
        J._sweep_loop = loop
    return count, restore


def _rows_sv(X, tol, loop, max_sweeps=12):
    """S of the rows of X after the sweep loop ``loop`` with exit tolerance
    ``tol`` (at most ``max_sweeps``: 12 is the complex64 cap)."""
    from timecrystal_tpu_torch.ops import jacobi_svd as J

    return J._cols_to_sv(J._orthogonalize_columns(X, max_sweeps, tol, loop),
                         0)[0]


def _witness_check(X, Sc, Stc, exit_gated):
    """WITNESS_SHAPES: kernel 1 against the twin in complex128 on X's
    complex128 copy, both against complex128 LAPACK: at jacobi_sv's
    complex128 exit and cap, to 1e-9 sigma_max if ``exit_gated``, and run to
    convergence (WITNESS_SWEEPS sweeps), to 1e-9 sigma_max of each other and
    of LAPACK; then the converged complex64 S of kernel (Sc) and twin (Stc)
    against float64 LAPACK on the host, the kernel's within twice the
    distance of complex64 torch.linalg.svd (the witness)."""
    import torch

    from timecrystal_tpu_torch.ops import jacobi_svd as J

    X2 = X.to(torch.complex128)
    S64 = torch.linalg.svdvals(X2.cpu()).to(X.device)
    scale = float(S64.max())
    kept = S64 >= WITNESS_KEPT * scale

    def rel(S, T=S64):
        d = (S.double() - T).abs()
        return float(d[kept].max()) / scale, float(d.max()) / scale

    tol, cap = 1e-14, 24                     # jacobi_sv's complex128 defaults
    counter = J.sweep_counter(X2.device)
    c0 = int(counter)
    Sk_exit = _rows_sv(X2, tol, J._sweep_loop, cap)
    sw_k = int(counter) - c0
    Sk_conv = _rows_sv(X2, 0.0, J._sweep_loop, WITNESS_SWEEPS)
    # one twin loop of WITNESS_SWEEPS sweeps; its S where its own exit (or
    # the cap) would have ended jacobi_sv's loop is kept on the way
    threshold, meas, at_exit = J._exit_threshold(tol), [], {}

    def sweep(x):
        x, m = J._jacobi_sweep_torch(x)
        meas.append(float(m.amax().to(torch.float32)))
        if "S" not in at_exit and (meas[-1] < threshold or len(meas) == cap):
            at_exit.update(S=J._cols_to_sv(x.clone(), 0)[0], sweeps=len(meas))
        return x, m

    St_conv = _rows_sv(X2, 0.0, functools.partial(J._host_sweep_loop,
                                                  sweep=sweep), WITNESS_SWEEPS)
    St_exit, sw_t = at_exit["S"], at_exit["sweeps"]
    e_exit, e_conv = rel(Sk_exit, St_exit), rel(Sk_conv, St_conv)
    l_conv = rel(Sk_conv)
    e_k, e_t, e_w = rel(Sc)[1], rel(Stc)[1], rel(torch.linalg.svdvals(X))[1]
    B, n, m = X.shape
    print(f"[kernel-1 new shapes] [{B}, {n}, {m}] complex128 (the same input; "
          f"{int(kept.sum())} of {S64.numel()} sigma >= {WITNESS_KEPT:.0e} "
          f"sigma_max, kept / all): at the exit (tol {tol:.0e}, cap {cap}): "
          f"kernel {sw_k} sweeps, twin {sw_t}; S err {e_exit[0]:.2e} / "
          f"{e_exit[1]:.2e} x sigma_max against the twin"
          f"{' (all < 1e-9)' if exit_gated else ''}; from complex128 LAPACK: "
          f"kernel {rel(Sk_exit)[0]:.2e} / {rel(Sk_exit)[1]:.2e}, twin "
          f"{rel(St_exit)[0]:.2e} / {rel(St_exit)[1]:.2e}; converged "
          f"({WITNESS_SWEEPS} sweeps, last twin measure {meas[-1]:.1e}): S err "
          f"{e_conv[1]:.2e} against the twin, from LAPACK kernel {l_conv[1]:.2e}, "
          f"twin {rel(St_conv)[1]:.2e} (all < 1e-9); complex64 S against "
          f"float64 LAPACK: kernel {e_k:.2e}, twin {e_t:.2e}, torch.linalg.svd "
          f"(the witness) {e_w:.2e} x sigma_max (kernel < twice the witness)",
          flush=True)
    _check(not exit_gated or e_exit[1] < 1e-9,
           f"complex128 S at [{B}, {n}, {m}] at the exit: {e_exit}")
    _check(e_conv[1] < 1e-9 and l_conv[1] < 1e-9,
           f"converged complex128 S at [{B}, {n}, {m}]: {e_conv}, LAPACK {l_conv}")
    _check(e_k < 2.0 * e_w, f"complex64 S at [{B}, {n}, {m}]: {e_k} / {e_w}")


def _layout(B, n, m, variant, X):
    """The launch layout of kernel 1 on X [B, n, m]: CTAs an SM and waves
    (shared memory) or the cluster plan (cluster size, co-resident
    clusters, waves)."""
    from timecrystal_tpu_torch.ops import jacobi_svd as J

    if variant == "smem":
        per_sm = J.smem_occupancy(n, m, X.dtype, X.device)
        return (f"{per_sm} CTAs an SM, {-(-B // (per_sm * SMS))} wave(s) "
                f"of {per_sm * SMS}")
    size, active = J.cluster_plan(B, n, m, X.dtype, X.device)
    return (f"clusters of {size} CTAs, {active} co-resident, "
            f"{-(-B // active)} wave(s)")


def phase_new_shapes():
    """Kernel 1 on the later paths' shapes (NEW_SHAPES).  At the path's exit
    tolerance: the device exit's sweeps and S against the host loop over
    the same kernel, bit for bit, and the twin loop's sweeps (within one).
    S against the twin loop (< 1e-5 x sigma_max) once both have converged
    (tol 3e-8, cap 24): at tol 1e-6 both loops stop unconverged, and two
    float32 rounding paths of an unconverged sweep differ in S by more
    (reported).  From TWIN_SUBSET_N rows the twin loops take the batch's
    first TWIN_SUBSET matrices (the path-tolerance loop beside the device
    exit over the same matrices).  Then one sweep and one call timed beside
    the bound and one torch.linalg.svd of the batch (and, for the shapes in
    ODD_LAYER, one sweep and one call of the odd bond layer's batch)."""
    import torch

    from timecrystal_tpu_torch.ops import jacobi_svd as J

    gen = torch.Generator(device="cuda").manual_seed(7)
    times, worst = {}, 0.0
    for B, n, m, tol in NEW_SHAPES:
        tol = tol or 3e-8
        if m == 2 * n:       # jacobi_proj's panel: the columns of theta Q0
            Q0 = J._fixed_projection_basis(m, n, torch.complex64, "cuda")
            X = (_tebd_like(gen, B, m, torch.complex64) @ Q0).mT.contiguous()
        else:
            X = _tebd_like(gen, B, n, torch.complex64).conj().resolve_conj()
        variant = J._sv_variant(B, n, m, X.element_size())
        big = n >= TWIN_SUBSET_N
        Xs = X[:TWIN_SUBSET].contiguous() if big else X
        counter = J.sweep_counter("cuda:0")
        s0, a0, c0 = int(counter), J.SV_SMEM_LAUNCHES, J.SV_CLUSTER_LAUNCHES
        Sk = _rows_sv(X, tol, J._sweep_loop)
        sw = int(counter) - s0
        ran = ("smem" if J.SV_SMEM_LAUNCHES > a0 else "") + (
            "cluster" if J.SV_CLUSTER_LAUNCHES > c0 else "")
        host, sw_host = _counted_host_loop(J._jacobi_sweep_cuda)
        Sh = _rows_sv(X, tol, host)
        s1 = int(counter)
        Sks = _rows_sv(Xs, tol, J._sweep_loop) if big else Sk
        sw_s = int(counter) - s1 if big else sw
        twin, sw_twin = _counted_host_loop(J._jacobi_sweep_torch)
        St = _rows_sv(Xs, tol, twin)
        err_tol = float((Sks - St).abs().max() / St.max())
        Sc = _rows_sv(X, 3e-8, J._sweep_loop, 24)
        Stc = _rows_sv(Xs, 3e-8, functools.partial(
            J._host_sweep_loop, sweep=J._jacobi_sweep_torch), 24)
        Scs = Sc[:Xs.shape[0]]
        err = float((Scs - Stc).abs().max() / Stc.max())
        worst = max(worst, float((Scs - Stc).abs().max()))
        same = bool(torch.equal(Sk, Sh))
        sub = (f"; twin loops on the first {Xs.shape[0]} matrices (device "
               f"exit there {sw_s} sweeps)" if big else "")
        print(f"[kernel-1 new shapes] [{B}, {n}, {m}] tol {tol:.0e} ({ran}): sweeps: "
              f"device exit {sw} ({'the cap of 12' if sw >= 12 else 'the exit'} "
              f"ended it), host loop over the kernel {sw_host[0]} (S "
              f"identical: {same}), twin loop {sw_twin[0]} (S err {err_tol:.2e} "
              f"x sigma_max){sub}; converged (tol 3e-8, cap 24): S err "
              f"{err:.2e} x sigma_max against the twin loop"
              f"{' (WITNESS_SHAPES)' if (B, n, m) in WITNESS_SHAPES else ' (< 1e-5)'}",
              flush=True)
        _check(ran == variant, f"[{B}, {n}, {m}] ran {ran!r}, not {variant!r}")
        if (B, n, m) in WITNESS_SHAPES:
            _witness_check(Xs, Scs, Stc, WITNESS_SHAPES[(B, n, m)])
        else:
            _check(err < 1e-5, f"S at [{B}, {n}, {m}] differs from the twin: {err}")
        _check(sw == sw_host[0] and same,
               f"device exit at [{B}, {n}, {m}]: {sw} sweeps, host loop "
               f"{sw_host[0]}")
        _check(abs(sw_s - sw_twin[0]) <= 1,
               f"sweeps at [{B}, {n}, {m}]: {sw_s}, twin {sw_twin[0]}")
        del Sks, St, Stc, Xs
        ms = [_event_ms(lambda x: J._jacobi_sweep_cuda(x, variant),
                        [(X.clone(),) for _ in range(5)]) for _ in range(2)]
        call_ms = _event_ms(lambda: _rows_sv(X, tol, J._sweep_loop),
                            [()] * (2 if big else 4))
        twin_ms = _event_ms(J._jacobi_sweep_torch, [(X.clone(),)] * (2 if big else 3))
        # torch.linalg.svd of the batch, timed for the shapes of LIBRARY_TIMED
        # (earlier shapes' times stand in PERF.md)
        lib = (f"{_library_ms(X, reps=1):.3f} ms" if (B, n, m) in LIBRARY_TIMED
               else "not timed here")
        bound, by, f64 = sweep_bound(B, n, m, with_v=False)
        times[(B, n, m)] = dict(ms=float(np.mean(ms)), call_ms=call_ms,
                                variant=variant)
        print(f"[sweep time] one sweep, complex64 [{B}, {n}, {m}], {variant} "
              f"variant ({_layout(B, n, m, variant, X)}): "
              f"{' / '.join(f'{t:.4f}' for t in ms)} ms; "
              f"one call ({sw} sweeps, tol {tol:.0e}) {call_ms:.3f} ms; twin "
              f"{twin_ms:.3f} ms per sweep, bound {bound:.4f} ms ({by}; FP64 "
              f"FLOPs {f64:.4f} ms), torch.linalg.svd {lib}", flush=True)
        if (B, n, m) in ODD_LAYER:           # the odd bond layer's call shape
            Bo = ODD_LAYER[(B, n, m)]
            Xo = X[:Bo].contiguous()
            s1 = int(counter)
            Sko = _rows_sv(Xo, tol, J._sweep_loop)
            sw_o = int(counter) - s1
            ms_o = _event_ms(lambda x: J._jacobi_sweep_cuda(x, variant),
                             [(Xo.clone(),) for _ in range(3)])
            (_, call_o) = _timed(lambda: _rows_sv(Xo, tol, J._sweep_loop))
            call_o *= 1e3
            bound_o = sweep_bound(Bo, n, m, with_v=False)[0]
            _check(bool(torch.isfinite(Sko).all()), f"[{Bo}, {n}, {m}] S")
            print(f"[sweep time] one sweep, complex64 [{Bo}, {n}, {m}], "
                  f"{variant} variant ({_layout(Bo, n, m, variant, Xo)}): "
                  f"{ms_o:.4f} ms; one call ({sw_o} sweeps, tol {tol:.0e}) "
                  f"{call_o:.3f} ms; bound {bound_o:.4f} ms", flush=True)
            del Xo, Sko
        del X, Sk, Sh, Sc
    return times, worst


def _settled_state():
    """bench.py's _steady_state on the card: L=40, chi=256, theta=0.9 pi,
    h=0.3, tau=1, seed 42 fields (float32), Neel, svd_min=1e-7, 40 merged
    periods on 'jacobi'.  Returns (psi, gates, tp, kernel-1 counts)."""
    import torch

    from timecrystal_tpu_torch.core.mps import create_initial_state
    from timecrystal_tpu_torch.core.truncate import TruncParams
    from timecrystal_tpu_torch.dynamics.tebd import evolve_floquet_scan
    from timecrystal_tpu_torch.models.kicked_ising import (
        draw_disorder_reference, make_floquet_gates)

    c = CONFIG
    h = draw_disorder_reference(c["L"], c["h"], c["seed"])
    gates = make_floquet_gates(1.0, torch.as_tensor(h, dtype=torch.float32,
                                                    device="cuda"),
                               c["tau"], theta=c["theta_frac"] * np.pi,
                               dtype=torch.complex64)
    tp = TruncParams(chi_max=0, svd_min=c["svd_min"], svd_method="jacobi")
    psi0 = create_initial_state(c["L"], "neel", chi=c["chi"],
                                dtype=torch.complex64, device="cuda")
    _reset_kernel1_counts()              # the settle's counts start here
    (psi, tr), dt = _timed(lambda: evolve_floquet_scan(
        psi0, gates, STEADY["n_settle"], tp, frame="merged"))
    k1 = _kernel1_counts()
    chi_eff = int(tr["max_chi"][-1])
    print(f"[steady-settle] L={c['L']} chi={c['chi']} {STEADY['n_settle']} merged "
          f"periods on 'jacobi' from Neel: {dt:.1f} s "
          f"({STEADY['n_settle'] / dt:.3f} periods/s); max_chi at the end "
          f"{chi_eff}; {k1['sweeps']} sweeps in {k1['launches']} launches "
          f"({k1['cluster']} cluster)", flush=True)
    _check(chi_eff == c["chi"], f"the settled state is not saturated: {chi_eff}")
    _check(k1["sweeps"] > 0, "the settle ran no kernel-1 sweep")
    return psi, gates, tp, k1


def _run_steady(psi, gates, tp, n):
    """n merged periods from psi, their traces fetched to the host."""
    from timecrystal_tpu_torch.dynamics.tebd import evolve_floquet_scan, to_host

    psi, tr = evolve_floquet_scan(psi, gates, n, tp, frame="merged")
    return psi, to_host(tr)


def _time_steady(psi, gates, tp, n):
    """bench.py's _time_steady: best of 3 periods/s after one run, and the
    last run's traces."""
    best, tr = 0.0, None
    for _ in range(3):
        (_, tr), dt = _timed(lambda: _run_steady(psi, gates, tp, n))
        best = max(best, n / dt)
    return best, tr


def phase_steady(psi, gates, tp):
    """The saturated steady leg: from the settled state, STEADY['n_steady']
    merged periods per method, best of 3 (bench.py's run_steady,
    run_steady_exact).  One counted run first: SVD calls (csvd_topk calls),
    kernel-1 sweep loops, sweeps (device counter), launches per variant,
    NS-polish host reads and host syncs (torch's sync debug mode).  Returns
    each run's kernel-1 launches and periods/s."""
    from timecrystal_tpu_torch.core import truncate as TR
    from timecrystal_tpu_torch.ops import csvd as CS
    from timecrystal_tpu_torch.ops import jacobi_svd as J

    n, L = STEADY["n_steady"], CONFIG["L"]
    out = {}
    for method in STEADY_METHODS:
        tpm = tp._replace(svd_method=method)
        _reset_kernel1_counts()              # this run's counts start here
        J.NS_HOST_READS = 0
        svd_calls, csvd_topk = [0], TR.csvd_topk

        def counted(*a, **kw):
            svd_calls[0] += 1
            return csvd_topk(*a, **kw)

        TR.csvd_topk = counted
        loops, restore = _sweep_loops_counted()
        try:
            (_, tr), syncs = _with_sync_count(
                lambda: _run_steady(psi, gates, tpm, n))
        finally:
            TR.csvd_topk = csvd_topk
            restore()
        c, ns_reads = _kernel1_counts(), J.NS_HOST_READS
        rate, tr = _time_steady(psi, gates, tpm, n)
        for k, v in tr.items():
            _check(bool(np.all(np.isfinite(v))), f"{method}: non-finite {k}")
        _check(c["sweeps"] > 0 and c["launches"] > 0 and c["host_reads"] == 0,
               f"{method} did not run kernel 1: {c}")
        cert = mode = ""
        if method == "jacobi_core_fast":
            mode = f" ({CS.FAST_QUINTIC_PRECISION} quintic)"
            cert = (f"; certificate max trunc_err + {L - 1} x "
                    f"{CERT_SLACK_PER_BOND:.0e} = "
                    f"{float(np.max(tr['trunc_err'])) + (L - 1) * CERT_SLACK_PER_BOND:.4e}"
                    f" per period (max trunc_err {float(np.max(tr['trunc_err'])):.3e})")
        print(f"[steady] {method}{mode}: "
              f"{rate:.3f} periods/s (best of 3, {n} periods); "
              f"{svd_calls[0] / n:.1f} SVD calls per period ({svd_calls[0]} incl. "
              f"the frame's entry/exit), {loops[0]} kernel-1 sweep loops, "
              f"{c['sweeps']} sweeps ({c['sweeps'] / max(loops[0], 1):.2f} per "
              f"loop, {c['sweeps'] / max(svd_calls[0], 1):.2f} per SVD call) in "
              f"{c['launches']} launches ({c['smem']} smem, {c['cluster']} "
              f"cluster); host syncs {syncs / n:.1f} per period ({syncs}; "
              f"NS-polish reads {ns_reads}){cert}", flush=True)
        out[method] = dict(rate=rate, launches=c)
    # where the time goes: jacobi_core_fast and 'jacobi'
    for method in ("jacobi_core_fast", "jacobi"):
        rate = out[method]["rate"]
        wall, ms, launches, n_sync = _profile(
            lambda: _run_steady(psi, gates, tp._replace(svd_method=method), n),
            KERNEL1_CLASSES + (MATMUL_CLASS,))
        print(f"[steady-profile] {method}, {n} periods: "
              f"{_profile_line(wall, ms, n / rate * 1e3)}; kernel-1 launches "
              f"{launches['kernel 1 cluster']} cluster; {n_sync} CUDA runtime "
              f"synchronize calls", flush=True)
    return out


def phase_closed_loop(psi, gates, tp):
    """bench.py's closed-loop gate (baselines/jacobi_core_closedloop.py):
    STEADY['n_closed'] merged periods from the settled state on 'jacobi'
    and on each projected method; max |d sz|, |d stag| and |d LE| against
    'jacobi'.  Each projected method must stay within CLOSED_LOOP_FACTOR x
    the reference's class.  Returns each run's kernel-1 counts."""
    n, L = STEADY["n_closed"], CONFIG["L"]
    signs = np.where(np.arange(L) % 2 == 0, 1.0, -1.0)
    counts = {}

    def run(method):
        _reset_kernel1_counts()              # this run's counts start here
        (_, tr), dt = _timed(lambda: _run_steady(
            psi, gates, tp._replace(svd_method=method), n))
        counts[method] = _kernel1_counts()
        le = tr["loschmidt_echo"]
        _check(bool(np.all(np.isfinite(tr["sz_sites"]))) and float(le.min()) >= 0
               and float(le.max()) <= 1 + 1e-5, f"{method} closed-loop traces")
        return tr["sz_sites"], (tr["sz_sites"] * signs).mean(-1), le, dt

    sz0, st0, le0, dt0 = run("jacobi")
    print(f"[steady-closedloop] {n} periods from the settled state, 'jacobi' "
          f"{dt0:.1f} s; staggered (last 4) {np.round(st0[-4:], 5).tolist()}",
          flush=True)
    for method in STEADY_METHODS:
        if method == "jacobi":
            continue
        sz, st, le, dt = run(method)
        d = (float(np.abs(sz - sz0).max()), float(np.abs(st - st0).max()),
             float(np.abs(le - le0).max()))
        b_st, b_le = (CLOSED_LOOP_FACTOR * x for x in CLOSED_LOOP_CLASS[method])
        ok = d[1] <= b_st and d[2] <= b_le
        print(f"[steady-closedloop] {method}: max |d sz| {d[0]:.3e}, |d stag| "
              f"{d[1]:.3e} (<= {b_st:.2e}), |d LE| {d[2]:.3e} (<= {b_le:.2e}): "
              f"{'within' if ok else 'OUTSIDE'} {CLOSED_LOOP_FACTOR:g}x the "
              f"reference's class; {dt:.1f} s", flush=True)
        _check(ok, f"{method} leaves the closed-loop class: {d}")
    return counts


def phase_steady_chi512(psi, gates, tp):
    """bench.py's run_steady_chi512 on 'jacobi_core': the settled state
    padded to chi=512, STEADY['n_settle512'] settle periods, then
    STEADY['n_steady512'] timed periods, best of 3 (the core at
    [20, 512, 512]).  Returns the kernel-1 counts of the settle and the
    settled chi=512 state."""
    from timecrystal_tpu_torch.core.mps import pad_mps

    tpc = tp._replace(svd_method="jacobi_core")
    _reset_kernel1_counts()
    (psi2, tr), dt = _timed(lambda: _run_steady(pad_mps(psi, 2 * psi.chi), gates,
                                                tpc, STEADY["n_settle512"]))
    c = _kernel1_counts()
    rate, tr2 = _time_steady(psi2, gates, tpc, STEADY["n_steady512"])
    for t in (tr, tr2):
        _check(bool(np.all(np.isfinite(t["sz_sites"]))), "chi512 traces")
    print(f"[steady-chi512] chi=512 (n=1024, core [20, 512, 512]) on "
          f"'jacobi_core': settle {STEADY['n_settle512']} periods {dt:.1f} s "
          f"(max_chi {int(tr['max_chi'][-1])}), {rate:.3f} periods/s (best of "
          f"3, {STEADY['n_steady512']} periods); settle: {c['sweeps']} sweeps in "
          f"{c['launches']} launches ({c['cluster']} cluster)", flush=True)
    return c, psi2


def phase_steady_exact_chi512(psi2, gates):
    """bench.py's exact chi=512 leg (run_steady_chi512 with
    TruncParams(chi_max=0, svd_min=1e-7) and svd_method 'auto', the Jacobi
    kernel on the card): from [steady-chi512]'s settled chi=512 state, one
    untimed merged period, then STEADY['n_exact512'] periods timed and
    counted (kernel 1 on [20/19, 1024, 1024]: cluster launches, sweeps per
    sweep loop against the cap, host syncs).  The traces must be finite,
    LE in [0, 1] and max_chi <= 512; the same periods on 'jacobi_core' from
    the same state lie within CLOSED_LOOP_FACTOR x its closed-loop class in
    staggered magnetization and LE.  Returns the timed run's kernel-1
    counts."""
    from timecrystal_tpu_torch.core.truncate import TruncParams

    n, L = STEADY["n_exact512"], CONFIG["L"]
    tpe = TruncParams(chi_max=0, svd_min=CONFIG["svd_min"])
    (psi3, _), dt_warm = _timed(lambda: _run_steady(psi2, gates, tpe, 1))
    _reset_kernel1_counts()
    loops, restore = _sweep_loops_counted()
    try:
        ((_, tr), syncs), dt = _timed(lambda: _with_sync_count(
            lambda: _run_steady(psi3, gates, tpe, n)))
    finally:
        restore()
    c = _kernel1_counts()
    (_, trc), dt_core = _timed(lambda: _run_steady(
        psi3, gates, tpe._replace(svd_method="jacobi_core"), n))
    signs = np.where(np.arange(L) % 2 == 0, 1.0, -1.0)
    le = tr["loschmidt_echo"]
    d_st = float(np.abs(((tr["sz_sites"] - trc["sz_sites"]) * signs).mean(-1)).max())
    d_le = float(np.abs(le - trc["loschmidt_echo"]).max())
    b_st, b_le = (CLOSED_LOOP_FACTOR * x for x in CLOSED_LOOP_CLASS["jacobi_core"])
    per_loop = c["sweeps"] / max(loops[0], 1)
    print(f"[steady-exact-chi512] chi=512 exact leg (svd_method 'auto', "
          f"chi_max=0, svd_min {CONFIG['svd_min']:.0e}): {n / dt:.4f} periods/s "
          f"over a {n}-period run, the merged frame's entry and exit included "
          f"(not a steady-state rate; {dt:.2f} s after one untimed period, "
          f"{dt_warm:.2f} s); kernel 1: {loops[0]} sweep loops of [20/19, 1024, "
          f"1024], {c['sweeps']} sweeps ({per_loop:.2f} a loop; the cap of 12 "
          f"ended {'every' if per_loop >= 12 else 'not every'} loop) in "
          f"{c['launches']} launches ({c['cluster']} cluster, {c['smem']} smem); "
          f"host syncs {syncs}; max_chi {int(tr['max_chi'].max())}; against "
          f"'jacobi_core' on the same periods ({n / dt_core:.3f} periods/s): "
          f"|d stag| {d_st:.3e} (<= {b_st:.2e}), |d LE| {d_le:.3e} (<= "
          f"{b_le:.2e})", flush=True)
    for k, v in tr.items():
        _check(bool(np.all(np.isfinite(v))), f"[steady-exact-chi512] non-finite {k}")
    _check(float(le.min()) >= 0 and float(le.max()) <= 1 + 1e-5,
           "[steady-exact-chi512] LE")
    _check(int(tr["max_chi"].max()) <= 512, "[steady-exact-chi512] max_chi")
    _check(c["cluster"] > 0 and c["sweeps"] > 0 and c["host_reads"] == 0,
           f"[steady-exact-chi512] did not run kernel 1's cluster variant: {c}")
    _check(d_st <= b_st and d_le <= b_le,
           f"[steady-exact-chi512] leaves jacobi_core's class: {d_st}, {d_le}")
    return c


def _grid_reference(h_fields, taus, spec, thetas, idx, correlation_site=None,
                    dtype="float64", two_time_anchor=None):
    """(traces, seconds) of the grid points ``idx`` through evolve_batch in
    complex128 (``dtype``) on the host CPU with LAPACK's SVD ('native'): a
    run that shares no kernel, precision or device with the card's."""
    from timecrystal_tpu_torch.parallel.sweep import _basis_indices, evolve_batch

    t0 = time.perf_counter()
    ref = evolve_batch(
        np.asarray(h_fields)[idx], np.asarray(taus)[idx],
        _basis_indices(spec.L, "neel"),
        spec._replace(dtype=dtype, tp=spec.tp._replace(svd_method="native")),
        thetas=None if thetas is None else np.asarray(thetas)[idx],
        correlation_site=correlation_site, two_time_anchor=two_time_anchor,
        device="cpu")
    return ref, time.perf_counter() - t0


def _reference_check(tag, traces, h_fields, taus, spec, thetas, idx,
                     correlation_site=None, gate_truncated=True,
                     two_time_anchor=None):
    """The card's ``traces`` of the grid points ``idx`` against the same
    points in complex128 on the host CPU (``_grid_reference``): max |d| of
    sz and LE (and zz_corr with ``correlation_site``, zz2t_re and zz2t_im
    with ``two_time_anchor``) before the reference first truncates and over
    all rows, checked against GRID_REFERENCE_TOL (the all-rows bound only
    with ``gate_truncated``).  Returns the reference."""
    ref, dt_ref = _grid_reference(h_fields, taus, spec, thetas, idx,
                                  correlation_site,
                                  two_time_anchor=two_time_anchor)
    keys = ("sz_sites", "loschmidt_echo") + (
        () if correlation_site is None else ("zz_corr",)) + (
        () if two_time_anchor is None else ("zz2t_re", "zz2t_im"))
    exact = np.cumsum(ref["trunc_err"] > GRID_EXACT_TRUNC, axis=1) == 0
    diff = {k: np.abs(traces[k][idx] - ref[k]) for k in keys}
    d_ex = {k: float(np.max(v[exact])) for k, v in diff.items()}
    d_all = {k: float(np.max(v)) for k, v in diff.items()}
    tol = GRID_REFERENCE_TOL
    names = {"sz_sites": "sz", "loschmidt_echo": "LE", "zz_corr": "zz_corr",
             "zz2t_re": "zz2t_re", "zz2t_im": "zz2t_im"}
    ex = ", ".join(f"|d {names[k]}| {v:.2e}" for k, v in d_ex.items())
    al = ", ".join(f"|d {names[k]}| {v:.2e}" for k, v in d_all.items())
    per_point = np.max([v.reshape(len(idx), -1).max(1) for v in diff.values()], 0)
    all_bound = (f"< {tol['truncated']:.0e}" if gate_truncated else
                 f"per point {[f'{x:.2e}' for x in per_point]}, bounded by "
                 f"the caller")
    print(f"[{tag}] points {idx.tolist()} against complex128 LAPACK on the "
          f"host CPU ({dt_ref:.1f} s): before the reference truncates "
          f"(> {GRID_EXACT_TRUNC:.0e} a bond; {exact.sum(1).tolist()} of "
          f"{exact.shape[1]} rows) max {ex} (< {tol['exact']:.0e}); all rows "
          f"max {al} ({all_bound}); max trunc_err "
          f"{float(traces['trunc_err'][idx].max()):.2e} (card), "
          f"{float(ref['trunc_err'].max()):.2e} (host), max_chi "
          f"{int(traces['max_chi'][idx].max())} / {int(ref['max_chi'].max())}",
          flush=True)
    _check(bool(exact[:, :5].all()), f"{tag}: the reference truncates in the "
           f"first 4 periods")
    _check(max(d_ex.values()) < tol["exact"] and
           (not gate_truncated or max(d_all.values()) < tol["truncated"]),
           f"{tag} differs from the complex128 host run: {d_ex}, {d_all}")
    return ref


def _grid_run(tag, h_fields, taus, spec, thetas=None):
    """evolve_batch + ensemble_a2t of one grid on the card, with kernel 1's
    counts and the host syncs; A2T against the host recipe per point, and
    GRID['n_reference'] points' sz and LE traces against the same points in
    complex128 on the host CPU (``_grid_reference``)."""
    import torch

    from timecrystal_tpu_torch.core.observables import \
        extract_subharmonic_amplitude
    from timecrystal_tpu_torch.ops import jacobi_svd as J
    from timecrystal_tpu_torch.parallel.sweep import (_basis_indices,
                                                      ensemble_a2t,
                                                      evolve_batch)

    P = len(taus)

    def run():
        return evolve_batch(h_fields, taus, _basis_indices(spec.L, "neel"),
                            spec, thetas=thetas, device="cuda")

    # the first call in a process pays one-time start-up (kernel modules,
    # cuBLAS and FFT plans for new shapes): timed apart, then the run counted
    _, dt_first = _timed(run)
    _reset_kernel1_counts()                  # this path's counts start here
    (traces, syncs), dt = _timed(lambda: _with_sync_count(run))
    c = _kernel1_counts()
    a2t = ensemble_a2t(traces, taus, device="cuda")
    times = np.arange(spec.n_periods + 1)[None] * (2.0 * np.asarray(taus))[:, None]
    host = np.array([extract_subharmonic_amplitude(
        times[r], traces["staggered_magnetization"][r], 2.0 * taus[r])
        for r in range(P)])
    a2t_err = float(np.max(np.abs(a2t - host)))
    for k, v in traces.items():
        _check(bool(np.all(np.isfinite(v))), f"{tag}: non-finite {k}")
    le = traces["loschmidt_echo"]
    _check(float(le.min()) >= 0 and float(le.max()) <= 1 + 1e-5, f"{tag} LE")
    _check(c["smem"] > 0 and c["sweeps"] > 0 and c["host_reads"] == 0,
           f"{tag} did not run kernel 1's shared-memory variant: {c}")
    _check(a2t_err < 1e-5, f"{tag} A2T differs from the host recipe: {a2t_err}")
    idx = np.linspace(0, P - 1, GRID["n_reference"]).round().astype(int)
    ref = _reference_check(tag, traces, h_fields, taus, spec, thetas, idx)
    n = 2 * spec.chi
    per_sm = J.smem_occupancy(n, n, torch.complex64, "cuda")
    even = P * len(range(0, spec.L - 1, 2))
    print(f"[{tag}] {P} points, L={spec.L} chi_pad={spec.chi} (n={n}) "
          f"{spec.n_periods} periods: {P / dt:.2f} points/s ({dt:.2f} s, "
          f"{P * spec.n_periods / dt:.1f} chain-periods/s; the process's first "
          f"run {dt_first:.2f} s); {c['calls']} SVD "
          f"calls of [{even}, {n}, {n}] and [{P * (spec.L - 1) - even}, {n}, {n}] "
          f"({per_sm} CTAs an SM: {-(-even // (per_sm * SMS))} wave(s) of "
          f"{per_sm * SMS}), {c['sweeps']} sweeps ({c['sweeps'] / max(c['calls'], 1):.2f} "
          f"per call) in {c['launches']} launches ({c['smem']} smem); host syncs "
          f"{syncs}; A2T min/max {a2t.min():.4f}/{a2t.max():.4f}, max |A2T - "
          f"host recipe| {a2t_err:.2e} (< 1e-5); max_chi "
          f"{int(traces['max_chi'].max())}", flush=True)
    # where the time goes: the first GRID['n_profiled'] periods (the
    # profiler's post-processing of all 80 takes tens of seconds)
    n = GRID["n_profiled"]
    wall, ms, _, n_sync = _profile(lambda: evolve_batch(
        h_fields, taus, _basis_indices(spec.L, "neel"),
        spec._replace(n_periods=n), thetas=thetas, device="cuda"),
        KERNEL1_CLASSES + (MATMUL_CLASS,))
    print(f"[{tag}-profile] {n} periods (the unprofiled reference: {n}/"
          f"{spec.n_periods} of the run above): "
          f"{_profile_line(wall, ms, dt * n / spec.n_periods * 1e3)}; {n_sync} "
          f"CUDA runtime synchronize calls", flush=True)
    return c, dict(idx=idx, traces=ref)


def phase_phase_grid():
    """The phase diagram's grid: phase_grid_batch + evolve_batch at
    GRID_HARDCODED (L=16, chi_pad=32, 80 periods, theta=pi, chi_max=24),
    12 h x 10 T, then ensemble_a2t on the staggered magnetization.  Returns
    kernel 1's counts and the complex128 host reference of its points."""
    from timecrystal_tpu_torch.core.truncate import TruncParams
    from timecrystal_tpu_torch.parallel.sweep import SweepSpec, phase_grid_batch

    g = GRID
    spec = SweepSpec(L=g["L"], chi=g["chi"], n_periods=g["n_periods"],
                     theta=float(np.pi), dtype="float32",
                     tp=TruncParams(chi_max=g["chi_max"], svd_min=g["svd_min"],
                                    trunc_cut=g["trunc_cut"]))
    hf, taus, _, _ = phase_grid_batch(np.linspace(*g["h"]), np.linspace(*g["T"]),
                                      spec, disorder_seed=g["seed"])
    return _grid_run("phase-grid", hf, taus, spec)


def phase_drive_grid():
    """One 40-point chunk of the drive-strength diagram: evolve_batch with a
    per-realization kick theta = pi (1 - eps), eps x h on the reference's
    per-point disorder (one seed-42 pattern scaled by h), T_DRIVE=2,
    chi_pad=48, 80 periods: the batch of analysis/phase_diagram.py's
    drive_grid_batch with config.txt."""
    from timecrystal_tpu_torch.analysis import phase_diagram as PD

    d = DRIVE
    spec, hf, taus, thetas, _, _ = PD.drive_grid_batch(
        np.linspace(*d["eps"]), np.linspace(*d["h"]), _config_params(),
        chi_pad=d["chi"])
    return _grid_run("drive-grid", hf, taus, spec, thetas=thetas)[0]


# the application layer (analysis/) at the reference's sizes with
# config.txt: Figures A-D's traces against the same simulation in
# complex128 on the host CPU (rank-1 theta = pi dynamics: float32 rounding
# only); the phase diagram's scores on the card against the complex128
# host points of [phase-grid]; the drive diagram's default 12 x 10 grid
FIGURE_TOL = 1e-4
SCORE_TOL = 1e-3
FIGURE_SIMS = (("A", "simulate_perfect_dtc", 64), ("B", "simulate_disordered_dtc", 64),
               ("C", "simulate_dephasing_dtc", 64), ("D", "simulate_multi_site_dtc", 16))
DRIVE_DIAGRAM = dict(eps=(0.0, 0.5, 12), h=(0.0, 0.8, 10))
# the drive diagram's reference points after truncation, where truncated
# entangling dynamics amplifies float32 rounding: the card's max |d sz|
# from complex128 is held against a float32 witness run beside it
# (complex64 with LAPACK's SVD on the host CPU, the same points).  Float32
# one-sided Jacobi drifts further than float32 LAPACK there, in both
# packages: at these points (eps 0, 0.18, 0.32, 0.5) the JAX package's
# Pallas kernel in interpret mode leaves complex128 DRIVE_JAX_OVER_WITNESS
# times as far as the port's complex64 LAPACK run does (on the CPU,
# `tests/probe_torch_faults.py drift --periods 80` at these points: the
# command and its numbers are in PERF.md; the twin drifts as far as JAX).
# The card may drift twice that ratio times its witness,
# and at least GRID_REFERENCE_TOL['exact'].  The diagram's outputs: A2T
# and the subharmonic weight to DRIVE_SCORE_TOL where complex128 finds a
# DTC (weight >= DTC_WEIGHT), and the card's DTC verdict equal to
# complex128's at every point (where there is no DTC, A2T is a ratio to
# the largest bin of a decorrelated trace: 0.105 against 0.360 measured)
DRIVE_JAX_OVER_WITNESS = (0.143, 1.30, 12.3, 1.21)
DTC_WEIGHT, DRIVE_SCORE_TOL = 0.9, 1e-2


class _RunInfo(logging.Handler):
    """Keeps the info dict of every evolve_floquet_auto run that logs one
    (its DEBUG record's ``run_info``): the chi the figures reached."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.infos = []

    def emit(self, record):
        self.infos.append(record.run_info)


def _config_params():
    from timecrystal_tpu_torch.utils.config import read_parameters

    return read_parameters(str(REPO / "config.txt"))


def phase_figures():
    """Figures A-D's simulations (analysis/figures.py) on the card at the
    reference's sizes (A, B, C: L=64; D: L=16; 200 periods; chi cap
    CHI_MAX=256 of config.txt), each against the same function in
    complex128 on the host CPU; the peak of Figure A's spectrum at w/2."""
    import torch

    from timecrystal_tpu_torch.analysis import figures as F
    from timecrystal_tpu_torch.core.observables import \
        calculate_fourier_spectrum

    params = _config_params()
    runs = _RunInfo()
    tebd_log = logging.getLogger("timecrystal_tpu_torch.dynamics.tebd")
    level = tebd_log.level
    tebd_log.addHandler(runs)
    tebd_log.setLevel(logging.DEBUG)
    total = {"smem": 0, "cluster": 0}
    try:
        for key, name, L in FIGURE_SIMS:
            fn = getattr(F, name)
            _reset_kernel1_counts()          # this figure's counts start here
            out, dt = _timed(lambda: fn(params, device="cuda"))
            c, info = _kernel1_counts(), runs.infos[-1]
            t0 = time.perf_counter()
            with _host_threads():
                host = fn(params, device="cpu", dtype=torch.complex128)
            dt_host, host_info = time.perf_counter() - t0, runs.infos[-1]
            series = out[1:] if key != "D" else out[1]
            host_series = host[1:] if key != "D" else host[1]
            err = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
                      for a, b in zip(series, host_series))
            n = len(out[0]) - 1
            _check(out[0] == host[0] and n == 200, f"[figures] {key} times")
            _check(all(np.all(np.isfinite(a)) for a in series),
                   f"[figures] {key} non-finite")
            _check(c["smem"] + c["cluster"] > 0 and c["sweeps"] > 0,
                   f"[figures] {key} ran no kernel-1 sweep: {c}")
            _check(err < FIGURE_TOL, f"[figures] {key} differs from complex128: {err}")
            for v in total:
                total[v] += c[v]
            print(f"[figures] {key} ({name}, L={L}, {n} periods, chi cap "
                  f"{params['CHI_MAX']}): {dt:.2f} s, {n / dt:.1f} periods/s; chi "
                  f"padded {info['chi_pad_used']} ({len(info['chi_escalations'])} "
                  f"escalations), max_chi {max(info['bond_dimensions'])} (Schmidt "
                  f"values > 1e-14; {max(host_info['bond_dimensions'])} in "
                  f"complex128); kernel 1: {c['calls']} SVD "
                  f"calls, {c['sweeps']} sweeps in {c['launches']} launches "
                  f"({c['smem']} smem, {c['cluster']} cluster); max |d| of the "
                  f"{len(series)} traces against complex128 on the host CPU "
                  f"({dt_host:.1f} s) {err:.2e} (< {FIGURE_TOL:.0e})", flush=True)
            if key == "A":
                f, pw = calculate_fourier_spectrum(np.asarray(out[0]),
                                                   np.asarray(out[1]), 4.0)
                peak = float(f[np.argmax(pw)])
                _check(abs(peak - 0.5) <= 1.0 / n,
                       f"[figures] A's spectral peak at {peak}, not w/2")
                print(f"[figures] A: the spectrum of the staggered "
                      f"magnetization peaks at w/w_drive = {peak:.4f} (w/2 to "
                      f"one bin, 1/{n})", flush=True)
    finally:
        tebd_log.removeHandler(runs)
        tebd_log.setLevel(level)
    return total


def phase_phase_diagram(grid_ref):
    """The phase diagram's 120 points through sweep_phase_grid (evolution
    and scoring, analysis/phase_diagram.py) with config.txt; the records
    against detection.score_phase_point on their traces, and the four
    complex128 host points of [phase-grid] scored against the card's."""
    from timecrystal_tpu_torch.analysis import phase_diagram as PD
    from timecrystal_tpu_torch.analysis.detection import (score_grid,
                                                          score_phase_point)

    params, hc = _config_params(), PD.GRID_HARDCODED
    h_values = np.linspace(*hc["h_range"], hc["n_points"][0])
    T_values = np.linspace(*hc["T_range"], hc["n_points"][1])
    _reset_kernel1_counts()                  # this path's counts start here
    res, dt = _timed(lambda: PD.sweep_phase_grid(h_values, T_values, params,
                                                 device="cuda"))
    c = _kernel1_counts()
    recs, tr = res["records"], res["traces"]
    P, n1 = len(recs), tr["loschmidt_echo"].shape[1]
    periods = res["Ts"] / float(params.get("J", 1.0))      # 2 tau
    times = np.arange(n1)[None] * periods[:, None]
    host = [score_phase_point(tr["loschmidt_echo"][g], times[g], tr["max_chi"][g],
                              res["hs"][g], res["Ts"][g], periods[g])
            for g in range(P)]
    d_host = max(abs(r["A2T"] - h["A2T"]) for r, h in zip(recs, host))
    idx, ref = grid_ref["idx"], grid_ref["traces"]
    ref_recs = score_grid(ref, times[idx], res["hs"][idx], res["Ts"][idx],
                          periods[idx])
    # the stringent LE score and A2T, which also carries the entanglement
    # penalty of avg max_chi: it counts Schmidt values above 1e-14, so it
    # reads the SVD's noise floor (float32 LAPACK leaves junk there, the
    # Jacobi kernel does not: PERF.md)
    d_ref = max(abs(recs[g][k] - r[k]) for g, r in zip(idx, ref_recs)
                for k in ("dtc_score_raw", "A2T"))

    def show(key, rs):
        return [round(float(r[key]), 4) for r in rs]

    a2t = np.array([r["A2T"] for r in recs])
    n_dtc = int(sum(r["dtc_score_raw"] > 0 for r in recs))
    _check(P == 120 and all(r["success"] for r in recs), "[phase-diagram] records")
    _check(c["smem"] > 0 and c["host_reads"] == 0,
           f"[phase-diagram] did not run kernel 1's shared-memory variant: {c}")
    _check(d_host < 1e-12, f"[phase-diagram] records differ from the recipe: {d_host}")
    _check(d_ref < SCORE_TOL, f"[phase-diagram] the scores differ from the "
           f"complex128 host points: {d_ref}")
    print(f"[phase-diagram] sweep_phase_grid, {P} points (L={hc['n_sites']}, "
          f"{hc['n_periods']} periods, chi cap {hc['max_chi']}) on the card: "
          f"{P / dt:.2f} points/s ({dt:.2f} s, scoring included); DTC points "
          f"(stringent score > 0) {n_dtc}; A2T min/mean/max {a2t.min():.4f}/"
          f"{a2t.mean():.4f}/{a2t.max():.4f}; records against score_phase_point "
          f"on their traces max |d A2T| {d_host:.1e}; kernel 1: {c['calls']} "
          f"SVD calls, {c['sweeps']} sweeps in {c['launches']} launches "
          f"({c['smem']} smem)", flush=True)
    card = [recs[g] for g in idx]
    print(f"[phase-diagram] points {idx.tolist()}, card / complex128 host "
          f"traces of [phase-grid]: stringent score {show('dtc_score_raw', card)} / "
          f"{show('dtc_score_raw', ref_recs)}; avg max_chi "
          f"{show('avg_bond_dim', card)} / {show('avg_bond_dim', ref_recs)}; "
          f"entanglement penalty {show('entanglement_penalty', card)} / "
          f"{show('entanglement_penalty', ref_recs)}; A2T {show('A2T', card)} / "
          f"{show('A2T', ref_recs)}; max |d| of the score and A2T {d_ref:.2e} "
          f"(< {SCORE_TOL:.0e})", flush=True)
    return c


def phase_drive_diagram():
    """generate_drive_diagram's default grid through sweep_drive_grid: 12 eps
    in [0, 0.5] x 10 h in [0, 0.8], chi_pad=48, one program; four points
    against complex128 on the host CPU: the traces before truncation (to
    1e-4) and after it (against a complex64 LAPACK witness,
    ``DRIVE_JAX_OVER_WITNESS``), the diagram's A2T and subharmonic weight
    (``DRIVE_SCORE_TOL``)."""
    from timecrystal_tpu_torch.analysis import phase_diagram as PD
    from timecrystal_tpu_torch.core.observables import (
        extract_subharmonic_amplitude, subharmonic_weight_fraction)

    params, d = _config_params(), DRIVE_DIAGRAM
    eps_values, h_values = np.linspace(*d["eps"]), np.linspace(*d["h"])
    _reset_kernel1_counts()                  # this path's counts start here
    res, dt = _timed(lambda: PD.sweep_drive_grid(eps_values, h_values, params,
                                                 device="cuda"))
    c = _kernel1_counts()
    tr, P = res["traces"], len(res["records"])
    # the same points' fields and kicks, from what the entry returns
    spec, hf, taus, thetas, eps, hs = PD.drive_grid_batch(res["eps"], res["hs"],
                                                          params)
    for k, v in tr.items():
        _check(bool(np.all(np.isfinite(v))), f"[drive-diagram] non-finite {k}")
    _check(P == 120 and res["A2T"].shape == (12, 10), "[drive-diagram] grid")
    _check(c["smem"] > 0 and c["host_reads"] == 0,
           f"[drive-diagram] did not run kernel 1's shared-memory variant: {c}")
    a2t, w2t = res["A2T"], res["subharmonic_weight"]
    print(f"[drive-diagram] sweep_drive_grid, {P} points (12 eps in [0, 0.5] x "
          f"10 h in [0, 0.8], L={spec.L}, chi_pad={spec.chi}, chi cap "
          f"{spec.tp.chi_max}, {spec.n_periods} periods, one program) on the "
          f"card: {P / dt:.2f} points/s ({dt:.2f} s); A2T min/max "
          f"{a2t.min():.4f}/{a2t.max():.4f}, A2T at eps = 0 / 0.5 (mean over h) "
          f"{a2t[0].mean():.4f} / {a2t[-1].mean():.4f}; subharmonic weight "
          f"min/max {w2t.min():.4f}/{w2t.max():.4f}; kernel 1: {c['calls']} SVD "
          f"calls, {c['sweeps']} sweeps ({c['sweeps'] / max(c['calls'], 1):.2f} "
          f"per call) in {c['launches']} launches ({c['smem']} smem)", flush=True)
    idx = np.linspace(0, P - 1, GRID["n_reference"]).round().astype(int)
    ref = _reference_check("drive-diagram", tr, hf, taus, spec, thetas, idx,
                           gate_truncated=False)
    wit, dt_wit = _grid_reference(hf, taus, spec, thetas, idx, dtype="float32")

    def drift(sz):                            # max |d sz| per point
        return np.abs(sz - ref["sz_sites"]).reshape(len(idx), -1).max(1)

    d_card, d_wit = drift(tr["sz_sites"][idx]), drift(wit["sz_sites"])
    bound = np.maximum(GRID_REFERENCE_TOL["exact"],
                       2.0 * np.asarray(DRIVE_JAX_OVER_WITNESS) * d_wit)
    print(f"[drive-diagram] points {idx.tolist()}, all rows, max |d sz| from "
          f"complex128: card {[f'{x:.2e}' for x in d_card]}, complex64 LAPACK "
          f"witness on the host CPU ({dt_wit:.1f} s) "
          f"{[f'{x:.2e}' for x in d_wit]}; card / witness "
          f"{[f'{x:.3g}' for x in d_card / d_wit]} (JAX float32 'jacobi' / "
          f"witness on the CPU {list(DRIVE_JAX_OVER_WITNESS)}); bound "
          f"{[f'{x:.2e}' for x in bound]}", flush=True)
    _check(bool(np.all(d_card < bound)), f"[drive-diagram] the card drifts "
           f"from complex128 beyond the witness's bound: {d_card} {bound}")
    # the diagram's outputs from the complex128 traces, by the same recipes
    tau = float(taus[0])
    times = np.arange(spec.n_periods + 1) * 2.0 * tau
    host = np.array([[extract_subharmonic_amplitude(times, s_, 2.0 * tau),
                      subharmonic_weight_fraction(times, s_, 2.0 * tau)]
                     for s_ in ref["staggered_magnetization"]])
    card = np.stack([a2t.ravel()[idx], w2t.ravel()[idx]], 1)
    dtc = host[:, 1] >= DTC_WEIGHT
    d = np.abs(card - host).max(1)
    print(f"[drive-diagram] points {idx.tolist()} (eps "
          f"{np.round(eps[idx], 3).tolist()}, h {np.round(hs[idx], 2).tolist()}): "
          f"A2T / subharmonic weight card {np.round(card, 4).tolist()}, complex128 "
          f"host {np.round(host, 4).tolist()}; DTC points (complex128 weight >= "
          f"{DTC_WEIGHT}) {dtc.tolist()}: max |d| there "
          f"{float(d[dtc].max(initial=0)):.2e} (< {DRIVE_SCORE_TOL:.0e}), the "
          f"card's verdict the same at every point", flush=True)
    _check(bool(np.all(d[dtc] < DRIVE_SCORE_TOL)
                and np.all((card[:, 1] >= DTC_WEIGHT) == dtc)),
           f"[drive-diagram] A2T / weight differ from complex128: {card} {host}")
    return c


def phase_correlation():
    """evolve_batch with correlation_site = L//2 on four phase-grid points
    on the card against complex128 on the host CPU; the t=0 row of zz_corr
    against zz_correlation_profile of the initial state."""
    import torch

    from timecrystal_tpu_torch.core.mps import create_initial_state
    from timecrystal_tpu_torch.core.observables import zz_correlation_profile
    from timecrystal_tpu_torch.core.truncate import TruncParams
    from timecrystal_tpu_torch.parallel.sweep import (SweepSpec, _basis_indices,
                                                      evolve_batch,
                                                      phase_grid_batch)

    g = GRID
    spec = SweepSpec(L=g["L"], chi=g["chi"], n_periods=g["n_periods"],
                     theta=float(np.pi), dtype="float32",
                     tp=TruncParams(chi_max=g["chi_max"], svd_min=g["svd_min"],
                                    trunc_cut=g["trunc_cut"]))
    hf, taus, _, _ = phase_grid_batch(np.linspace(*g["h"]), np.linspace(*g["T"]),
                                      spec, disorder_seed=g["seed"])
    idx = np.linspace(0, len(taus) - 1, g["n_reference"]).round().astype(int)
    site = g["L"] // 2
    _reset_kernel1_counts()                  # this path's counts start here
    tr, dt = _timed(lambda: evolve_batch(
        hf[idx], taus[idx], _basis_indices(g["L"], "neel"), spec,
        correlation_site=site, device="cuda"))
    c = _kernel1_counts()
    psi0 = create_initial_state(g["L"], "neel", chi=g["chi"],
                                dtype=torch.complex64, device="cuda")
    zz0 = zz_correlation_profile(psi0, site).cpu().numpy()
    _check(tr["zz_corr"].shape == (len(idx), g["n_periods"] + 1, g["L"]),
           "[correlation] zz_corr shape")
    _check(bool(np.all(tr["zz_corr"][:, 0] == zz0)),
           "[correlation] t=0 row differs from zz_correlation_profile(psi0)")
    _check(bool(np.all(tr["zz_corr"][:, :, site] == 1.0)),
           "[correlation] <z_i z_i> != 1")
    _check(c["smem"] > 0, f"[correlation] ran no kernel-1 sweep: {c}")
    print(f"[correlation] evolve_batch(correlation_site={site}) on phase-grid "
          f"points {idx.tolist()} ({g['n_periods']} periods): {dt:.2f} s; "
          f"zz_corr {list(tr['zz_corr'].shape)}, t=0 row equal to "
          f"zz_correlation_profile(psi0); kernel 1: {c['launches']} launches "
          f"({c['smem']} smem)", flush=True)
    _reference_check("correlation", tr, hf[idx], taus[idx], spec, None,
                     np.arange(len(idx)), correlation_site=site)
    return c


# the open-system and ground-state dynamics (slice 7): the memory figure
# (analysis/memory.py's generate_memory_figure defaults with config.txt:
# tau = T_DRIVE / 2 J = 1, seed 42, 3 realizations x 12 trajectories, L=16,
# chi=48, 100 periods, the coherence leg), the eps scan's rows held against
# complex128 on the host CPU (4 trajectories of realization 0 at eps = 0.04,
# and eps = 0.12's first), the superket Lindblad solver, the imaginary-time
# ground state, the dephasing baseline and the two-time correlator
MEMORY = dict(gammas=(-3.0, -1.3, 6), eps=0.04,
              eps_values=(0.0, 0.02, 0.04, 0.06, 0.09, 0.12), eps_gamma=0.02,
              L=16, chi=48, n_periods=100, R=3, T=12,
              rows=((2, 0, 0), (2, 0, 1), (2, 0, 2), (2, 0, 3), (5, 0, 0)))
# after the complex128 reference truncates (> GRID_EXACT_TRUNC a period),
# a row's drift from it is held, as [drive-diagram]'s, to twice the JAX
# package's float32 Pallas drift over a complex64 LAPACK witness times the
# witness run beside the card: MEMORY_JAX_OVER_WITNESS per row of
# MEMORY['rows'], measured on the CPU with the same noise
# (`tests/probe_torch_faults.py memory`, PERF.md)
MEMORY_JAX_OVER_WITNESS = (1.5, 2.26, 0.454, 1.88, 2.2)
T2_TOL = 0.3                 # tests/test_memory.py's bare-qubit anchor
LINDBLAD = dict(L=6, chi=64, gamma=0.08, dt=0.05, n_steps=20,
                model=dict(Jz=1.0, hx=0.4, hz=0.2), tol=1e-4)
GROUND = dict(L=12, chi=32, tol=1e-3,
              models=(("TFIM", dict(Jz=1.0, hx=0.7)),
                      ("Heisenberg", dict(Jx=1.0, Jy=1.0, Jz=1.0))))
# benchmarks/run_baseline_configs.py's time_crystal_with_dephasing and the
# channel-average decay of tests/test_open_system.py as one batch
DEPHASING = dict(L=12, chi=32, gamma=1e-3, n_periods=100, svd_min=1e-7)
DECAY = dict(L=4, chi=8, gamma=0.05, tau=0.5, n_periods=8, n_traj=600,
             tol=0.05)


def phase_memory():
    """generate_memory_figure's two scans at its defaults on the card: per
    leg (bit, coherence, eps) its time, rate and kernel-1 counts; tau_bit per
    gamma and eps, T2 against 1/(2 gamma) (within T2_TOL), exact protection
    at eps = 0, the final envelope falling with gamma; MEMORY['rows'] of the
    eps leg against complex128 on the host CPU with the same noise."""
    import torch

    from timecrystal_tpu_torch.analysis import memory as M

    params, c = _config_params(), MEMORY
    J = float(params.get("J", 1.0))
    tau = float(params.get("T_DRIVE", 2.0)) / (2.0 * J)
    gammas = np.logspace(*c["gammas"])
    kw = dict(L=c["L"], chi=c["chi"], n_periods=c["n_periods"],
              n_trajectories=c["T"], n_realizations=c["R"], J=J, tau=tau,
              disorder_seed=int(params.get("RANDOM_SEED", 42)), device="cuda")
    real, legs = M.memory_rows, []
    names = iter(("bit", "coherence", "eps"))

    def timed_rows(gamma_dt, noise, **k):
        _reset_kernel1_counts()              # this leg's counts start here
        out, dt = _timed(lambda: real(gamma_dt, noise, **k))
        legs.append(dict(name=next(names), seconds=dt, counts=_kernel1_counts(),
                         traces=out, args=(gamma_dt, noise), kwargs=k))
        return out

    M.memory_rows = timed_rows
    try:
        res = M.scan_memory_lifetime(gammas, eps=c["eps"], **kw)
        res_eps = M.scan_memory_vs_eps(c["eps_values"], c["eps_gamma"], **kw)
    finally:
        M.memory_rows = real
    n, L = c["n_periods"], c["L"]
    total = {"smem": 0, "cluster": 0}
    for leg in legs:
        k, rows = leg["counts"], len(leg["args"][1])
        even = rows * len(range(0, L - 1, 2))
        variant = "smem" if k["smem"] else "cluster"
        for v in total:
            total[v] += k[v]
        _check(k[variant] > 0 and k["host_reads"] == 0,
               f"[memory] the {leg['name']} leg ran no kernel-1 sweep: {k}")
        print(f"[memory] {leg['name']} leg: {rows} rows x {n} periods in "
              f"{leg['seconds']:.2f} s, {rows * n / leg['seconds']:.1f} "
              f"trajectory-periods/s; kernel 1 ({variant}): {k['calls']} SVD "
              f"calls of [{even}, {2 * c['chi']}, {2 * c['chi']}] and "
              f"[{rows * (L - 1) - even}, {2 * c['chi']}, {2 * c['chi']}], "
              f"{k['sweeps']} sweeps ({k['sweeps'] / max(k['calls'], 1):.2f} per "
              f"call) in {k['launches']} launches", flush=True)
        for key, v in leg["traces"].items():
            _check(bool(np.all(np.isfinite(v))), f"[memory] non-finite {key}")
    times = res["times"]
    t2, t2a = res["t2_qubit"], res["t2_analytic"]
    print(f"[memory] gamma {np.round(gammas, 5).tolist()}: tau_bit "
          f"{[f'{x:.4g}' for x in res['tau_bit']]}; T2 {[f'{x:.4g}' for x in t2]} "
          f"against 1/(2 gamma) {[f'{x:.4g}' for x in t2a]} (within "
          f"{T2_TOL:.0%}: max {np.max(np.abs(t2 / t2a - 1)):.3f})", flush=True)
    print(f"[memory] eps {list(c['eps_values'])} at gamma {c['eps_gamma']}: "
          f"tau_bit {[f'{x:.4g}' for x in res_eps['tau_bit']]}; final "
          f"envelope {np.round(res_eps['envelope'][:, -1], 4).tolist()}",
          flush=True)
    _check(bool(np.all(np.abs(t2 / t2a - 1) < T2_TOL)),
           f"[memory] T2 {t2} is not within {T2_TOL} of 1/(2 gamma)")
    env0 = res_eps["envelope"][list(c["eps_values"]).index(0.0)]
    tau0 = res_eps["tau_bit"][list(c["eps_values"]).index(0.0)]
    _check(env0.min() > 0.999 and tau0 > 100.0 * times[-1],
           f"[memory] eps = 0 is not protected: min {env0.min()}, tau {tau0}")
    final = res["envelope"][:, -10:].mean(1)
    sem = res["envelope_std"][:, -10:].mean(1) / np.sqrt(c["R"] * c["T"])
    print(f"[memory] final envelope (mean of the last 10 periods) per gamma "
          f"{np.round(final, 4).tolist()}, standard error "
          f"{np.round(sem, 4).tolist()}", flush=True)
    _check(final[-1] < final[0] and bool(np.all(
        np.diff(final) < 2.0 * (sem[1:] + sem[:-1]))),
        f"[memory] the final envelope does not fall as gamma grows: {final}")

    # MEMORY['rows'] of the eps leg against complex128 on the host CPU, the
    # same noise, fields and kicks; a complex64 LAPACK witness beside them
    eps_leg = legs[-1]
    R, T = c["R"], c["T"]
    idx = np.array([(e * R + r) * T + t for e, r, t in c["rows"]])
    gdt, noise = (np.asarray(a)[idx] for a in eps_leg["args"])
    k = dict(eps_leg["kwargs"], h_rows=np.asarray(eps_leg["kwargs"]["h_rows"])[idx],
             thetas=np.asarray(eps_leg["kwargs"]["thetas"])[idx], device="cpu")
    t0 = time.perf_counter()
    ref = real(gdt, noise, **dict(k, dtype=torch.complex128))
    wit = real(gdt, noise, **dict(k, dtype=torch.complex64))
    dt_host = time.perf_counter() - t0
    card = eps_leg["traces"]["sz_sites"][idx]
    exact = np.cumsum(ref["trunc_err"] > GRID_EXACT_TRUNC, axis=1) == 0
    d_card = np.abs(card - ref["sz_sites"])
    d_wit = np.abs(wit["sz_sites"] - ref["sz_sites"])
    ex = float(d_card[exact].max())
    per_row, per_wit = d_card.max((1, 2)), d_wit.max((1, 2))
    bound = np.where(exact.all(1), GRID_REFERENCE_TOL["exact"], np.maximum(
        GRID_REFERENCE_TOL["exact"],
        2.0 * np.asarray(MEMORY_JAX_OVER_WITNESS) * per_wit))
    print(f"[memory] eps-leg rows {idx.tolist()} (eps, realization, trajectory "
          f"{list(c['rows'])}) against complex128 LAPACK on the host CPU "
          f"({dt_host:.1f} s with the complex64 witness): rows before the "
          f"reference truncates {exact.sum(1).tolist()} of {n}; there max |d sz| "
          f"{ex:.2e} (< {GRID_REFERENCE_TOL['exact']:.0e}); all rows per row: "
          f"card {[f'{x:.2e}' for x in per_row]}, complex64 LAPACK witness "
          f"{[f'{x:.2e}' for x in per_wit]}, card / witness "
          f"{[f'{x:.3g}' for x in per_row / per_wit]} (JAX float32 Pallas / "
          f"witness on the CPU {list(MEMORY_JAX_OVER_WITNESS)}); bound "
          f"{[f'{x:.2e}' for x in bound]}; max trunc_err card "
          f"{[f'{x:.2e}' for x in eps_leg['traces']['trunc_err'][idx].max(1)]}, "
          f"host {[f'{x:.2e}' for x in ref['trunc_err'].max(1)]}", flush=True)
    _check(ex < GRID_REFERENCE_TOL["exact"] and bool(np.all(per_row < bound)),
           f"[memory] rows differ from complex128: {ex}, {per_row}, {bound}")
    return total


def phase_lindblad():
    """LindbladEvolution of |+><+|^L (superket, d = 4) on the card: L=6,
    chi=64 (exact: n = 4 chi = 256, kernel 1's cluster variant), a
    spin_chain_model bond set, dephasing gamma, 20 Strang steps.  Tr rho
    and <sz_i>, <sx_i> of every step against the dense Strang product of the
    same dt in complex128 on the host; the Schmidt values the card keeps
    (svd_min 1e-12) beside complex64 and complex128 LAPACK runs' on the
    host."""
    import scipy.linalg
    import torch

    from timecrystal_tpu_torch.core.mps import MPS
    from timecrystal_tpu_torch.dynamics import open_system as OS
    from timecrystal_tpu_torch.dynamics.tebd import spin_chain_model

    c, oracle = LINDBLAD, _load_oracle()
    L, dt, g = c["L"], c["dt"], c["gamma"]
    H = spin_chain_model(L, **c["model"])

    def run(device, dtype):
        rho = OS.density_mps_from_product(np.zeros(L, np.int32), c["chi"],
                                          dtype=dtype, device=device)
        B = rho.B.clone()
        B[:, 0, :, 0] = 0.5                  # |+><+| on every site
        return OS.LindbladEvolution(H, g, max_chi=c["chi"], dtype=dtype,
                                    device=device).evolve(
            MPS(B=B, lam=rho.lam), c["n_steps"] * dt, dt)

    _reset_kernel1_counts()                  # this path's counts start here
    (rhos, times, info), sec = _timed(lambda: run("cuda", torch.complex64))
    k = _kernel1_counts()
    with _host_threads():
        wit, _, _ = run("cpu", torch.complex64)
        ref, _, _ = run("cpu", torch.complex128)

    # the dense Strang product: dephasing half-step (coherences between
    # ket and bra bits that differ at m sites times e^{-gamma dt m}), even
    # bonds dt/2, odd bonds dt, even bonds dt/2, dephasing half-step
    dim = 2 ** L
    bits = (np.arange(dim)[:, None] >> np.arange(L)[None, :]) & 1
    diff = (bits[:, None, :] != bits[None, :, :]).sum(-1)
    deph = np.exp(-g * dt * diff)

    def layer(start, t):
        U = np.eye(dim, dtype=complex)
        for b in range(start, L - 1, 2):
            U = oracle._kron_at(scipy.linalg.expm(-1j * t * H.bond_H[b]),
                                [b, b + 1], L) @ U
        return U

    Ue, Uo = layer(0, dt / 2), layer(1, dt)
    ops = {name: [oracle._kron_at(op, [i], L) for i in range(L)]
           for name, op in (("sz", oracle.SZ), ("sx", oracle.SX))}
    rho = np.full((dim, dim), 1.0 / dim, dtype=complex)
    d = {"trace": 0.0, "sz": 0.0, "sx": 0.0}
    for step, r in enumerate(rhos):
        if step:
            rho = deph * rho
            for U in (Ue, Uo, Ue):
                rho = U @ rho @ U.conj().T
            rho = deph * rho
        d["trace"] = max(d["trace"], abs(complex(OS.trace_rho(r)) - 1.0))
        for name, op in (("sz", oracle.SZ), ("sx", oracle.SX)):
            mps = OS.expectation_rho_one_site(r, op).real
            dense = np.array([np.trace(o @ rho).real for o in ops[name]])
            d[name] = max(d[name], float(np.abs(mps - dense).max()))
    kept, kept_wit, kept_ref = ((r[-1].lam > 0).sum(-1).tolist()
                                for r in (rhos, wit, ref))
    print(f"[lindblad] L={L} chi={c['chi']} (superket, n = {4 * c['chi']}), "
          f"gamma={g}, dt={dt}, {c['n_steps']} Strang steps on the card: "
          f"{sec:.2f} s ({c['n_steps'] / sec:.1f} steps/s); kernel 1: "
          f"{k['calls']} SVD calls, {k['sweeps']} sweeps in {k['launches']} "
          f"launches ({k['smem']} smem, {k['cluster']} cluster); against the "
          f"dense Strang product in complex128: max |Tr rho - 1| "
          f"{d['trace']:.2e}, max |d <sz_i>| {d['sz']:.2e}, max |d <sx_i>| "
          f"{d['sx']:.2e} (< {c['tol']:.0e}); Schmidt values kept per bond "
          f"(> 0 after svd_min 1e-12) card {kept}, on the host CPU complex64 "
          f"LAPACK {kept_wit}, complex128 LAPACK {kept_ref}", flush=True)
    _check(k["cluster"] > 0 and k["host_reads"] == 0,
           f"[lindblad] did not run kernel 1's cluster variant: {k}")
    _check(max(d.values()) < c["tol"],
           f"[lindblad] differs from the dense Strang product: {d}")
    return k


def phase_ground_state():
    """find_ground_state (imaginary-time TEBD, the default dt ladder) for the
    transverse-field Ising and Heisenberg chains at L=12, chi=32, complex64
    on the card; the energy against sparse exact diagonalization on the host
    to GROUND['tol'] (tests/test_ground_state.py's float32 class), every leg
    converged."""
    import scipy.sparse
    import scipy.sparse.linalg

    from timecrystal_tpu_torch.dynamics.ground_state import find_ground_state
    from timecrystal_tpu_torch.dynamics.tebd import spin_chain_model

    c, L = GROUND, GROUND["L"]
    total = {"smem": 0, "cluster": 0}
    for name, kw in c["models"]:
        model = spin_chain_model(L, **kw)
        _reset_kernel1_counts()              # this model's counts start here
        (_, E, info), sec = _timed(lambda: find_ground_state(
            model, chi=c["chi"], device="cuda"))
        k = _kernel1_counts()
        Hs = sum(scipy.sparse.kron(scipy.sparse.kron(
            scipy.sparse.identity(2 ** b), scipy.sparse.csr_matrix(Hb)),
            scipy.sparse.identity(2 ** (L - b - 2))) for b, Hb in
            enumerate(model.bond_H))
        E0 = float(scipy.sparse.linalg.eigsh(Hs.tocsr(), k=1, which="SA")[0][0])
        for v in total:
            total[v] += k[v]
        print(f"[ground-state] {name} L={L} chi={c['chi']} complex64: "
              f"{info['n_steps']} steps in {sec:.2f} s "
              f"({info['n_steps'] / sec:.1f} steps/s), legs converged "
              f"{info['converged']}; E {E:.8f}, extrapolated "
              f"{info['energy_extrapolated']:.8f}, exact {E0:.8f}, |d| "
              f"{abs(E - E0):.2e} (< {c['tol']:.0e}); kernel 1: {k['calls']} SVD "
              f"calls, {k['sweeps']} sweeps ({k['sweeps'] / max(k['calls'], 1):.2f} "
              f"per call) in {k['launches']} launches ({k['smem']} smem)",
              flush=True)
        _check(all(info["converged"]) and abs(E - E0) < c["tol"],
               f"[ground-state] {name}: E {E}, exact {E0}, {info['converged']}")
        _check(k["smem"] > 0 and k["host_reads"] == 0,
               f"[ground-state] {name} ran no kernel-1 sweep: {k}")
    return total


def phase_open_system():
    """The dephasing baseline (time_crystal_with_dephasing: L=12, chi=32,
    gamma=1e-3, 100 periods after 5 of warm-up) through
    OpenSystemEvolution.evolve on the card, its traces against the same
    seed's complex128 host run (the noise is drawn on the host); then the
    channel average E<sx> = e^{-2 gamma t} of 600 undriven trajectories as
    one batch."""
    import torch

    from timecrystal_tpu_torch.analysis.memory import _x_plus_state
    from timecrystal_tpu_torch.core.mps import create_initial_state
    from timecrystal_tpu_torch.core.truncate import TruncParams
    from timecrystal_tpu_torch.dynamics.open_system import OpenSystemEvolution
    from timecrystal_tpu_torch.models.kicked_ising import KickedIsingModel

    c = DEPHASING

    def baseline(device, dtype):
        m = KickedIsingModel(c["L"], 1.0, 0.3, 1.0, disorder_seed=42,
                             chi=c["chi"], dtype=dtype, device=device)
        psi = create_initial_state(c["L"], "neel", chi=c["chi"], dtype=dtype,
                                   device=device)
        ose = OpenSystemEvolution(m, gamma=c["gamma"], max_chi=c["chi"],
                                  trunc_params=TruncParams(chi_max=0,
                                                           svd_min=c["svd_min"]))
        ose.evolve(psi, 5)                   # the baseline's warm-up
        return lambda: ose.evolve(psi, c["n_periods"])

    run = baseline("cuda", torch.complex64)
    _reset_kernel1_counts()                  # this path's counts start here
    (tr, _, info), _ = _timed(run)
    k = _kernel1_counts()
    with _host_threads():
        host, _, _ = baseline("cpu", torch.complex128)()
    d = {key: float(np.max(np.abs(tr[key] - host[key])))
         for key in ("sz_sites", "sx_sites", "loschmidt_echo")}
    le = tr["loschmidt_echo"]
    print(f"[open-system] time_crystal_with_dephasing (L={c['L']}, chi="
          f"{c['chi']}, gamma={c['gamma']}, theta = pi): {c['n_periods']} "
          f"periods in {info['wall_time']:.2f} s, "
          f"{c['n_periods'] / info['wall_time']:.1f} periods/s; final stag "
          f"{float(tr['staggered_magnetization'][-1]):.6f}; against the same "
          f"seed in complex128 on the host: max |d| sz {d['sz_sites']:.2e}, sx "
          f"{d['sx_sites']:.2e}, LE {d['loschmidt_echo']:.2e} (< "
          f"{GRID_REFERENCE_TOL['exact']:.0e}); kernel 1: {k['calls']} SVD "
          f"calls, {k['sweeps']} sweeps in {k['launches']} launches "
          f"({k['smem']} smem)", flush=True)
    _check(max(d.values()) < GRID_REFERENCE_TOL["exact"],
           f"[open-system] differs from complex128: {d}")
    _check(float(np.abs(le[1::2] - 1.0).max()) < 1e-4,
           "[open-system] the exact-pi echo is not protected")

    e = DECAY
    m = KickedIsingModel(e["L"], 0.0, 0.0, e["tau"], h_fields=np.zeros(e["L"]),
                         theta=0.0, chi=e["chi"], device="cuda")
    psi = _x_plus_state(e["L"], e["chi"], device="cuda")
    _reset_kernel1_counts()
    (ens, _, _), sec = _timed(lambda: OpenSystemEvolution(
        m, gamma=e["gamma"], max_chi=e["chi"], seed=3).evolve_ensemble(
            psi, e["n_periods"], e["n_traj"]))
    k2 = _kernel1_counts()
    t = e["n_periods"] * 2 * e["tau"]
    mean = float(ens["sx_sites"][-1].mean())
    print(f"[open-system] channel average, {e['n_traj']} undriven "
          f"trajectories of |+x>^{e['L']} as one batch, gamma={e['gamma']}, "
          f"{e['n_periods']} periods: {sec:.2f} s; E<sx>({t:g}) {mean:.4f} "
          f"against e^(-2 gamma t) {np.exp(-2 * e['gamma'] * t):.4f} (within "
          f"{e['tol']}); kernel 1: {k2['calls']} SVD calls, {k2['launches']} "
          f"launches ({k2['smem']} smem)", flush=True)
    _check(abs(mean - np.exp(-2 * e["gamma"] * t)) < e["tol"],
           f"[open-system] E<sx> {mean} is not e^(-2 gamma t)")
    _check(k["smem"] > 0 and k2["smem"] > 0, f"[open-system] no kernel-1 "
           f"sweep: {k}, {k2}")
    return {v: k[v] + k2[v] for v in ("smem", "cluster")}


def phase_two_time():
    """evolve_batch(two_time_anchor=8) on [correlation]'s four phase-grid
    points (80 periods) on the card against complex128 on the host CPU;
    the t=0 row against zz_correlation_profile of the initial state, and the
    structure factor of zz2t_re peaking at (k = pi, f = f_drive / 2)."""
    import torch

    from timecrystal_tpu_torch.core.mps import create_initial_state
    from timecrystal_tpu_torch.core.observables import (dynamic_structure_factor,
                                                        zz_correlation_profile)
    from timecrystal_tpu_torch.core.truncate import TruncParams
    from timecrystal_tpu_torch.parallel.sweep import (SweepSpec, _basis_indices,
                                                      evolve_batch,
                                                      phase_grid_batch)

    g = GRID
    spec = SweepSpec(L=g["L"], chi=g["chi"], n_periods=g["n_periods"],
                     theta=float(np.pi), dtype="float32",
                     tp=TruncParams(chi_max=g["chi_max"], svd_min=g["svd_min"],
                                    trunc_cut=g["trunc_cut"]))
    hf, taus, _, _ = phase_grid_batch(np.linspace(*g["h"]), np.linspace(*g["T"]),
                                      spec, disorder_seed=g["seed"])
    idx = np.linspace(0, len(taus) - 1, g["n_reference"]).round().astype(int)
    site = g["L"] // 2
    _reset_kernel1_counts()                  # this path's counts start here
    tr, dt = _timed(lambda: evolve_batch(
        hf[idx], taus[idx], _basis_indices(g["L"], "neel"), spec,
        two_time_anchor=site, device="cuda"))
    k = _kernel1_counts()
    psi0 = create_initial_state(g["L"], "neel", chi=g["chi"],
                                dtype=torch.complex64, device="cuda")
    zz0 = zz_correlation_profile(psi0, site).cpu().numpy()
    _check(tr["zz2t_re"].shape == (len(idx), g["n_periods"] + 1, g["L"]),
           "[two-time] zz2t shape")
    _check(bool(np.all(tr["zz2t_re"][:, 0] == zz0) and
                np.all(tr["zz2t_im"][:, 0] == 0)),
           "[two-time] t=0 row differs from zz_correlation_profile(psi0)")
    peaks = []
    for p, i in enumerate(idx):
        times = np.arange(g["n_periods"] + 1) * 2.0 * taus[i]
        f, ks, S = dynamic_structure_factor(times, tr["zz2t_re"][p],
                                            device="cuda")
        S = S.cpu().numpy()
        fi, ki = np.unravel_index(np.argmax(S), S.shape)
        peaks.append((float(f[fi] * 2.0 * taus[i]), float(ks[ki])))
        _check(abs(ks[ki] - np.pi) < 1e-12 and
               abs(f[fi] - 1.0 / (4.0 * taus[i])) <= f[0],
               f"[two-time] S(k, f) of point {i} peaks at k={ks[ki]}, "
               f"f={f[fi]}, not (pi, f_drive / 2)")
    _check(k["smem"] > 0, f"[two-time] ran no kernel-1 sweep: {k}")
    print(f"[two-time] evolve_batch(two_time_anchor={site}) on phase-grid "
          f"points {idx.tolist()} ({g['n_periods']} periods, psi and sz_{site} "
          f"psi as one pair): {dt:.2f} s; zz2t {list(tr['zz2t_re'].shape)}, t=0 "
          f"row equal to zz_correlation_profile(psi0); S(k, f) of zz2t_re peaks "
          f"at (f / f_drive, k) {[(round(a, 4), round(b, 4)) for a, b in peaks]} "
          f"(f_drive / 2 to one bin, k = pi); kernel 1: {k['calls']} SVD calls "
          f"of [{2 * len(idx) * 8}, 64, 64] / [{2 * len(idx) * 7}, 64, 64], "
          f"{k['launches']} launches ({k['smem']} smem)", flush=True)
    _reference_check("two-time", tr, hf[idx], taus[idx], spec, None,
                     np.arange(len(idx)), two_time_anchor=site)
    return k


# kill and resume, scale-out over torch.distributed and the profiling hooks:
# every process started here has its own time limit and is reaped, so a hung
# child or rank fails the script instead of stalling it.  The two-rank
# phases run on the one card with Gloo (NCCL refuses two ranks on one GPU).
CHILD_TIMEOUT = 240
# evolve_floquet_auto at Figure A's settings (config.txt: L=64, h/J=0.25,
# tau=2/J, seed 42, chi cap CHI_MAX=256, 200 periods, chunks of 16)
RESUME_AUTO = dict(n_sites=64, h_frac=0.25, seed=42, n_periods=200, chunk=16)
RESUME_GRID_CHUNKS = 8                       # sweep_phase_grid's default
# the staged evolution over two ranks: [phase-grid]'s batch (60 points a
# rank), chi 8 -> 16 -> 24 (the grid's chi_max), chunks of 10 periods
STAGED_GRID = dict(chi_start=8, chunk=10)
# one chain split 20 + 20 over two ranks: CONFIG's L=40, theta=0.9 pi,
# h=0.3, tau=1, seed 42, svd_min 1e-7, chi 64 fixed, 10 merged periods
SITE_SHARD = dict(L=40, chi=64, n_periods=10)
MESH_TOL = dict(exact=1e-4, score=1e-3)


def _meta(path) -> dict:
    """The JSON metadata of a state checkpoint ({} until it exists)."""
    try:
        with np.load(path) as z:
            return json.loads(bytes(z["__meta__"]).decode())
    except (OSError, KeyError, ValueError):
        return {}


def _manifest_chunks(directory) -> int:
    try:
        with open(Path(directory) / "manifest.json") as f:
            return len(json.load(f)["chunks"])
    except (OSError, ValueError, KeyError):
        return 0


def _tail(path, n=25) -> str:
    try:
        return "\n".join(Path(path).read_text().splitlines()[-n:])
    except OSError:
        return ""


def _spawn(root, name, *args):
    """python3 chip_smoke.py --child ARGS, its output in root/name.log."""
    log = Path(root) / f"{name}.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--child",
             *map(str, args)], stdout=f, stderr=subprocess.STDOUT, cwd=REPO)
    return proc, log


def _stop(procs):
    """SIGKILL whatever still runs, and reap every process."""
    for p, _ in procs:
        if p.poll() is None:
            p.kill()
    for p, _ in procs:
        p.wait()


def _kill_when(groups: dict) -> dict:
    """Poll every group {name: (procs, ready)} together; SIGKILL a group's
    processes as soon as its ready() holds.  Returns {name: seconds to the
    kill}.  Fails if a process exits before its kill or CHILD_TIMEOUT
    passes; every process is reaped either way."""
    t0, killed = time.perf_counter(), {}
    try:
        while len(killed) < len(groups):
            for name, (procs, ready) in groups.items():
                if name in killed:
                    continue
                if ready():
                    _stop(procs)
                    killed[name] = time.perf_counter() - t0
                    continue
                for p, log in procs:
                    if p.poll() is not None:
                        raise AssertionError(f"[{name}]: a child exited "
                                             f"({p.returncode}) before the "
                                             f"kill:\n{_tail(log)}")
            if time.perf_counter() - t0 > CHILD_TIMEOUT:
                raise AssertionError(f"children not ready after "
                                     f"{CHILD_TIMEOUT} s: {sorted(killed)} done")
            time.sleep(0.02)
    finally:
        for procs, _ in groups.values():
            _stop(procs)
    return killed


def _wait_all(procs, what):
    """Wait for procs to exit 0 within CHILD_TIMEOUT; kill all otherwise."""
    deadline = time.perf_counter() + CHILD_TIMEOUT
    try:
        for p, log in procs:
            try:
                p.wait(timeout=max(deadline - time.perf_counter(), 0.1))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{what}: hung past {CHILD_TIMEOUT} s:\n"
                                     f"{_tail(log)}") from None
            _check(p.returncode == 0, f"{what}: exit {p.returncode}:\n{_tail(log)}")
    finally:
        _stop(procs)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _max_diff(a: dict, b: dict, keys=None) -> float:
    return max(float(np.max(np.abs(np.asarray(a[k], float) - np.asarray(b[k], float))))
               for k in (keys or b))


def _auto_run(checkpoint_dir=None):
    """evolve_floquet_auto at RESUME_AUTO (Figure A's settings)."""
    import torch

    from timecrystal_tpu_torch.analysis.figures import _trunc_from_params
    from timecrystal_tpu_torch.dynamics.tebd import evolve_floquet_auto

    params, a = _config_params(), RESUME_AUTO
    J = float(params.get("J", 1.0))
    kw = dict(n_sites=a["n_sites"], J=J, h_disorder=a["h_frac"] * J,
              tau=2.0 / J, disorder_seed=a["seed"], device="cuda",
              dtype=torch.complex64)
    return evolve_floquet_auto(kw, "neel", a["n_periods"],
                               _trunc_from_params(params),
                               chi_limit=int(params.get("CHI_MAX", 256)),
                               chunk_periods=a["chunk"],
                               checkpoint_dir=checkpoint_dir)


def _grid_axes():
    from timecrystal_tpu_torch.analysis import phase_diagram as PD

    hc = PD.GRID_HARDCODED
    return (np.linspace(*hc["h_range"], hc["n_points"][0]),
            np.linspace(*hc["T_range"], hc["n_points"][1]))


def _grid_sweep(checkpoint_dir=None):
    """sweep_phase_grid on [phase-grid]'s grid in RESUME_GRID_CHUNKS chunks."""
    from timecrystal_tpu_torch.analysis import phase_diagram as PD

    h_values, T_values = _grid_axes()
    cs = -(-h_values.size * T_values.size // RESUME_GRID_CHUNKS)
    return PD.sweep_phase_grid(h_values, T_values, _config_params(),
                               chunk_size=cs, checkpoint_dir=checkpoint_dir,
                               device="cuda")


def _counted(fn):
    """(fn(), seconds, kernel-1 counts of the call)."""
    _reset_kernel1_counts()
    out, dt = _timed(fn)
    return out, dt, _kernel1_counts()


def _add_counts(total, c):
    for v in ("smem", "cluster"):
        total[v] += c[v]


def _bounded(resumed, ref, rerun, total):
    """(max |resumed - ref|, how it was bounded): 0 passes at once;
    otherwise a second uninterrupted run (rerun(); its kernel-1 launches
    join total) bounds it by its own difference from ref, and a larger
    difference fails."""
    d = _max_diff(resumed, ref)
    if d == 0.0:
        return d, "bit for bit"
    again, _, k = _counted(rerun)
    _add_counts(total, k)
    d_det = _max_diff(again, ref)
    _check(d <= d_det, f"resumed run differs by {d}, two uninterrupted runs "
           f"by {d_det}")
    return d, f"two uninterrupted runs differ by {d_det:.2e}, the bound"


def phase_resume(window_ref):
    """Kill and resume through checkpoint_dir: three children run the CONFIG
    window (evolve_batch_auto), one Figure A chain (evolve_floquet_auto) and
    the phase grid in eight chunks (sweep_phase_grid) and are sent SIGKILL
    once two chunks, one chunk and two chunks are on disk; each is resumed
    here and held against uninterrupted runs in this process, bit for bit
    unless two uninterrupted runs differ (then by their difference)."""
    import shutil
    import tempfile

    root = Path(tempfile.mkdtemp(prefix="tc_resume_"))
    total = {"smem": 0, "cluster": 0}
    try:
        d = {k: root / k for k in ("window", "auto", "grid")}
        ready = {
            "window": lambda: _meta(d["window"] / "batch_auto_state.npz")
            .get("n_chunks", 0) >= 2,
            "auto": lambda: _meta(d["auto"] / "auto_state.npz")
            .get("n_chunks", 0) >= 1,
            "grid": lambda: _manifest_chunks(d["grid"]) >= 2}
        killed = _kill_when({f"resume-{k}": (
            [_spawn(root, k, f"resume-{k}", d[k])], ready[k]) for k in d})
        killed = {k: killed[f"resume-{k}"] for k in d}

        # the window: [window]'s run, one more uninterrupted run, the resume
        c = CONFIG
        ref1, ref1_info = window_ref
        (ref2, ref2_info), dt_ref, k = _counted(_window_run)
        _add_counts(total, k)
        p_killed = _meta(d["window"] / "batch_auto_state.npz")["p_done"]
        (out, info), dt, k = _counted(lambda: _window_run(d["window"]))
        _add_counts(total, k)
        d_det, d_res = _max_diff(ref1, ref2), _max_diff(out, ref2)
        same = all(info[x] == ref2_info[x] == ref1_info[x]
                   for x in ("chi_pad_used", "chi_escalations"))
        rate = c["R"] * (c["n_periods"] - p_killed) / dt
        print(f"[resume-window] evolve_batch_auto (CONFIG, checkpoint_dir) "
              f"killed by SIGKILL {killed['window']:.1f} s after its start with "
              f"{p_killed} of {c['n_periods']} periods on disk; resumed in "
              f"{dt:.2f} s ({rate:.2f} chain-periods/s over the remaining "
              f"periods; uninterrupted {ref2_info['chain_periods_per_second']:.2f} "
              f"in {dt_ref:.2f} s); max |resumed - uninterrupted| {d_res:.2e}, two "
              f"uninterrupted runs differ by {d_det:.2e} (the bound); chi_pad_used "
              f"{info['chi_pad_used']}, escalations equal: {same}; kernel 1: "
              f"{k['launches']} launches ({k['smem']} smem)", flush=True)
        _check(0 < p_killed < c["n_periods"], f"[resume-window] killed at {p_killed}")
        _check(d_res <= d_det and same, f"[resume-window] resumed run differs: "
               f"{d_res} (bound {d_det}), schedule equal {same}")

        # Figure A's chain
        (a1, _, a1_info, _), dt_a, k = _counted(_auto_run)
        _add_counts(total, k)
        p_killed = _meta(d["auto"] / "auto_state.npz")["p_done"]
        (ao, _, ao_info, _), dt, k = _counted(lambda: _auto_run(d["auto"]))
        _add_counts(total, k)
        d_res, bound = _bounded(ao, a1, lambda: _auto_run()[0], total)
        same = ao_info["chi_escalations"] == a1_info["chi_escalations"]
        n = RESUME_AUTO["n_periods"]
        print(f"[resume-auto] evolve_floquet_auto (Figure A: L={RESUME_AUTO['n_sites']}, "
              f"{n} periods, chunks of {RESUME_AUTO['chunk']}) killed "
              f"{killed['auto']:.1f} s after its start with {p_killed} periods on "
              f"disk; resumed in {dt:.2f} s ({(n - p_killed) / dt:.1f} periods/s; "
              f"uninterrupted {a1_info['periods_per_second']:.1f} periods/s, "
              f"{dt_a:.2f} s); max |resumed - uninterrupted| {d_res:.2e} "
              f"({bound}); chi_pad_used {ao_info['chi_pad_used']}, escalations "
              f"equal: {same}", flush=True)
        _check(0 < p_killed < n, f"[resume-auto] killed at {p_killed}")
        _check(same, "[resume-auto] the escalations differ")

        # the phase grid in eight chunks
        g1, dt_g, k = _counted(_grid_sweep)
        _add_counts(total, k)
        n_done = _manifest_chunks(d["grid"])
        go, dt, k = _counted(lambda: _grid_sweep(d["grid"]))
        _add_counts(total, k)

        def flat(res):
            return dict(res["traces"], **{
                key: np.array([r[key] for r in res["records"]])
                for key in ("A2T", "dtc_score_raw")})
        d_res, bound = _bounded(flat(go), flat(g1),
                                lambda: flat(_grid_sweep()), total)
        P = len(go["records"])
        print(f"[resume-grid] sweep_phase_grid ({P} points, {RESUME_GRID_CHUNKS} "
              f"chunks) killed {killed['grid']:.1f} s after its start with "
              f"{n_done} chunks on disk; resumed in {dt:.2f} s "
              f"({P * (RESUME_GRID_CHUNKS - n_done) / RESUME_GRID_CHUNKS / dt:.2f} "
              f"points/s over the remaining chunks; uninterrupted "
              f"{P / dt_g:.2f} points/s: eight launch-bound chunks); max "
              f"|resumed - uninterrupted| of the traces and the scores "
              f"{d_res:.2e} ({bound})", flush=True)
        _check(2 <= n_done < RESUME_GRID_CHUNKS, f"[resume-grid] killed at {n_done}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total


def _grid_problem():
    """(spec, h_fields, taus, hs, Ts) of [phase-grid]'s batch."""
    from timecrystal_tpu_torch.core.truncate import TruncParams
    from timecrystal_tpu_torch.parallel.sweep import SweepSpec, phase_grid_batch

    g = GRID
    spec = SweepSpec(L=g["L"], chi=g["chi"], n_periods=g["n_periods"],
                     theta=float(np.pi), dtype="float32",
                     tp=TruncParams(chi_max=g["chi_max"], svd_min=g["svd_min"],
                                    trunc_cut=g["trunc_cut"]))
    hf, taus, hs, Ts = phase_grid_batch(np.linspace(*g["h"]),
                                        np.linspace(*g["T"]), spec,
                                        disorder_seed=g["seed"])
    return spec, hf, taus, hs, Ts


def _staged_grid(mesh=None, checkpoint_dir=None):
    from timecrystal_tpu_torch.parallel.sweep import (_basis_indices,
                                                      evolve_batch_auto)

    spec, hf, taus, _, _ = _grid_problem()
    return evolve_batch_auto(hf, taus, _basis_indices(spec.L, "neel"), spec,
                             chi_start=STAGED_GRID["chi_start"],
                             chunk_periods=STAGED_GRID["chunk"], mesh=mesh,
                             checkpoint_dir=checkpoint_dir, device="cuda")


def _site_problem():
    """(psi0, gates, tp) of SITE_SHARD's chain on the card."""
    import torch

    from timecrystal_tpu_torch.core.mps import create_initial_state
    from timecrystal_tpu_torch.core.truncate import TruncParams
    from timecrystal_tpu_torch.models.kicked_ising import (
        draw_disorder_reference, make_floquet_gates)

    c, s = CONFIG, SITE_SHARD
    h = torch.as_tensor(draw_disorder_reference(s["L"], c["h"], c["seed"]),
                        device="cuda")
    gates = make_floquet_gates(1.0, h, c["tau"], theta=c["theta_frac"] * float(np.pi),
                               dtype=torch.complex64)
    psi0 = create_initial_state(s["L"], "neel", chi=s["chi"],
                                dtype=torch.complex64, device="cuda")
    return psi0, gates, TruncParams(chi_max=0, svd_min=c["svd_min"])


def _rank_child(kind, rank, port, root):
    """One of two Gloo ranks on the card.  'multihost': evolve_batch_multihost
    on [phase-grid]'s batch, then the staged evolution with per-rank
    checkpoints (killed by the parent).  'resume': the staged evolution
    resumed, then the site-sharded chain."""
    import torch

    from timecrystal_tpu_torch.parallel import multihost as mh
    from timecrystal_tpu_torch.parallel.site_shard import evolve_floquet_sharded
    from timecrystal_tpu_torch.parallel.sweep import _basis_indices

    root = Path(root)
    mh.initialize("gloo", f"tcp://localhost:{port}", world_size=2,
                  rank=int(rank), timeout_s=CHILD_TIMEOUT)
    mesh = mh.global_mesh("cuda")
    out = {}
    if kind == "multihost":
        spec, hf, taus, _, _ = _grid_problem()

        def run():
            return mh.evolve_batch_multihost(
                hf, taus, _basis_indices(spec.L, "neel"), spec, mesh=mesh)
        _, first, _ = _counted(run)      # the process's one-time start-up
        tr, dt, k = _counted(run)
        np.savez(root / f"mh{rank}.npz", seconds=dt, first=first,
                 counts=json.dumps(k), **tr)
        _staged_grid(mesh, root / "staged")          # killed by the parent
        return 1
    p_killed = _meta(root / "staged" / f"rank_{int(rank):04d}" /
                     "batch_auto_state.npz")["p_done"]
    (tr, info), dt, k = _counted(lambda: _staged_grid(mesh, root / "staged"))
    out.update(staged_seconds=dt, staged_counts=json.dumps(k),
               staged_info=json.dumps(info), staged_p_killed=p_killed,
               **{f"staged_{key}": v for key, v in tr.items()})
    psi0, gates, tp = _site_problem()
    ((B, lam), st), dt, k = _counted(lambda: evolve_floquet_sharded(
        psi0, gates, SITE_SHARD["n_periods"], tp, mesh=mesh, frame="merged"))
    out.update(site_seconds=dt, site_counts=json.dumps(k), site_chi=B.shape[-1],
               **{f"site_{key}": np.asarray(v) for key, v in st.items()})
    np.savez(root / f"resume{rank}.npz", **out)
    torch.distributed.destroy_process_group()
    return 0


def _exact_prefix(trunc_err):
    """Rows of [R, n] before the first period discarding > GRID_EXACT_TRUNC."""
    return np.cumsum(np.asarray(trunc_err) > GRID_EXACT_TRUNC, axis=-1) == 0


def _mesh_check(tag, tr, ref, hs, Ts, taus):
    """Two-rank traces against the single-process card run: sz and LE within
    MESH_TOL['exact'] before the single-process run truncates, A2T within
    MESH_TOL['score'] and the DTC verdict equal at every point."""
    from timecrystal_tpu_torch.analysis.detection import score_grid

    exact = _exact_prefix(ref["trunc_err"])
    d = max(float(np.max(np.abs(tr[k] - ref[k])[exact]))
            for k in ("sz_sites", "loschmidt_echo"))
    times = np.arange(ref["loschmidt_echo"].shape[1])[None] * (2.0 * taus)[:, None]
    recs = [score_grid(x, times, hs, Ts, 2.0 * taus) for x in (tr, ref)]
    d_a2t = max(abs(a["A2T"] - b["A2T"]) for a, b in zip(*recs))
    verdict = all((a["dtc_score_raw"] > 0) == (b["dtc_score_raw"] > 0)
                  for a, b in zip(*recs))
    print(f"[{tag}] against the single-process card run: before it truncates "
          f"(> {GRID_EXACT_TRUNC:.0e}; {int(exact.sum())} of {exact.size} rows) "
          f"max |d sz|, |d LE| {d:.2e} (< {MESH_TOL['exact']:.0e}); all rows "
          f"{_max_diff(tr, ref, ('sz_sites', 'loschmidt_echo')):.2e}; max |d A2T| "
          f"{d_a2t:.2e} (< {MESH_TOL['score']:.0e}); DTC verdict equal at every "
          f"point: {verdict} ({sum(r['dtc_score_raw'] > 0 for r in recs[1])} DTC "
          f"points)", flush=True)
    _check(d < MESH_TOL["exact"] and d_a2t < MESH_TOL["score"] and verdict,
           f"[{tag}] differs from the single-process run: {d}, {d_a2t}, {verdict}")


def phase_multihost():
    """[multihost] and [site-shard]: two Gloo ranks on the one card.  The
    first pair runs evolve_batch_multihost on [phase-grid]'s batch and the
    staged evolution with per-rank checkpoints, and is killed once both
    ranks hold two chunks; the second pair resumes it and runs one CONFIG
    chain split 20 + 20 over the ranks.  Each is held against the same
    work in this process."""
    import shutil
    import tempfile

    from timecrystal_tpu_torch.dynamics.tebd import evolve_floquet_scan
    from timecrystal_tpu_torch.parallel.sweep import _basis_indices, evolve_batch

    root = Path(tempfile.mkdtemp(prefix="tc_ranks_"))
    total = {"smem": 0, "cluster": 0}
    try:
        port = _free_port()
        t0 = time.perf_counter()
        ranks = [_spawn(root, f"mh{r}", "rank", "multihost", r, port, root)
                 for r in (0, 1)]

        def ready():
            return all((root / f"mh{r}.npz").exists() and _meta(
                root / "staged" / f"rank_{r:04d}" / "batch_auto_state.npz")
                .get("n_chunks", 0) >= 2 for r in (0, 1))
        _kill_when({"multihost": (ranks, ready)})
        t_kill = time.perf_counter() - t0
        port = _free_port()
        ranks = [_spawn(root, f"resume{r}", "rank", "resume", r, port, root)
                 for r in (0, 1)]
        _wait_all(ranks, "[multihost] second pair")
        t_all = time.perf_counter() - t0
        mh = [dict(np.load(root / f"mh{r}.npz")) for r in (0, 1)]
        rs = [dict(np.load(root / f"resume{r}.npz")) for r in (0, 1)]
        for res in mh + rs:
            for key in ("counts", "staged_counts", "site_counts"):
                if key in res:
                    _add_counts(total, json.loads(str(res[key])))

        spec, hf, taus, hs, Ts = _grid_problem()
        basis = _basis_indices(spec.L, "neel")
        ref, dt_ref, k = _counted(lambda: evolve_batch(hf, taus, basis, spec,
                                                       device="cuda"))
        _add_counts(total, k)
        keys = [x for x in ref]
        full = all(mh[r][x].shape == ref[x].shape for r in (0, 1) for x in keys)
        ranks_equal = all(np.array_equal(mh[0][x], mh[1][x]) for x in keys)
        P, nb = len(taus), 2 * spec.chi
        c0 = json.loads(str(mh[0]["counts"]))
        print(f"[multihost] two Gloo ranks on the card (torch.distributed, "
              f"one process each): evolve_batch_multihost on [phase-grid]'s "
              f"{P} points, {P // 2} a rank: {P / float(mh[0]['seconds']):.2f} "
              f"points/s ({float(mh[0]['seconds']):.2f} s, the second run in each "
              f"rank, both ranks at once; one process, all "
              f"points: {P / dt_ref:.2f} points/s); rank 0's kernel 1: "
              f"{c0['calls']} SVD calls of [{P // 2 * (spec.L // 2)}, {nb}, {nb}] "
              f"/ [{P // 2 * (spec.L // 2 - 1)}, {nb}, {nb}], {c0['launches']} "
              f"launches; each rank "
              f"returns the full traces: {full}, the same: {ranks_equal}; each "
              f"rank's first run (start-up included) {float(mh[0]['first']):.2f} "
              f"s; the "
              f"pairs of ranks ran {t_kill:.1f} s to the kill and {t_all:.1f} s "
              f"in all", flush=True)
        _check(full and ranks_equal, "[multihost] the ranks' traces")
        _check(c0["smem"] > 0, f"[multihost] rank 0 ran no kernel-1 sweep: {c0}")
        _mesh_check("multihost", {x: mh[0][x] for x in keys}, ref, hs, Ts, taus)

        (sref, sinfo), dt_s, k = _counted(_staged_grid)
        _add_counts(total, k)
        st = {x: rs[0][f"staged_{x}"] for x in sref}
        info = json.loads(str(rs[0]["staged_info"]))
        p_killed = int(rs[0]["staged_p_killed"])
        _check(all(np.array_equal(rs[0][f"staged_{x}"], rs[1][f"staged_{x}"])
                   for x in sref), "[multihost] the ranks' staged traces")
        print(f"[multihost] evolve_batch_auto(mesh=2 ranks, checkpoint_dir) on "
              f"the same batch (chi {STAGED_GRID['chi_start']} -> cap "
              f"{GRID['chi_max']}, chunks of {STAGED_GRID['chunk']}): killed with "
              f"{p_killed} periods in each rank's rank_NNNN checkpoint, resumed in "
              f"{float(rs[0]['staged_seconds']):.2f} s; schedule {info['chi_escalations']} "
              f"(one process: {sinfo['chi_escalations']}, "
              f"{sinfo['chain_periods_per_second']:.1f} chain-periods/s)", flush=True)
        _check(0 < p_killed < spec.n_periods, f"[multihost] killed at {p_killed}")
        _mesh_check("multihost-staged", st, sref, hs, Ts, taus)

        psi0, gates, tp = _site_problem()
        n = SITE_SHARD["n_periods"]
        (_, sp), dt_sp, k = _counted(lambda: evolve_floquet_scan(
            psi0, gates, n, tp, frame="merged"))
        _add_counts(total, k)
        sp = {x: v.cpu().numpy() for x, v in sp.items()}
        exact = _exact_prefix(sp["trunc_err"])
        d = max(float(np.max(np.abs(rs[0][f"site_{x}"] - sp[x])[exact]))
                for x in ("sz_sites", "loschmidt_echo"))
        d_all = max(float(np.max(np.abs(rs[0][f"site_{x}"] - sp[x])))
                    for x in ("sz_sites", "loschmidt_echo"))
        ck = json.loads(str(rs[0]["site_counts"]))
        same = all(np.array_equal(rs[0][f"site_{x}"], rs[1][f"site_{x}"])
                   for x in ("sz_sites", "loschmidt_echo"))
        half, nb = SITE_SHARD["L"] // 2, 2 * SITE_SHARD["chi"]
        print(f"[site-shard] one chain (L={SITE_SHARD['L']}, chi "
              f"{SITE_SHARD['chi']}, {n} merged periods) split {half} + {half} "
              f"over the two ranks: {n / float(rs[0]['site_seconds']):.2f} "
              f"periods/s ({float(rs[0]['site_seconds']):.2f} s; one process "
              f"{n / dt_sp:.2f}); rank 0's kernel 1: {ck['calls']} SVD calls "
              f"([{half // 2}, {nb}, {nb}], [{half // 2 - 1}, {nb}, {nb}] and the "
              f"boundary [1, {nb}, {nb}]), {ck['launches']} launches; against the "
              f"single-process "
              f"evolve_floquet_scan: before it truncates ({int(exact.sum())} of "
              f"{n} periods) max |d sz|, |d LE| {d:.2e} (< {MESH_TOL['exact']:.0e}), "
              f"all periods {d_all:.2e}; both ranks the same traces: {same}",
              flush=True)
        _check(bool(exact[0]) and d < MESH_TOL["exact"] and same,
               f"[site-shard] {d}, ranks equal {same}")
        _check(ck["smem"] > 0, f"[site-shard] rank 0 ran no kernel-1 sweep: {ck}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total


def phase_profiling():
    """utils/profiling.py on one window chunk (CONFIG at chi_start, 5 merged
    periods): PhaseTimer spans fenced on the card, device_trace's Chrome
    trace naming kernel 1's shared-memory variant."""
    import shutil
    import tempfile

    import torch

    from timecrystal_tpu_torch.core.mps import product_state
    from timecrystal_tpu_torch.dynamics.tebd import evolve_floquet_scan
    from timecrystal_tpu_torch.models.kicked_ising import make_floquet_gates
    from timecrystal_tpu_torch.parallel.sweep import _basis_indices, _stage_tp
    from timecrystal_tpu_torch.utils.profiling import (PhaseTimer, device_trace,
                                                       timed_blocked)

    c = CONFIG
    h, spec = _window_problem()
    gates = make_floquet_gates(1.0, torch.as_tensor(h, dtype=torch.float32,
                                                    device="cuda"),
                               c["tau"], theta=spec.theta, dtype=torch.complex64)
    psi0 = product_state(np.broadcast_to(_basis_indices(c["L"], "neel"),
                                         (c["R"], c["L"])),
                         chi=c["chi_start"], dtype=torch.complex64, device="cuda")
    tp = _stage_tp(spec.tp, "cuda")

    def chunk():
        return evolve_floquet_scan(psi0, gates, c["chunk"], tp, frame="merged")

    root = tempfile.mkdtemp(prefix="tc_trace_")
    _reset_kernel1_counts()
    try:
        with PhaseTimer() as t:
            with t.phase("chunk"):
                t.fence(chunk())
            with t.phase("traced"), device_trace(root):
                t.fence(chunk())
        _, blocked = timed_blocked(chunk)
        k = _kernel1_counts()
        text = (Path(root) / "trace.json").read_text()
        kb = len(text) // 1024
    finally:
        shutil.rmtree(root, ignore_errors=True)
    spans = t.report()
    named = "jacobi_sv_smem_kernel" in text
    print(f"[profiling] one window chunk (R={c['R']}, L={c['L']}, chi "
          f"{c['chi_start']}, {c['chunk']} merged periods): PhaseTimer spans "
          f"{ {key: round(v, 4) for key, v in spans.items()} } s, timed_blocked "
          f"{blocked:.4f} s; device_trace's Chrome trace {kb} KiB names "
          f"jacobi_sv_smem_kernel: {named}; kernel 1: {k['launches']} launches "
          f"({k['smem']} smem)", flush=True)
    _check(all(v > 0 for v in spans.values()) and blocked > 0,
           f"[profiling] spans {spans}, {blocked}")
    _check(named, "[profiling] the trace does not name kernel 1's variant")
    return k


# the JAX package's examples as the port's entry points
# (timecrystal_tpu_torch.examples) at their own sizes.  [quickstart]: the
# single chain and QUICKSTART_REFERENCE_R ensemble members against
# complex128 LAPACK on the host CPU, to GRID_REFERENCE_TOL['exact'] before
# the reference first truncates (> GRID_EXACT_TRUNC a bond) and after it
# within twice QUICKSTART_JAX_OVER_WITNESS times a complex64 LAPACK witness
# on the host (run only when the reference truncates): no JAX run at these
# sizes fits the CPU tests, so the ratio is the widest float32 Jacobi /
# witness ratio the JAX package shows at the drive diagram's points
# (DRIVE_JAX_OVER_WITNESS).  [hires]: config.txt's 25 x 20 grid as one
# program and in the script's 5 checkpointed chunks of 100 points, its four
# corners against complex128 on the host (sz and LE GRID_REFERENCE_TOL
# before truncation, A2T to SCORE_TOL, the same verdict).
# [multihost-demo]: the demo's two Gloo ranks sharing the card against one
# process, A2T to SCORE_TOL and the same stringent-score verdict
QUICKSTART_REFERENCE_R = 2
# the script's time limit: the single chain held to complex128 over its
# first QUICKSTART_REFERENCE_PERIODS periods, and the TDVP range section at
# its widths (L=10, chi 32, the three alphas) for QUICKSTART_RANGE (of the
# example's 16 periods and 2 realizations; 10 periods are the fewest at
# which the A2T recipe has a bin at f_drive / 2)
QUICKSTART_REFERENCE_PERIODS = 50
QUICKSTART_RANGE = dict(n_periods=10, n_realizations=1)
QUICKSTART_JAX_OVER_WITNESS = max(DRIVE_JAX_OVER_WITNESS)
HIRES_CHUNK = 100


def _exact_drift(card, ref, keys, trunc_err):
    """(max |d| before the reference's first bond truncation above
    GRID_EXACT_TRUNC, max |d| over all rows, rows before it) of the traces
    ``keys`` of ``card`` against ``ref`` (rows on the second-to-last or
    last axis: [..., n+1, L] or [..., n+1])."""
    exact = np.cumsum(np.asarray(trunc_err) > GRID_EXACT_TRUNC, axis=-1) == 0
    d_ex, d_all = 0.0, 0.0
    for k in keys:
        d = np.abs(np.asarray(card[k], float) - np.asarray(ref[k], float))
        if d.ndim > exact.ndim:
            d = d.max(-1)
        d_all = max(d_all, float(d.max()))
        if exact.any():
            d_ex = max(d_ex, float(d[exact].max()))
    return d_ex, d_all, int(exact.sum())


def _host_hold(tag, card, run_host, keys=("sz_sites", "loschmidt_echo")):
    """``card``'s traces against ``run_host(device, dtype)`` in complex128
    on the host CPU: GRID_REFERENCE_TOL['exact'] before the reference
    truncates; after it, when it does, within twice
    QUICKSTART_JAX_OVER_WITNESS times the drift of a complex64 LAPACK
    witness on the host."""
    import torch

    with _host_threads():
        ref, dt = _timed(lambda: run_host("cpu", torch.complex128))
    d_ex, d_all, rows = _exact_drift(card, ref, keys, ref["trunc_err"])
    n = np.asarray(ref["trunc_err"]).size
    tol = GRID_REFERENCE_TOL["exact"]
    line = (f"[quickstart] {tag} against complex128 LAPACK on the host CPU "
            f"({dt:.1f} s): before the reference truncates (> "
            f"{GRID_EXACT_TRUNC:.0e} a bond; {rows} of {n} rows) max |d sz|, "
            f"|d LE| {d_ex:.2e} (< {tol:.0e}); all rows {d_all:.2e}")
    bound = tol
    if rows < n:
        with _host_threads():
            wit = run_host("cpu", torch.complex64)
        d_w = _exact_drift(wit, ref, keys, ref["trunc_err"])[1]
        bound = max(tol, 2.0 * QUICKSTART_JAX_OVER_WITNESS * d_w)
        line += (f" (complex64 LAPACK witness {d_w:.2e}; bound 2 x "
                 f"{QUICKSTART_JAX_OVER_WITNESS} x witness = {bound:.2e})")
    print(line + f"; max trunc_err {float(np.max(ref['trunc_err'])):.2e} (host)",
          flush=True)
    _check(d_ex < tol and d_all <= bound,
           f"[quickstart] {tag} differs from complex128: {d_ex}, {d_all}")


def phase_quickstart():
    """examples/quickstart's five sections on the card at the JAX script's
    widths, the TDVP section at QUICKSTART_RANGE (each its rate, A2T or
    score and kernel counts); the single chain's first
    QUICKSTART_REFERENCE_PERIODS periods and the ensemble's first
    QUICKSTART_REFERENCE_R members against complex128 on the host CPU.
    Returns (kernel-1 counts summed over the sections, the resident kernel
    2's launches)."""
    import torch

    from timecrystal_tpu_torch.examples import quickstart as Q
    from timecrystal_tpu_torch.ops import jacobi_svd as J

    total = dict(smem=0, cluster=0)
    resident = 0

    def section(name, fn, **kw):
        nonlocal resident
        _reset_kernel1_counts()              # this section's counts start here
        v0 = J.V_RESIDENT_LAUNCHES
        out, dt = _timed(lambda: fn(device="cuda", dtype=torch.complex64, **kw))
        c = _kernel1_counts()
        c["resident"] = J.V_RESIDENT_LAUNCHES - v0
        for v in ("smem", "cluster"):
            total[v] += c[v]
        resident += c["resident"]
        return out, dt, c

    def k1(c):
        return (f"kernel 1: {c['calls']} SVD calls, {c['sweeps']} sweeps in "
                f"{c['launches']} launches ({c['smem']} smem, {c['cluster']} "
                f"cluster)")

    one, dt, c = section("single", Q.single_chain)
    tr = one["traces"]
    print(f"[quickstart] single chain (L=20, chi 64, theta 0.97 pi, 100 "
          f"periods, CustomFloquet): {one['info']['periods_per_second']:.1f} "
          f"periods/s ({dt:.2f} s); final max bond dim "
          f"{one['info']['final_bond_dim']}; A2T {one['a2t']:.4f}, stringent "
          f"score {one['dtc_score']:.4f}; {k1(c)}", flush=True)
    for k, v in tr.items():
        _check(bool(np.all(np.isfinite(v))), f"[quickstart] non-finite {k}")
    _check(c["launches"] > 0 and c["host_reads"] == 0,
           f"[quickstart] the single chain did not run kernel 1: {c}")
    n_ref = min(QUICKSTART_REFERENCE_PERIODS, len(one["times"]) - 1)
    _host_hold(f"single chain (its first {n_ref} periods)",
               {k: v[:n_ref + 1] for k, v in tr.items()},
               lambda d, t: Q.single_chain(n_periods=n_ref, device=d,
                                           dtype=t)["traces"])

    ens, dt, c = section("ensemble", Q.ensemble)
    info, R = ens["info"], len(ens["a2t"])
    print(f"[quickstart] ensemble (R={R}, L=20, chi 16 -> {info['chi_pad_used']}, "
          f"60 merged periods, cap 'jacobi_core'): "
          f"{info['chain_periods_per_second']:.1f} chain-periods/s ({dt:.2f} s "
          f"with the A2T); A2T {np.round(ens['a2t'], 4).tolist()}; {k1(c)}",
          flush=True)
    _check(c["launches"] > 0 and bool(np.all(np.isfinite(ens["a2t"]))),
           f"[quickstart] ensemble: {c}")
    r = QUICKSTART_REFERENCE_R
    _host_hold(f"ensemble members 0..{r - 1}",
               {k: v[:r] for k, v in ens["traces"].items()},
               lambda d, t: Q.ensemble(R=r, h_fields=ens["h_fields"][:r],
                                       device=d, dtype=t)["traces"])

    cor, dt, c = section("correlator", Q.correlator_map)
    zz = cor["traces"]["zz_corr"]
    print(f"[quickstart] correlator map (R=8, L=12, chi 32, 20 periods, "
          f"zz_corr and the two-time map): {8 * 20 / dt:.1f} chain-periods/s "
          f"({dt:.2f} s); S(k, f) peak at k {cor['peak_k']:.3f}, f "
          f"{cor['peak_f']:.3f}; C(r, 20) {np.round(cor['c_rt'][20], 2).tolist()}; "
          f"{k1(c)}", flush=True)
    _check(bool(np.all(np.isfinite(zz))) and bool(np.all(np.isfinite(cor["S"]))),
           "[quickstart] correlator map")
    _check(c["launches"] > 0, f"[quickstart] correlator map: {c}")

    rng, dt, c = section("range", Q.interaction_range, **QUICKSTART_RANGE)
    n_runs = len(rng["alphas"]) * rng["a2t_all"].shape[1]
    n_per = QUICKSTART_RANGE["n_periods"]
    print(f"[quickstart] interaction range (alpha {rng['alphas']}, L=10, chi "
          f"32, {n_per} periods, {rng['a2t_all'].shape[1]} realization(s), "
          f"TDVP): {n_runs * n_per / dt:.3f} "
          f"periods/s ({dt:.1f} s); A2T {np.round(rng['a2t'], 4).tolist()} +- "
          f"{np.round(rng['a2t_std'], 4).tolist()}; kernel 2: {c['resident']} "
          f"resident launches", flush=True)
    _check(c["resident"] > 0 and bool(np.all(np.isfinite(rng["a2t_all"]))),
           f"[quickstart] interaction range: {c}")

    mem, dt, c = section("memory", Q.memory_lifetime)
    n_traj = 2 * 2 * 8 * 40           # 2 gammas x 8 trajectories x 40, 2 legs
    print(f"[quickstart] memory lifetime (gamma [0.01, 0.05], L=10, eps 0.04, "
          f"8 trajectories, 40 periods, chi 24): {n_traj / dt:.1f} "
          f"trajectory-periods/s ({dt:.2f} s); tau_bit "
          f"{np.round(mem['tau_bit'], 1).tolist()}, T2 "
          f"{np.round(mem['t2_qubit'], 1).tolist()} (1/(2 gamma) "
          f"{np.round(mem['t2_analytic'], 1).tolist()}); {k1(c)}", flush=True)
    _check(c["launches"] > 0 and bool(np.all(np.isfinite(mem["envelope"]))),
           f"[quickstart] memory lifetime: {c}")
    return total, resident


def phase_hires():
    """examples/phase_diagram_hires: config.txt's 25 x 20 grid through
    hires_grid as one program (kernel 1 at [4000/3500, 64, 64]) and with the
    script's defaults, 5 checkpointed chunks of HIRES_CHUNK points; both
    give the same verdict at every point and A2T within SCORE_TOL; the four
    corners against complex128 on the host CPU.  Returns the kernel-1
    counts of both runs."""
    import tempfile

    import torch

    from timecrystal_tpu_torch.analysis import phase_diagram as PD
    from timecrystal_tpu_torch.examples import phase_diagram_hires as H
    from timecrystal_tpu_torch.ops import jacobi_svd as J

    params = _config_params()
    hc = PD.GRID_HARDCODED
    _reset_kernel1_counts()
    one = H.hires_grid(params, checkpoint_dir="", device="cuda")
    c1 = _kernel1_counts()
    with tempfile.TemporaryDirectory() as ck:
        _reset_kernel1_counts()
        chunked = H.hires_grid(params, chunk_size=HIRES_CHUNK,
                               checkpoint_dir=ck, device="cuda")
        c2 = _kernel1_counts()
        n_chunks = len([f for f in Path(ck).iterdir() if f.name.startswith("chunk")])
    P = one["A2T"].size
    n = 2 * 32                                     # sweep_phase_grid's chi_pad
    per_sm = J.smem_occupancy(n, n, torch.complex64, "cuda")
    even = P * len(range(0, hc["n_sites"] - 1, 2))
    odd = P * (hc["n_sites"] - 1) - even
    d_a2t = float(np.abs(one["A2T"] - chunked["A2T"]).max())
    same = bool(np.array_equal(one["success"], chunked["success"]))
    print(f"[hires] {len(one['h_values'])} x {len(one['T_values'])} = {P} "
          f"points (L={hc['n_sites']}, {hc['n_periods']} periods, chi cap "
          f"{hc['max_chi']}): one program {one['points_per_second']:.2f} "
          f"points/s ({one['wall']:.2f} s; [{even}, {n}, {n}] and [{odd}, {n}, "
          f"{n}] calls, {per_sm} CTAs an SM: {-(-even // (per_sm * SMS))} / "
          f"{-(-odd // (per_sm * SMS))} waves of {per_sm * SMS}; {c1['calls']} "
          f"SVD calls, {c1['sweeps']} sweeps in {c1['launches']} launches); "
          f"{n_chunks} checkpointed chunks of {HIRES_CHUNK} "
          f"{chunked['points_per_second']:.2f} points/s ({chunked['wall']:.2f} "
          f"s, {c2['launches']} launches); success rate "
          f"{100 * one['success'].mean():.1f}%; one program against chunks: "
          f"max |d A2T| {d_a2t:.2e} (< {SCORE_TOL:.0e}), verdicts equal {same}",
          flush=True)
    _check(P == 500 and n_chunks == -(-P // HIRES_CHUNK), "[hires] grid size")
    _check(c1["smem"] > 0 and c2["smem"] > 0 and c1["host_reads"] == 0,
           f"[hires] did not run kernel 1's shared-memory variant: {c1}, {c2}")
    _check(d_a2t < SCORE_TOL and same, "[hires] chunks differ from one program")
    # the four corners in complex128 on the host CPU (LAPACK splits)
    hv, Tv = one["h_values"], one["T_values"]
    with _host_threads():
        ref, dt_ref = _timed(lambda: PD.sweep_phase_grid(
            hv[[0, -1]], Tv[[0, -1]], params, device="cpu",
            dtype=torch.complex128))
    rec = {(float(h), float(T)): i for i, (h, T) in
           enumerate(zip(one["sweep"]["hs"], one["sweep"]["Ts"]))}
    idx = [rec[(float(h), float(T))] for h, T in zip(ref["hs"], ref["Ts"])]
    card = {k: v[idx] for k, v in one["sweep"]["traces"].items()}
    d_ex, d_all, rows = _exact_drift(card, ref["traces"],
                                     ("sz_sites", "loschmidt_echo"),
                                     ref["traces"]["trunc_err"])
    card_recs = [one["sweep"]["records"][i] for i in idx]
    d_rec = max(abs(a["A2T"] - b["A2T"]) for a, b in zip(card_recs, ref["records"]))
    verdicts = ([a["success"] for a in card_recs]
                == [b["success"] for b in ref["records"]])
    print(f"[hires] points {idx} (the corners) against complex128 LAPACK on "
          f"the host CPU ({dt_ref:.1f} s): before the reference truncates "
          f"({rows} rows) max |d sz|, |d LE| {d_ex:.2e} (< "
          f"{GRID_REFERENCE_TOL['exact']:.0e}), all rows {d_all:.2e}; A2T card "
          f"{[round(float(r['A2T']), 4) for r in card_recs]} / host "
          f"{[round(float(r['A2T']), 4) for r in ref['records']]}, max |d| "
          f"{d_rec:.2e} (< {SCORE_TOL:.0e}); verdicts equal {verdicts}",
          flush=True)
    _check(d_ex < GRID_REFERENCE_TOL["exact"] and d_rec < SCORE_TOL and verdicts,
           f"[hires] corners differ from complex128: {d_ex}, {d_rec}, {verdicts}")
    return {v: c1[v] + c2[v] for v in ("smem", "cluster")}


def phase_multihost_demo():
    """examples/multihost_demo: spawn_cluster with the script's defaults
    (rank 0 in this process, rank 1 a child; two Gloo ranks sharing the
    card), against the same ensemble in one process: A2T to SCORE_TOL and
    the same stringent-score verdict for every realization.  Returns rank
    0's and the one-process run's kernel-1 counts."""
    from timecrystal_tpu_torch.analysis.detection import stringent_dtc_detection
    from timecrystal_tpu_torch.examples import multihost_demo as MD

    args = MD.parse_arguments([])
    _reset_kernel1_counts()
    out, dt = _timed(lambda: MD.spawn_cluster(args))
    c = _kernel1_counts()
    _reset_kernel1_counts()
    ref, dt1 = _timed(lambda: MD.demo_ensemble(device="cuda"))
    c1 = _kernel1_counts()
    size = MD.DEMO
    times = 2.0 * np.arange(size["n_periods"] + 1)

    def verdicts(tr):
        return [stringent_dtc_detection(le, times, 2.0) > 0
                for le in tr["loschmidt_echo"]]

    d = float(np.abs(out["a2t"] - ref["a2t"]).max())
    same = verdicts(out["traces"]) == verdicts(ref["traces"])
    R = len(ref["a2t"])
    print(f"[multihost-demo] spawn_cluster, 2 Gloo ranks sharing the card: "
          f"{R} realizations x {size['n_periods']} periods, L={size['L']}, chi "
          f"{size['chi']} in {dt:.2f} s with the second rank's start-up "
          f"({R * size['n_periods'] / dt:.1f} chain-periods/s); one process "
          f"{dt1:.2f} s; A2T mean {out['a2t'].mean():.4f}, min "
          f"{out['a2t'].min():.4f}; against one process max |d A2T| {d:.2e} (< "
          f"{SCORE_TOL:.0e}), stringent verdicts equal {same} "
          f"({sum(verdicts(ref['traces']))} DTC); rank 0's kernel 1: "
          f"{c['launches']} launches ({c['smem']} smem)", flush=True)
    _check(c["launches"] > 0 and c1["launches"] > 0, "[multihost-demo] kernel 1")
    _check(d < SCORE_TOL and same, f"[multihost-demo] differs from one process: {d}")
    return {v: c[v] + c1[v] for v in ("smem", "cluster")}


def _child_main(args) -> int:
    """Entry of the processes phase_resume and phase_multihost start."""
    import torch

    import timecrystal_tpu_torch  # noqa: F401  (sets full-precision matmuls)

    if not torch.cuda.is_available():
        return 2
    kind = args[0]
    if kind == "rank":
        return _rank_child(*args[1:])
    run = {"resume-window": _window_run, "resume-auto": _auto_run,
           "resume-grid": _grid_sweep}[kind]
    run(Path(args[1]))
    return 1                    # the parent kills it before the run ends


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    import timecrystal_tpu_torch  # noqa: F401  (sets full-precision matmuls)

    t_start = time.perf_counter()

    def stamp(what):
        print(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    name, smi_line = phase_device()
    phase_build()
    stamp("build")
    k1 = phase_kernels()
    stamp("kernel 1 checks")
    k2 = phase_v_kernels()
    resident = phase_v_resident()
    k2.update(resident, max_abs_err=max(k2["max_abs_err"], resident["max_abs_err"]))
    stamp("kernel 2 checks")
    phase_golden()
    stamp("golden")
    launches, window_s, window_ref = phase_real_size()
    phase_window_profile(window_s)
    stamp("window")
    # the saturated steady leg (kernel 1's cluster variant) and the fixed-chi
    # ensemble (its shared-memory variant): the kernel-1 launches of each
    # run an entry point reaches (the settle, the 10-period runs, the closed
    # loop, the chi=512 settle, both grids; each counted from 0) join the
    # main path's
    phase_projected()
    new_shapes, new_worst = phase_new_shapes()
    stamp("projected SVDs")
    psi, gates, tp, settle = _settled_state()
    steady = phase_steady(psi, gates, tp)
    closed = phase_closed_loop(psi, gates, tp)
    chi512, psi2 = phase_steady_chi512(psi, gates, tp)
    del psi
    exact512 = phase_steady_exact_chi512(psi2, gates)
    del psi2
    stamp("steady leg")
    phase_grid, grid_ref = phase_phase_grid()
    grids = (phase_grid, phase_drive_grid())
    stamp("grids")
    # the application layer: the phase and drive diagrams through
    # analysis/phase_diagram.py, the correlation trace, Figures A-D; each
    # path's kernel-1 launches counted from 0 join the main path's
    app = (phase_phase_diagram(grid_ref), phase_drive_diagram(),
           phase_correlation(), phase_figures())
    stamp("application layer")
    # the open-system and ground-state dynamics: the memory figure, the
    # Lindblad solver, the ground state, the dephasing baseline and the
    # two-time correlator
    dyn = (phase_memory(), phase_lindblad(), phase_ground_state(),
           phase_open_system(), phase_two_time())
    stamp("open-system and ground-state dynamics")
    # kill and resume, the two-rank scale-out on the card and the profiling
    # hooks: the launches of every run of an entry point (in this process
    # and, as the children report them, in theirs) join the main path's
    scale = (phase_resume(window_ref), phase_multihost(), phase_profiling())
    print(f"[launches] kernel-1 launches of the runs above (smem / cluster): "
          f"resume {scale[0]['smem']} / {scale[0]['cluster']}, two ranks (the "
          f"children's counts included) {scale[1]['smem']} / "
          f"{scale[1]['cluster']}, profiling {scale[2]['smem']} / "
          f"{scale[2]['cluster']}", flush=True)
    stamp("resume, scale-out and profiling")
    for c in ((settle, chi512, exact512)
              + tuple(r["launches"] for r in steady.values())
              + tuple(closed.values()) + grids + app + dyn + scale):
        for v in ("smem", "cluster"):
            launches[v] += c[v]
    # the JAX package's three examples as entry points of the port
    (quick, quick_resident), hires, demo = (phase_quickstart(), phase_hires(),
                                            phase_multihost_demo())
    print(f"[launches] kernel-1 launches of the examples (smem / cluster): "
          f"quickstart {quick['smem']} / {quick['cluster']}, hires "
          f"{hires['smem']} / {hires['cluster']}, multihost demo (rank 0 and "
          f"the one-process run) {demo['smem']} / {demo['cluster']}; "
          f"quickstart kernel-2 resident launches {quick_resident}", flush=True)
    for c in (quick, hires, demo):
        for v in ("smem", "cluster"):
            launches[v] += c[v]
    stamp("examples")
    phase_tdvp_oracle()
    k2["launches"], period_s = phase_range()
    k2["launches"] += quick_resident
    phase_range_profile(period_s)
    stamp("range")
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi_line)
    source = "timecrystal_tpu_torch/csrc/jacobi_sweep.cu"
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    # kernel 1 is reported as its two variants, each with its launches on
    # the main paths (shared memory: the window, the phase and drive grids
    # and the application layer's paths; cluster: the n512 leg and the
    # steady leg), ms per sweep at
    # [320, 64, 64] (shared memory) and [20, 512, 512] (cluster), and ms per
    # sweep at every shape timed in ms_by_shape.  Kernel 2 as the main path
    # runs it, the resident variant: ms per sweep and per call at
    # [1, 96, 96], launches one per SVD call; per_sweep_ms is the per-sweep
    # variant's sweep on the same shape
    for (B, n, m), t in new_shapes.items():
        k1[t["variant"]]["ms_by_shape"][f"{B}x{n}x{m}"] = t["ms"]
    kernel1 = [
        {"name": f"jacobi_sv_{v}", "route": "cuda", "source": source,
         "replaces": "timecrystal_tpu/ops/pallas/jacobi_svd.py:159",
         **{k: dict(k1[v], launches=launches[v],
                    max_abs_err=max(k1[v]["max_abs_err"], new_worst))[k]
            for k in keys + ("ms_by_shape",)}}
        for v in ("smem", "cluster")]
    print(json.dumps({"kernels": kernel1 + [
        {"name": "jacobi_svd_resident", "route": "cuda", "source": source,
         "replaces": "timecrystal_tpu/ops/pallas/jacobi_svd.py:75",
         **{k: k2[k] for k in keys + ("call_ms", "sweeps_per_call",
                                      "per_sweep_ms")}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(_child_main(sys.argv[2:]))
    sys.exit(main())

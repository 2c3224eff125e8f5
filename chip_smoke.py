#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``timecrystal_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device (cuda:0), nvcc, and the repository checkout around
it; it imports only the port, torch and numpy.  Phases:

  1. device: torch's device name and nvidia-smi's name and power limit;
  2. build: the Jacobi sweep kernel from timecrystal_tpu_torch/csrc/ (sm_90a);
  3. kernel checks: jacobi_sv on complex64 [4, 512, 512] against LAPACK,
     the kernel against its torch twin (float64 one sweep and full calls;
     float32 at every width of the chi ladder), with times per call;
  4. tests/golden/entangling_L10.npz through CustomFloquet on the GPU;
  5. the real size: the chi-staged ensemble window of bench.py's CONFIG
     (L=40, chi cap 256, R=16, 20 merged periods), then 3 fixed chi=256
     merged periods of one chain (the kernel at n=512).

Any failed check raises, so the exit code is not 0.  The last two lines are
a JSON summary of the kernel and the device JSON.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden" / "entangling_L10.npz"
LADDER = (64, 96, 144, 216, 328, 496, 512)   # n = 2 chi, chi 32 -> 256 x1.5
CONFIG = dict(L=40, chi=256, theta_frac=0.9, h=0.3, tau=1.0, seed=42, R=16,
              n_periods=20, chi_start=32, chunk=5, growth=1.5, svd_min=1e-7)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


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


def phase_build():
    from timecrystal_tpu_torch.ops.cuda_build import load_kernel_library

    t0 = time.perf_counter()
    _, info = load_kernel_library("jacobi_sweep")
    ptxas = [ln.strip() for ln in info.log.splitlines() if "registers" in ln]
    print(f"[build] {info.path.relative_to(REPO)} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {info.seconds:.1f} s): {' '.join(info.command[1:4])}; "
          f"ptxas: {' | '.join(ptxas)}", flush=True)
    _check("arch=compute_90a,code=sm_90a" in info.command, "not built for sm_90a")


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
    launches0, calls0 = J.KERNEL_LAUNCHES, J.CUDA_SV_CALLS
    S, V = J.jacobi_sv(torch.as_tensor(M, device="cuda"), polish=k)
    sweeps = J.KERNEL_LAUNCHES - launches0
    _check(sweeps > 0 and J.CUDA_SV_CALLS == calls0 + 1,
           "jacobi_sv on a CUDA tensor did not launch the kernel")
    S = S.cpu().numpy()
    Sref = np.linalg.svd(M.astype(np.complex128), compute_uv=False)
    serr = float(np.max(np.abs(S - Sref)) / Sref.max())
    Vk = V.cpu().numpy()[..., :k].astype(np.complex128)
    G = np.einsum("bji,bjk->bik", Vk.conj(), Vk)
    dg = np.einsum("bii->bi", G).real
    off = float(np.abs(G - np.einsum("bi,ij->bij", dg, np.eye(k))).max())
    print(f"[kernel-vs-lapack] complex64 [4, 512, 512] logspace(0,-7): "
          f"S err {serr:.2e} x sigma_max (< 5e-5), kept-V Gram off-diag "
          f"{off:.2e} (< 5e-5), {sweeps} sweeps", flush=True)
    _check(serr < 5e-5, f"S error {serr} vs LAPACK")
    _check(bool(np.allclose(dg, np.round(dg), atol=1e-4)), "V Gram diagonal")
    _check(off < 5e-5, f"V Gram off-diagonal {off}")

    # (b) float64: one sweep, then full calls, kernel against twin
    gen = torch.Generator(device="cuda").manual_seed(1)
    X = torch.randn(4, 64, 64, dtype=torch.complex128, device="cuda",
                    generator=gen)
    Xk, mk = J._jacobi_sweep_cuda(X.clone())
    Xt, mt = J._jacobi_sweep_torch(X.clone())
    sweep_err = float((Xk - Xt).abs().max())
    meas_rel = float(((mk - mt).abs() / mt.abs().clamp_min(1e-300)).max())
    Sk, _ = J.jacobi_sv(X, polish=32)
    St, _ = J.jacobi_sv_plain(X, polish=32)
    s64_err = float((Sk - St).abs().max() / St.max())
    print(f"[kernel-vs-twin f64] one sweep [4, 64, 64]: max |dX| {sweep_err:.2e}, "
          f"measure rel {meas_rel:.2e}; jacobi_sv S err {s64_err:.2e} x "
          f"sigma_max (< 1e-10)", flush=True)
    _check(sweep_err < 1e-12, f"f64 sweep differs from the twin: {sweep_err}")
    _check(meas_rel < 1e-9, f"f64 sweep measure differs: {meas_rel}")
    _check(s64_err < 1e-10, f"f64 S differs from the twin: {s64_err}")

    # (c) float32 at every ladder width, at the single-chain call shape (20
    # bonds).  One sweep: the convergence measure (all pair overlaps of the
    # sweep) must agree, and the rotations must be unitary (X^H X is
    # invariant; rotated rows themselves may differ by a rotation inside a
    # near-degenerate pair, a gauge freedom).  Full calls run to
    # convergence (max_sweeps=24) so S compares the arithmetic, not where a
    # 12-sweep cap cuts two rounding paths.  Times per call are taken at the
    # window's call shape (R * bonds = 16 * 20 = 320 matrices), default cap.
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
        l0 = J.KERNEL_LAUNCHES
        Sk, _ = J.jacobi_sv(th, max_sweeps=24, polish=n // 2)
        sw = J.KERNEL_LAUNCHES - l0
        St, _ = J.jacobi_sv_plain(th, max_sweeps=24, polish=n // 2)
        err = float((Sk - St).abs().max() / St.max())
        worst = max(worst, float((Sk - St).abs().max()))
        th = _tebd_like(gen, 320, n, torch.complex64)
        _, t_k = _timed(lambda: J.jacobi_sv(th, polish=n // 2), reps=3)
        _, t_t = _timed(lambda: J.jacobi_sv_plain(th, polish=n // 2))
        print(f"[kernel-vs-twin f32] n={n}: one sweep [20, {n}, {n}] measure rel "
              f"{meas_rel:.2e} (< 1e-6), X^H X drift {gram:.2e} (< 1e-5); "
              f"jacobi_sv S err {err:.2e} x sigma_max (< 1e-5) in {sw} sweeps; "
              f"per call at [320, {n}, {n}]: kernel {t_k * 1e3:.1f} ms, twin "
              f"{t_t * 1e3:.1f} ms", flush=True)
        _check(meas_rel < 1e-6, f"f32 sweep measure at n={n}: {meas_rel}")
        _check(gram < 1e-5, f"f32 sweep not unitary at n={n}: {gram}")
        _check(err < 1e-5, f"f32 S at n={n} differs from the twin: {err}")
        del th

    # (d) one sweep, CUDA events: the window's first stage [320, 64, 64]
    # (the "ms" of the summary) and the single-chain n=512 leg [20, 512, 512]
    ms = {}
    for B, n in ((320, 64), (20, 512)):
        X = _tebd_like(gen, B, n, torch.complex64).conj().resolve_conj().contiguous()
        for name, fn in (("kernel", J._jacobi_sweep_cuda),
                         ("twin", J._jacobi_sweep_torch)):
            fn(X.clone())
            Xs = [X.clone() for _ in range(5)]
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for x in Xs:
                fn(x)
            t1.record()
            torch.cuda.synchronize()
            ms[(name, B, n)] = t0.elapsed_time(t1) / len(Xs)
        print(f"[sweep time] one sweep, complex64 [{B}, {n}, {n}]: kernel "
              f"{ms[('kernel', B, n)]:.3f} ms, twin {ms[('twin', B, n)]:.3f} ms",
              flush=True)
    return worst, ms[("kernel", 320, 64)], ms[("twin", 320, 64)]


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
    l0 = J.KERNEL_LAUNCHES
    tp = TruncParams.reference_hot_path()._replace(svd_method="jacobi")
    tr, _, info = CustomFloquet(m, tp).evolve_floquet_traces(psi0, n)
    d_sz = float(np.max(np.abs(tr["sz_sites"] - sz_ref)))
    d_le = float(np.max(np.abs(tr["loschmidt_echo"] - le_ref)))
    print(f"[golden] entangling_L10 (L={L}, chi={chi}, {n} periods, complex64, "
          f"kernel): max |d sz| {d_sz:.2e}, max |d LE| {d_le:.2e} (< 1e-4); "
          f"{J.KERNEL_LAUNCHES - l0} sweeps, {info['periods_per_second']:.1f} "
          f"periods/s", flush=True)
    _check(J.KERNEL_LAUNCHES > l0, "golden run did not launch the kernel")
    _check(d_sz < 1e-4 and d_le < 1e-4, "golden trace mismatch")


def phase_real_size():
    import torch

    from timecrystal_tpu_torch.core.mps import create_initial_state
    from timecrystal_tpu_torch.core.truncate import TruncParams
    from timecrystal_tpu_torch.dynamics.tebd import evolve_floquet_scan
    from timecrystal_tpu_torch.models.kicked_ising import (
        draw_disorder_reference, make_floquet_gates)
    from timecrystal_tpu_torch.ops import jacobi_svd as J
    from timecrystal_tpu_torch.parallel.sweep import (SweepSpec, _basis_indices,
                                                      evolve_batch_auto)

    c = CONFIG
    L, R, n_periods = c["L"], c["R"], c["n_periods"]
    h = np.stack([draw_disorder_reference(L, c["h"], c["seed"] + r)
                  for r in range(R)])
    spec = SweepSpec(L=L, chi=c["chi"], n_periods=n_periods,
                     theta=c["theta_frac"] * float(np.pi),
                     tp=TruncParams(chi_max=0, svd_min=c["svd_min"]),
                     dtype="float32", frame="merged")
    torch.cuda.reset_peak_memory_stats()
    J.KERNEL_LAUNCHES = 0           # the main path's count starts here
    J.CUDA_SV_CALLS = 0
    traces, info = evolve_batch_auto(
        h, np.full(R, c["tau"]), _basis_indices(L, "neel"), spec,
        chi_start=c["chi_start"], chunk_periods=c["chunk"],
        growth=c["growth"], device="cuda")
    win_launches, win_calls = J.KERNEL_LAUNCHES, J.CUDA_SV_CALLS
    for k, v in traces.items():
        _check(bool(np.all(np.isfinite(v))), f"non-finite trace {k}")
    _check(traces["sz_sites"].shape == (R, n_periods + 1, L), "sz shape")
    le = traces["loschmidt_echo"]
    _check(float(le.min()) >= 0.0 and float(le.max()) <= 1.0 + 1e-5,
           f"LE outside [0, 1]: {le.min()} {le.max()}")
    _check(int(traces["max_chi"].max()) <= c["chi"], "max_chi above the cap")
    _check(win_launches > 0, "the window launched no kernel")
    schedule = [c["chi_start"]] + [e["to"] for e in info["chi_escalations"]]
    n_chunks = (-(-n_periods // c["chunk"])
                + sum(1 for e in info["chi_escalations"] if not e.get("ahead")))
    print(f"[window] L={L} R={R} {n_periods} merged periods: "
          f"{info['chain_periods_per_second']:.2f} chain-periods/s "
          f"({info['wall_time']:.1f} s); chi schedule {schedule} "
          f"(escalations {info['chi_escalations']}); {win_calls} SVD calls, "
          f"{win_launches} sweeps ({win_launches / max(win_calls, 1):.2f} per "
          f"call); host syncs: {win_launches} sweep-exit reads + {n_chunks} "
          f"chunk fetches; max_chi {int(traces['max_chi'].max())}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)

    # n = 512: three fixed chi=256 merged periods of one chain
    gates = make_floquet_gates(1.0, torch.as_tensor(h[0], device="cuda"),
                               c["tau"], theta=spec.theta,
                               dtype=torch.complex64)
    psi0 = create_initial_state(L, "neel", chi=c["chi"], dtype=torch.complex64,
                                device="cuda")
    l0, c0 = J.KERNEL_LAUNCHES, J.CUDA_SV_CALLS
    (psi, tr), dt = _timed(lambda: evolve_floquet_scan(
        psi0, gates, 3, spec.tp._replace(svd_method="jacobi"), frame="merged"))
    sw, calls = J.KERNEL_LAUNCHES - l0, J.CUDA_SV_CALLS - c0
    sz = tr["sz_sites"].cpu().numpy()
    _check(bool(np.all(np.isfinite(sz))) and sz.shape == (3, L), "n512 traces")
    _check(psi.chi == c["chi"] and sw > 0, "n512 leg did not launch the kernel")
    print(f"[n512] one chain, chi=256, 3 merged periods: {3 / dt:.3f} "
          f"periods/s ({dt:.2f} s incl. frame entry/exit); {calls} SVD calls "
          f"at n=512, {sw} sweeps ({sw / max(calls, 1):.2f} per call)",
          flush=True)
    return J.KERNEL_LAUNCHES


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    import timecrystal_tpu_torch  # noqa: F401  (sets full-precision matmuls)

    t_start = time.perf_counter()
    name, smi_line = phase_device()
    phase_build()
    worst, ms, plain_ms = phase_kernels()
    phase_golden()
    launches = phase_real_size()
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi_line)
    print(json.dumps({"kernels": [{
        "name": "jacobi_sweep", "route": "cuda",
        "source": "timecrystal_tpu_torch/csrc/jacobi_sweep.cu",
        "replaces": "timecrystal_tpu/ops/pallas/jacobi_svd.py:159",
        "launches": launches, "max_abs_err": worst,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

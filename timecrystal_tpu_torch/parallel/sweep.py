"""Batched disorder ensembles: the chi-staged ensemble window.

Port of ``evolve_batch_auto`` from ``timecrystal_tpu/parallel/sweep.py``.
The JAX version ``vmap``s whole evolutions over the realization axis; here
that axis R is the MPS's leading batch axis, and ``core.truncate`` folds it
into the bond axis, so one SVD call takes R * n_bonds matrices.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..core.mps import pad_mps, product_state
from ..core.observables import add_derived_magnetization
from ..core.truncate import PROJECTED_SVD_METHODS, TruncParams
from ..dynamics.tebd import (_next_chi, _stage_decision, _stage_err_tol,
                             evolve_floquet_scan, to_host)
from ..models.kicked_ising import make_floquet_gates


class SweepSpec(NamedTuple):
    """Static configuration of a batched Floquet evolution."""

    L: int
    chi: int
    n_periods: int
    J: float = 1.0
    theta: float = float(np.pi)
    tp: TruncParams = TruncParams.reference_hot_path()
    dtype: str = "float32"   # 'float32' (complex64) | 'float64' (complex128)
    frame: str = "strict"    # 'strict' | 'merged' (see tebd.evolve_floquet_scan)


def _basis_indices(L: int, state_type: str) -> np.ndarray:
    if state_type == "neel":
        return np.array([0 if i % 2 == 0 else 1 for i in range(L)], np.int32)
    if state_type == "all_up":
        return np.zeros(L, np.int32)
    if state_type == "all_down":
        return np.ones(L, np.int32)
    raise ValueError(f"Unknown state type for sweeps: {state_type}")


def _stage_tp(tp: TruncParams, device: torch.device) -> TruncParams:
    """Per-stage svd_method of the staged evolution: 'auto' is pinned to the
    Jacobi kernel on a CUDA device.  The escalation criteria read
    truncation error and significant-rank occupancy off the SVD output, so
    the SVD must have the Jacobi noise floor (junk sigmas of a noisier SVD
    force spurious escalation).  On the CPU 'auto' stays (-> 'native'),
    as in the JAX package."""
    if tp.svd_method != "auto" or torch.device(device).type == "cpu":
        return tp
    return tp._replace(svd_method="jacobi")


def evolve_batch_auto(h_fields, taus, basis_indices, spec: SweepSpec,
                      chi_start: int = 32, chunk_periods: int = 5,
                      checkpoint_dir: str | None = None, mesh=None,
                      axis_name: str = "batch", growth: float = 2.0,
                      cap_svd_method: str | None = None,
                      correlation_site: int | None = None,
                      device="cuda"):
    """Chi-staged batched Floquet evolution: the ensemble production path.

    All realizations share ONE chi schedule.  Evolution starts padded at
    ``chi_start`` and proceeds in chunks; when any realization truncates
    real weight the chunk re-runs from the (exact) pre-chunk state at the
    next ladder chi, and at 15/16 significant occupancy the schedule grows
    ahead without a re-run (dynamics.tebd._stage_decision).

    ``h_fields`` [R, L] and ``taus`` [R] (numpy or tensors) are cast to the
    spec's real dtype on ``device``.  Returns (traces, info): host numpy
    traces [R, n_periods+1, ...] (t=0 row prepended) and info with
    wall_time, chain_periods_per_second, chi_pad_used, chi_escalations,
    n_rerun_periods.

    The JAX version floors chi at 16 on the TPU, because n = 2 chi < 32
    routes to the Gram/eigh SVD there; this port sends every even n to the
    Jacobi kernel, so it has no floor.
    """
    for name, value, item in (
            ("checkpoint_dir", checkpoint_dir, "Utilities"),
            ("mesh", mesh, "Scale-out"),
            ("cap_svd_method", cap_svd_method, "jacobi_proj / jacobi_core"),
            ("correlation_site", correlation_site, "Observables")):
        if value is not None:
            raise NotImplementedError(f"{name} is not ported yet "
                                      f"(ROADMAP.md queue 1, '{item}')")
    device = torch.device(device)
    cdtype = torch.complex64 if spec.dtype == "float32" else torch.complex128
    rdtype = cdtype.to_real()
    err_tol = _stage_err_tol(cdtype, spec.tp.svd_min, spec.L - 1)
    h = torch.as_tensor(np.asarray(h_fields), dtype=rdtype, device=device)
    taus_t = torch.as_tensor(np.asarray(taus), dtype=rdtype, device=device)
    R, L = h.shape
    basis = np.asarray(basis_indices)
    cap = min(spec.chi, spec.tp.chi_max) if spec.tp.chi_max else spec.chi
    chi = min(chi_start, cap)
    n_periods = spec.n_periods

    start = time.perf_counter()
    gates = make_floquet_gates(spec.J, h, taus_t, theta=spec.theta,
                               dtype=cdtype)

    def fresh(c):
        return product_state(np.broadcast_to(basis, (R, L)), chi=c,
                             dtype=cdtype, device=device)

    psi = fresh(chi)
    psi0 = psi
    p_done, n_rerun = 0, 0
    escalations: list = []
    chunks: list = []
    while p_done < n_periods:
        n = min(chunk_periods, n_periods - p_done)
        tp = _stage_tp(spec.tp, device)
        if chi < cap and tp.svd_method in PROJECTED_SVD_METHODS:
            # below the cap escalation reads trunc_err, which projected
            # methods report at the noise floor
            tp = tp._replace(svd_method="jacobi")
        psi_next, tr = evolve_floquet_scan(psi, gates, n, tp, ref_state=psi0,
                                           frame=spec.frame)
        tr = to_host(tr)
        exit_lam = psi_next.lam.cpu().numpy()
        # the batch shares one schedule: ANY realization's truncation
        # escalates all; the merged frame's entry/exit error is included
        errs = np.append(np.ravel(tr["trunc_err"]),
                         np.ravel(tr["trunc_err_boundary"]))
        saturated, ahead = _stage_decision(errs, exit_lam, chi, err_tol)
        if saturated and chi < cap:
            new_chi = _next_chi(chi, cap, growth)
            escalations.append({"period": p_done, "from": chi, "to": new_chi})
            n_rerun += n
            chi = new_chi
            psi = pad_mps(psi, chi)
            psi0 = pad_mps(psi0, chi)
            continue
        if ahead and chi < cap and p_done + n < n_periods:
            new_chi = _next_chi(chi, cap, growth)
            escalations.append({"period": p_done + n, "from": chi,
                                "to": new_chi, "ahead": True})
            chi = new_chi
            psi_next = pad_mps(psi_next, chi)
            psi0 = pad_mps(psi0, chi)
        psi = psi_next
        chunks.append(tr)
        p_done += n

    wall_time = time.perf_counter() - start
    keys = ("sz_sites", "loschmidt_echo", "entropies", "max_chi", "trunc_err")
    cat = {k: np.concatenate([c[k] for c in chunks], axis=1)[:, :n_periods]
           for k in keys}
    sz0 = np.broadcast_to((1.0 - 2.0 * basis).astype(cat["sz_sites"].dtype),
                          (R, L))
    traces = {
        "sz_sites": np.concatenate([sz0[:, None, :], cat["sz_sites"]], axis=1),
        "loschmidt_echo": np.concatenate(
            [np.ones((R, 1), cat["loschmidt_echo"].dtype),
             cat["loschmidt_echo"]], axis=1),
        "max_chi": np.concatenate(
            [np.ones((R, 1), cat["max_chi"].dtype), cat["max_chi"]], axis=1),
        "entropy_mid": np.concatenate(
            [np.zeros((R, 1), cat["entropies"].dtype),
             cat["entropies"][:, :, L // 2]], axis=1),
        "trunc_err": np.concatenate(
            [np.zeros((R, 1), cat["trunc_err"].dtype), cat["trunc_err"]],
            axis=1),
    }
    add_derived_magnetization(traces, L)
    info = {
        "wall_time": wall_time,
        "chain_periods_per_second": (R * n_periods / wall_time
                                     if wall_time > 0 else float("inf")),
        "chi_pad_used": chi,
        "chi_escalations": escalations,
        "n_rerun_periods": n_rerun,
    }
    return traces, info

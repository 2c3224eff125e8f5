"""Floquet TEBD evolution: the period loop, the figure path and the
chi-staged evolution.

Port of the Floquet part of ``timecrystal_tpu/dynamics/tebd.py``.  JAX's
``lax.scan`` over periods becomes a Python loop; the observables of every
measurement stay on the device (stacked per chunk) and reach the host once
per chunk, not once per period.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core import gates as G
from ..core.mps import (MPS, entanglement_entropy, expectation_one_site,
                        max_bond_dimension, overlap)
from ..core.observables import (add_derived_magnetization,
                                zz_correlation_profile)
from ..core.truncate import PROJECTED_SVD_METHODS, TruncParams
from ..models.kicked_ising import (FloquetGates, floquet_period,
                                   floquet_period_merged, ising_half_step,
                                   ising_half_step_inverse)

log = logging.getLogger(__name__)

TRACE_KEYS = ("sz_sites", "loschmidt_echo", "entropies", "max_chi",
              "trunc_err")


def _abs2(z: torch.Tensor) -> torch.Tensor:
    return z.real * z.real + z.imag * z.imag


def _measure(psi: MPS, ref: MPS, sz_op: torch.Tensor, err: torch.Tensor,
             correlation_site: int | None = None) -> dict:
    out = dict(sz_sites=expectation_one_site(psi, sz_op).real,
               loschmidt_echo=_abs2(overlap(ref, psi)),
               entropies=entanglement_entropy(psi),
               max_chi=max_bond_dimension(psi),
               trunc_err=err)
    if correlation_site is not None:
        out["zz_corr"] = zz_correlation_profile(psi, correlation_site)
    return out


def _trace_keys(correlation_site: int | None) -> tuple:
    return TRACE_KEYS + (() if correlation_site is None else ("zz_corr",))


def to_host(traces: dict) -> dict:
    """Device traces -> host numpy (one transfer per array)."""
    return {k: v.cpu().numpy() if torch.is_tensor(v) else v
            for k, v in traces.items()}


def evolve_floquet_scan(psi0: MPS, gates: FloquetGates, n_periods: int,
                        tp: TruncParams, with_states: bool = False,
                        frame: str = "strict", ref_state: MPS | None = None,
                        measure_every: int = 1, measure_phase: int = -1,
                        correlation_site: int | None = None):
    """n_periods of U_F with observables measured in-loop.

    Returns (final MPS, traces) with device tensors per measurement, the
    initial state excluded: sz_sites [..., n_meas, L], loschmidt_echo,
    max_chi, trunc_err [..., n_meas], entropies [..., n_meas, L+1], and
    trunc_err_boundary [...] (the merged frame's entry/exit half-step error;
    zero in the strict frame).  Leading axes are the MPS's ensemble axes.

    ``measure_every=m`` measures once per block of m periods, after period
    ``measure_phase`` of the block (default -1 = the last); trunc_err holds
    the error of the measured period, so sparse and dense grids agree.

    ``frame='merged'`` evolves phi = H psi (one Ising sweep per period);
    sz and LE traces are exact, entropies/max_chi belong to the
    half-step-shifted state, and the returned MPS is mapped back with
    H^{-1}.  ``ref_state`` is the Loschmidt reference (default psi0).

    ``correlation_site=i`` adds ``zz_corr [..., n_meas, L]``: the
    <sigma^z_i sigma^z_j> profile of every measurement
    (``core.observables.zz_correlation_profile``), exact in both frames (H
    is z-diagonal).
    """
    if with_states:
        raise NotImplementedError("with_states is not ported yet (ROADMAP.md "
                                  "queue 1, 'The rest of tebd.py')")
    sz_op = G.pauli_c("z", psi0.dtype, psi0.device)
    if ref_state is None:
        ref_state = psi0
    m = int(measure_every)
    if m < 1 or n_periods % m != 0:
        raise ValueError(f"measure_every={m} must divide n_periods={n_periods}")
    n_meas = n_periods // m
    phase = (m - 1) if measure_phase < 0 else int(measure_phase)
    if not 0 <= phase < m:
        raise ValueError(f"measure_phase={measure_phase} outside block of {m}")
    time_dim = len(psi0.lead)

    if frame == "merged":
        step = floquet_period_merged
        ref, _ = ising_half_step(ref_state, gates, tp)
        psi, e0 = ising_half_step(psi0, gates, tp)
    elif frame == "strict":
        step = floquet_period
        ref, psi, e0 = ref_state, psi0, None
    else:
        raise ValueError(f"unknown frame: {frame}")

    outs = []
    for _ in range(n_meas):
        for i in range(m):
            psi, e = step(psi, gates, tp)
            if i == phase:
                outs.append(_measure(psi, ref, sz_op, e, correlation_site))
    if not outs:            # n_periods == 0: empty traces of the right shapes
        outs = [_measure(psi, ref, sz_op, psi.lam.new_zeros(psi.lead),
                         correlation_site)]
        n_meas = 0
    traces = {k: torch.stack([o[k] for o in outs], time_dim).narrow(
        time_dim, 0, n_meas) for k in _trace_keys(correlation_site)}
    if frame == "merged":
        psi, e_exit = ising_half_step_inverse(psi, gates, tp)
        # frame-change bookkeeping error, kept out of the per-period trace;
        # the chi-staged evolutions fold it into their saturation signal
        traces["trunc_err_boundary"] = e0 + e_exit
    else:
        traces["trunc_err_boundary"] = psi0.lam.new_zeros(psi0.lead)
    return psi, traces


def _initial_observables(psi0: MPS, correlation_site: int | None = None) -> dict:
    sz_op = G.pauli_c("z", psi0.dtype, psi0.device)
    return _measure(psi0, psi0, sz_op, psi0.lam.new_zeros(psi0.lead),
                    correlation_site)


class CustomFloquet:
    """Floquet evolution of a KickedIsingModel (the figure path)."""

    def __init__(self, kicked_ising_model,
                 trunc_params: dict | TruncParams | None = None):
        self.model = kicked_ising_model
        if isinstance(trunc_params, TruncParams):
            self.trunc_params = trunc_params
        elif trunc_params is None:
            self.trunc_params = TruncParams(chi_max=100, svd_min=1e-12,
                                            trunc_cut=1e-10)
        else:
            # a partial dict keeps the reference defaults for missing keys
            d = dict(trunc_params)
            d.setdefault("chi_max", 100)
            d.setdefault("trunc_cut", 1e-10)
            self.trunc_params = TruncParams.from_dict(d)

    def evolve_floquet_traces(self, psi_initial: MPS, n_periods: int,
                              measure_every: int = 1,
                              correlation_site: int | None = None
                              ) -> Tuple[Dict, List[float], Dict]:
        """Observable traces without materializing states: (traces, times,
        info), traces of length n_stored + 1 (initial state included).
        ``measure_every=m`` stores after periods 1, m+1, 2m+1, ...
        (measured in-loop when m divides n_periods).  ``correlation_site=i``
        adds ``zz_corr [n_stored+1, L]``, the <sigma^z_i sigma^z_j> profile
        of every stored state."""
        start = time.perf_counter()
        if measure_every > 1 and n_periods % measure_every == 0:
            psi_final, tr = evolve_floquet_scan(
                psi_initial, self.model.gates, n_periods, self.trunc_params,
                measure_every=measure_every, measure_phase=0,
                correlation_site=correlation_site)
            sel = np.arange(n_periods // measure_every)
            periods = sel * measure_every
        else:
            psi_final, tr = evolve_floquet_scan(
                psi_initial, self.model.gates, n_periods, self.trunc_params,
                correlation_site=correlation_site)
            sel = np.arange(0, n_periods, measure_every)
            periods = sel
        tr = to_host(tr)          # waits for the device
        wall_time = time.perf_counter() - start

        init = to_host(_initial_observables(psi_initial, correlation_site))
        traces = {k: np.concatenate([np.asarray(init[k])[None], tr[k][sel]],
                                    axis=0) for k in _trace_keys(correlation_site)}
        add_derived_magnetization(traces, psi_initial.L)
        times = [0.0] + [(int(p) + 1) * 2 * self.model.tau for p in periods]
        bond_dims = [int(x) for x in traces["max_chi"]]
        info = {
            "wall_time": wall_time,
            "bond_dimensions": bond_dims,
            "periods_per_second": (n_periods / wall_time if wall_time > 0
                                   else float("inf")),
            "final_bond_dim": bond_dims[-1],
            "n_periods": n_periods,
            "truncation_errors": traces["trunc_err"].tolist(),
        }
        return traces, times, info


def _next_chi(chi: int, cap: int, growth: float) -> int:
    """Next padded chi on the escalation ladder: ceil(chi * growth)
    rounded up to a multiple of 4, clamped to [chi+4, cap]."""
    nc = int(np.ceil(chi * growth))
    nc = ((nc + 3) // 4) * 4
    return min(cap, max(chi + 4, nc))


def _stage_err_tol(dtype, svd_min: float = 0.0, bonds: int = 10) -> float:
    """Escalation threshold on per-period truncation error: far above the
    dtype's SVD noise floor, far below physical truncation; scales with a
    coarse ``svd_min`` times the bond count.  ``dtype`` is the working
    dtype (complex or real)."""
    f32 = dtype in (torch.float32, torch.complex64)
    floor = 1e-8 if f32 else 1e-20
    return max(floor, 10.0 * max(int(bonds), 1) * float(svd_min) ** 2)


def _stage_decision(trunc_err, exit_lam, chi: int, err_tol: float):
    """(saturated, ahead) escalation decision of the chi-staged evolutions:
    ``saturated`` when some period discarded more than ``err_tol``;
    ``ahead`` when the chunk-exit SIGNIFICANT rank (lam > 1e-5 x per-bond
    max; float32 junk sigmas must not count) fills >= 15/16 of chi."""
    saturated = bool(np.max(np.asarray(trunc_err)) > err_tol)
    lam = np.asarray(exit_lam)
    lam_max = np.max(lam, axis=-1, keepdims=True)
    sig = np.sum(lam > 1e-5 * lam_max, axis=-1)
    ahead = bool(np.max(sig) >= (15 * chi) // 16)
    return saturated, ahead


def evolve_floquet_auto(model_kwargs: dict, state_type: str, n_periods: int,
                        trunc_params: dict | TruncParams | None = None,
                        chi_start: int = 16, chi_limit: int = 256,
                        measure_every: int = 1, chunk_periods: int = 16,
                        checkpoint_dir: str | None = None,
                        frame: str = "strict", growth: float = 2.0,
                        cap_svd_method: str | None = None,
                        state_rng: np.random.Generator | None = None):
    """Chi-escalating evolution of one chain: evolve in chunks at a small
    padded chi; a chunk that truncates real weight re-runs from the (exact)
    pre-chunk state at the next ladder chi, and a chunk whose exit state
    fills 15/16 of the padding grows chi ahead.

    ``model_kwargs`` are KickedIsingModel arguments without chi (``device``
    and ``dtype`` included).  Returns (traces, times, info, model); info is
    also logged at DEBUG level (the record's ``run_info``) for callers that
    only see a wrapper's return value, such as the figures'.

    The JAX version floors the ladder at chi=16 on the TPU, because n < 32
    routes to the Gram/eigh SVD there; here every even n runs the Jacobi
    kernel, so there is no floor.
    """
    from ..core.mps import pad_mps, product_state, state_basis_indices
    from ..models.kicked_ising import KickedIsingModel

    if checkpoint_dir is not None:
        raise NotImplementedError("checkpoint_dir is not ported yet (ROADMAP.md "
                                  "queue 1, 'Utilities')")
    tp = trunc_params if isinstance(trunc_params, TruncParams) \
        else TruncParams.from_dict(trunc_params)
    cap = min(tp.chi_max if tp.chi_max else chi_limit, chi_limit)
    chi = min(chi_start, cap)

    start = time.perf_counter()
    model = KickedIsingModel(chi=chi, **model_kwargs)
    # pin the fields of the first build: every ladder rebuild reuses them
    model_kwargs = dict(model_kwargs)
    model_kwargs["h_fields"] = model.h_fields
    model_kwargs.pop("disorder_seed", None)
    err_tol = _stage_err_tol(model.dtype, tp.svd_min, model.n_sites - 1)
    basis_idx = state_basis_indices(model.n_sites, state_type, rng=state_rng)
    psi = product_state(basis_idx, chi=chi, dtype=model.dtype,
                        device=model.device)
    psi0 = psi
    p_done, n_rerun = 0, 0
    escalations: list = []
    chunks: list = []

    while p_done < n_periods:
        n = min(chunk_periods, n_periods - p_done)
        if cap_svd_method and chi >= cap:
            tp_stage = tp._replace(svd_method=cap_svd_method)
        elif chi < cap and tp.svd_method in PROJECTED_SVD_METHODS:
            # below the cap escalation reads trunc_err, which projected
            # methods report at the noise floor
            tp_stage = tp._replace(svd_method="jacobi")
        else:
            tp_stage = tp
        psi_next, tr = evolve_floquet_scan(psi, model.gates, n, tp_stage,
                                           ref_state=psi0, frame=frame)
        tr = to_host(tr)
        exit_lam = psi_next.lam.cpu().numpy()
        errs = np.append(np.ravel(tr["trunc_err"]),
                         np.ravel(tr["trunc_err_boundary"]))
        saturated, ahead = _stage_decision(errs, exit_lam, chi, err_tol)
        if saturated and chi < cap:
            new_chi = _next_chi(chi, cap, growth)
            escalations.append({"period": p_done, "from": chi, "to": new_chi})
            n_rerun += n
            chi = new_chi
            model = KickedIsingModel(chi=chi, **model_kwargs)
            psi = pad_mps(psi, chi)
            psi0 = pad_mps(psi0, chi)
            continue                      # re-run this chunk at the new chi
        if ahead and chi < cap and p_done + n < n_periods:
            new_chi = _next_chi(chi, cap, growth)
            escalations.append({"period": p_done + n, "from": chi,
                                "to": new_chi, "ahead": True})
            chi = new_chi
            model = KickedIsingModel(chi=chi, **model_kwargs)
            psi_next = pad_mps(psi_next, chi)
            psi0 = pad_mps(psi0, chi)
        psi = psi_next
        chunks.append(tr)
        p_done += n

    wall_time = time.perf_counter() - start
    init = to_host(_initial_observables(product_state(
        basis_idx, chi=chi, dtype=model.dtype, device=model.device)))
    if chunks:
        tr_all = {k: np.concatenate([c[k] for c in chunks], axis=0)
                  for k in TRACE_KEYS}
    else:
        tr_all = {k: np.zeros((0,) + np.asarray(init[k]).shape,
                              dtype=np.asarray(init[k]).dtype)
                  for k in TRACE_KEYS}
    sel = np.arange(0, n_periods, measure_every)
    traces = {k: np.concatenate([np.asarray(init[k])[None], tr_all[k][sel]],
                                axis=0) for k in TRACE_KEYS}
    add_derived_magnetization(traces, model.n_sites)
    times = [0.0] + [(int(p) + 1) * 2 * model.tau for p in sel]
    bond_dims = [int(x) for x in traces["max_chi"]]
    info = {
        "wall_time": wall_time,
        "bond_dimensions": bond_dims,
        "periods_per_second": (n_periods / wall_time if wall_time > 0
                               else float("inf")),
        "final_bond_dim": bond_dims[-1],
        "n_periods": n_periods,
        "truncation_errors": traces["trunc_err"].tolist(),
        "chi_pad_used": chi,
        "chi_escalations": escalations,
        "n_rerun_periods": n_rerun,
    }
    log.debug("evolve_floquet_auto: L=%d, %d periods, chi_pad %d (%d "
              "escalations), max_chi %d", model.n_sites, n_periods, chi,
              len(escalations), max(bond_dims), extra={"run_info": info})
    return traces, times, info, model

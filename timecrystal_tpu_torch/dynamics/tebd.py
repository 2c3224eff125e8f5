"""TEBD evolution: the Floquet period loop, the figure path, the
chi-staged evolution, the two-time correlator and the generic
Suzuki-Trotter TEBD.

Port of ``timecrystal_tpu/dynamics/tebd.py``.  JAX's
``lax.scan`` over periods becomes a Python loop; the observables of every
measurement stay on the device (stacked per chunk) and reach the host once
per chunk, not once per period.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core import gates as G
from ..core.mps import (MPS, HostStates, apply_sz, bond_dimensions,
                        entanglement_entropy, expectation_one_site,
                        max_bond_dimension, overlap)
from ..core.observables import (add_derived_magnetization, cross_sz_profile,
                                zz_correlation_profile)
from ..core.truncate import PROJECTED_SVD_METHODS, TruncParams, apply_bond_gates
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


def _trace_keys(correlation_site: int | None, two_time: bool = False) -> tuple:
    return (TRACE_KEYS + (() if correlation_site is None else ("zz_corr",))
            + (("zz2t_re", "zz2t_im") if two_time else ()))


def to_host(traces: dict) -> dict:
    """Device traces -> host numpy (one transfer per array)."""
    return {k: v.cpu().numpy() if torch.is_tensor(v) else v
            for k, v in traces.items()}


def _stack_traces(outs: list, empty, time_dim: int) -> dict:
    """Per-measurement dicts of device tensors -> one tensor per key, the
    measurements on axis ``time_dim``; ``empty()`` gives one measurement's
    shapes when there is none (zero periods)."""
    rows = outs or [empty()]
    return {k: torch.stack([o[k] for o in rows], time_dim).narrow(
        time_dim, 0, len(outs)) for k in rows[0]}


def _pair(psi: MPS, phi: MPS) -> MPS:
    """psi and phi on one new leading axis: one SVD call serves both."""
    return MPS(B=torch.stack([psi.B, phi.B]), lam=torch.stack([psi.lam, phi.lam]))


def _part(pair: MPS, i: int) -> MPS:
    return MPS(B=pair.B[i], lam=pair.lam[i])


def _measure_every(n_periods: int, measure_every: int) -> int:
    m = int(measure_every)
    if m < 1 or n_periods % m != 0:
        raise ValueError(f"measure_every={m} must divide n_periods={n_periods}")
    return m


def evolve_floquet_scan(psi0: MPS, gates: FloquetGates, n_periods: int,
                        tp: TruncParams, with_states: bool = False,
                        frame: str = "strict", ref_state: MPS | None = None,
                        measure_every: int = 1, measure_phase: int = -1,
                        correlation_site: int | None = None,
                        two_time_anchor: int | None = None):
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

    ``with_states=True`` (strict frame only) adds ``states``: the MPS of
    every measurement as one host MPS with the measurements on a leading
    axis, moved off the card in chunks (``core.mps.HostStates``).

    ``two_time_anchor=i`` (the batched ensemble's option) also evolves
    sigma^z_i psi0 beside psi0, the pair on one leading axis, and adds
    ``zz2t_re`` / ``zz2t_im`` [..., n_meas, L], the two-time correlator
    <sz_i(0) sz_j(t)> (``core.observables.cross_sz_profile``); every other
    trace, trunc_err included, is psi's.
    """
    sz_op = G.pauli_c("z", psi0.dtype, psi0.device)
    if ref_state is None:
        ref_state = psi0
    m = _measure_every(n_periods, measure_every)
    n_meas = n_periods // m
    phase = (m - 1) if measure_phase < 0 else int(measure_phase)
    if not 0 <= phase < m:
        raise ValueError(f"measure_phase={measure_phase} outside block of {m}")
    time_dim = len(psi0.lead)
    two_time = two_time_anchor is not None
    start = _pair(psi0, apply_sz(psi0, two_time_anchor)) if two_time else psi0

    if frame == "merged":
        if with_states:
            raise ValueError("frame='merged' cannot return state history")
        step = floquet_period_merged
        ref, _ = ising_half_step(ref_state, gates, tp)
        s, e0 = ising_half_step(start, gates, tp)
        if two_time:
            e0 = e0[0]
    elif frame == "strict":
        step = floquet_period
        ref, s, e0 = ref_state, start, None
    else:
        raise ValueError(f"unknown frame: {frame}")

    def measure(s, err):
        psi = _part(s, 0) if two_time else s
        out = _measure(psi, ref, sz_op, err[0] if two_time else err,
                       correlation_site)
        if two_time:
            c = cross_sz_profile(_part(s, 1), psi)
            out["zz2t_re"], out["zz2t_im"] = c.real, c.imag
        return out

    history = HostStates() if with_states else None
    outs = []
    for _ in range(n_meas):
        for i in range(m):
            s, e = step(s, gates, tp)
            if i == phase:
                outs.append(measure(s, e))
                if history is not None:
                    history.append(_part(s, 0) if two_time else s)
    traces = _stack_traces(outs, lambda: measure(s, s.lam.new_zeros(
        s.lead)), time_dim)
    psi = _part(s, 0) if two_time else s
    if frame == "merged":
        psi, e_exit = ising_half_step_inverse(psi, gates, tp)
        # frame-change bookkeeping error, kept out of the per-period trace;
        # the chi-staged evolutions fold it into their saturation signal
        traces["trunc_err_boundary"] = e0 + e_exit
    else:
        traces["trunc_err_boundary"] = psi0.lam.new_zeros(psi0.lead)
    if history is not None:
        traces["states"] = history.stacked() if n_meas else MPS(
            B=psi0.B.new_zeros((0,) + psi0.B.shape).cpu(),
            lam=psi0.lam.new_zeros((0,) + psi0.lam.shape).cpu())
    return psi, traces


def evolve_two_time_zz(psi0: MPS, gates: FloquetGates, n_periods: int,
                       tp: TruncParams, anchor: int, frame: str = "strict",
                       measure_every: int = 1):
    """Two-time correlator traces C(r, t) = <sz_anchor(0) sz_j(t)>.

    Evolves |psi(t)> = U^t |psi0> and |phi(t)> = U^t sz_anchor |psi0> as
    one pair on a leading axis (one SVD call a layer serves both) and reads
    <phi(t)| sz_j |psi(t)> for every j (``core.observables.
    cross_sz_profile``).  In a time crystal the real part alternates at
    f_drive/2, so its ``dynamic_structure_factor`` peaks at (k = pi,
    f = f_drive/2).  ``frame='merged'`` is exact for this readout (the
    frame change is z-diagonal).

    Returns (psi_final, traces): zz2t_re / zz2t_im [..., n_meas, L],
    max_chi [..., n_meas] (psi's), trunc_err [..., n_meas] (psi's plus
    phi's, summed over the block's periods) and trunc_err_boundary [...].
    The t=0 row, the real equal-time profile zz_correlation_profile(psi0,
    anchor), is the caller's to prepend.
    """
    m = _measure_every(n_periods, measure_every)
    time_dim = len(psi0.lead)
    s = _pair(psi0, apply_sz(psi0, anchor))
    if frame == "merged":
        step = floquet_period_merged
        s, e_in = ising_half_step(s, gates, tp)
    elif frame == "strict":
        step = floquet_period
    else:
        raise ValueError(f"unknown frame: {frame}")

    def measure(s, err):
        psi = _part(s, 0)
        c = cross_sz_profile(_part(s, 1), psi)
        return dict(zz2t_re=c.real, zz2t_im=c.imag,
                    max_chi=max_bond_dimension(psi), trunc_err=err)

    outs = []
    for _ in range(n_periods // m):
        e_tot = psi0.lam.new_zeros(psi0.lead)
        for _ in range(m):
            s, e = step(s, gates, tp)
            e_tot = e_tot + e[0] + e[1]
        outs.append(measure(s, e_tot))
    traces = _stack_traces(outs, lambda: measure(
        s, psi0.lam.new_zeros(psi0.lead)), time_dim)
    psi = _part(s, 0)
    if frame == "merged":
        psi, e_exit = ising_half_step_inverse(psi, gates, tp)
        traces["trunc_err_boundary"] = e_in[0] + e_in[1] + e_exit
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

    def evolve_floquet(self, psi_initial: MPS, n_periods: int,
                       measure_every: int = 1) -> Tuple[List[MPS], List[float], Dict]:
        """The state history (states, times, info): psi_initial, then the
        state after periods 1, m+1, 2m+1, ... (m = ``measure_every``), each
        a host MPS (moved off the card in chunks).  When m divides
        n_periods only those states are taken; otherwise every period's is
        and the list is subsampled.  ``evolve_floquet_traces`` keeps no
        states."""
        start = time.perf_counter()
        m = int(measure_every)
        in_scan = m > 1 and n_periods % m == 0
        _, tr = evolve_floquet_scan(
            psi_initial, self.model.gates, n_periods, self.trunc_params,
            with_states=True, measure_every=m if in_scan else 1,
            measure_phase=0 if in_scan else -1)
        max_chi = tr["max_chi"].cpu().numpy()
        wall_time = time.perf_counter() - start

        stacked = tr["states"]
        states, times = [psi_initial], [0.0]
        bond_dims = [int(max_bond_dimension(psi_initial))]
        if in_scan:     # stored entry j == the state after period j*m + 1
            pairs = [(j, j * m) for j in range(n_periods // m)]
        else:
            pairs = [(p, p) for p in range(0, n_periods, m)]
        for j, p in pairs:
            states.append(MPS(B=stacked.B[j], lam=stacked.lam[j]))
            times.append((p + 1) * 2 * self.model.tau)
            bond_dims.append(int(max_chi[j]))
        info = {
            "wall_time": wall_time,
            "bond_dimensions": bond_dims,
            "periods_per_second": (n_periods / wall_time if wall_time > 0
                                   else float("inf")),
            "final_bond_dim": bond_dims[-1],
            "n_periods": n_periods,
        }
        return states, times, info


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

    ``checkpoint_dir``: after each kept chunk the traces so far
    (``auto_traces.npz``) and then the state (``auto_state.npz``, with the
    schedule, the realized fields and basis, and a fingerprint of the model
    arguments, seeded fields, state, truncation and ladder) are written
    there; a later call with the same arguments resumes after the last
    chunk on disk, to a shorter or longer ``n_periods``, with the fields
    and basis pinned from the checkpoint.  Another fingerprint raises.

    The JAX version floors the ladder at chi=16 on the TPU, because n < 32
    routes to the Gram/eigh SVD there; here every even n runs the Jacobi
    kernel, so there is no floor.
    """
    from ..core.mps import pad_mps, product_state, state_basis_indices
    from ..models.kicked_ising import KickedIsingModel

    tp = trunc_params if isinstance(trunc_params, TruncParams) \
        else TruncParams.from_dict(trunc_params)
    cap = min(tp.chi_max if tp.chi_max else chi_limit, chi_limit)
    chi = min(chi_start, cap)
    caller_kwargs = dict(model_kwargs)
    fields_deterministic = ("h_fields" in caller_kwargs
                            or caller_kwargs.get("disorder_seed") is not None)

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

    wall_prev = 0.0
    if checkpoint_dir is not None:
        from ..utils.checkpoint import (atomic_savez, fingerprint, load_state,
                                        save_state, state_exists)
        ck_state = os.path.join(checkpoint_dir, "auto_state")
        ck_traces = os.path.join(checkpoint_dir, "auto_traces.npz")
        # seedless fields differ per process by construction and are pinned
        # from the checkpoint; the device may change between run and resume
        fp = fingerprint(
            sorted((k, repr(v)) for k, v in caller_kwargs.items()
                   if k not in ("h_fields", "disorder_seed", "device")),
            (np.round(np.asarray(model.h_fields), 12).tolist()
             if fields_deterministic else None),
            state_type, tp, chi_start, chi_limit, measure_every, chunk_periods,
            frame, growth, cap_svd_method)
        if state_exists(ck_state) and os.path.exists(ck_traces):
            psi, meta = load_state(ck_state, device=model.device,
                                   dtype=model.dtype)
            if meta.get("fingerprint") != fp:
                raise ValueError(
                    f"checkpoint at {checkpoint_dir} was written by a run "
                    "with different parameters (model/state/trunc/ladder); "
                    "refusing to resume -- delete it or point elsewhere")
            p_done, chi = int(meta["p_done"]), int(meta["chi"])
            escalations = list(meta["escalations"])
            n_rerun = int(meta["n_rerun"])
            wall_prev = float(meta["wall_time"])
            model_kwargs["h_fields"] = np.asarray(meta["h_fields"])
            basis_idx = np.asarray(meta["basis_idx"], np.int32)
            model = KickedIsingModel(chi=chi, **model_kwargs)
            psi0 = product_state(basis_idx, chi=chi, dtype=model.dtype,
                                 device=model.device)
            with np.load(ck_traces) as z:
                # the traces are written before the state: at most one
                # chunk ahead of it, never behind
                chunks = [{k: z[f"{k}__{i}"] for k in TRACE_KEYS}
                          for i in range(int(meta["n_chunks"]))]

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
        if checkpoint_dir is not None:
            atomic_savez(ck_traces, **{f"{k}__{i}": c[k]
                                       for i, c in enumerate(chunks)
                                       for k in TRACE_KEYS})
            save_state(ck_state, psi, {
                "p_done": p_done, "chi": chi, "escalations": escalations,
                "n_chunks": len(chunks), "n_rerun": n_rerun,
                "wall_time": wall_prev + time.perf_counter() - start,
                "fingerprint": fp,
                "h_fields": np.asarray(model.h_fields).tolist(),
                "basis_idx": np.asarray(basis_idx).tolist()})

    wall_time = wall_prev + time.perf_counter() - start
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


# ---------------------------------------------------------------------------
# Generic nearest-neighbour Suzuki-Trotter TEBD
# ---------------------------------------------------------------------------

class NearestNeighborModel:
    """A chain Hamiltonian H = sum_b H_b, H_b on sites (b, b+1): the dense
    bond Hamiltonians [L-1, d*d, d*d] (host numpy, onsite terms absorbed
    into the bonds)."""

    def __init__(self, bond_H: np.ndarray, d: int = 2):
        self.bond_H = np.asarray(bond_H)
        self.d = d
        self.L = self.bond_H.shape[0] + 1

    def trotter_gates(self, dt: float, dtype=torch.complex64, imag: bool = False,
                      device="cuda") -> torch.Tensor:
        """exp(-i dt H_b) of every bond, [L-1, d, d, d, d] on ``device``
        (scipy expm on the host in complex128, then cast); ``imag=True``
        gives the imaginary-time gates exp(-dt H_b) of
        ``dynamics.ground_state``."""
        t = -1j * dt if imag else dt
        g = np.stack([G.expm_two_site(H, t) for H in self.bond_H])
        d = self.d
        return G.gate_from_numpy(g.reshape(-1, d, d, d, d), dtype=dtype,
                                 device=device)

    def bond_terms(self, dtype=torch.complex64, device="cuda") -> torch.Tensor:
        """The bond Hamiltonians as [L-1, d, d, d, d] in the gate index
        convention (``core.observables.bond_energies``)."""
        d = self.d
        return G.gate_from_numpy(self.bond_H.reshape(-1, d, d, d, d),
                                 dtype=dtype, device=device)


def spin_chain_model(L: int, Jx=0.0, Jy=0.0, Jz=1.0, hx=0.0, hz=0.0,
                     hz_fields: np.ndarray | None = None) -> NearestNeighborModel:
    """Spin-1/2 chain H = sum Jx SxSx + Jy SySy + Jz SzSz + hx Sx + hz Sz,
    S = sigma/2.  Onsite terms are split half and half onto the adjacent
    bonds; an edge site puts its whole term on its one bond."""
    Sx, Sy, Sz = G.SIGMA_X / 2, G.SIGMA_Y / 2, G.SIGMA_Z / 2
    eye = np.eye(2, dtype=complex)
    hzv = (np.full(L, hz, dtype=float) if hz_fields is None
           else np.asarray(hz_fields))
    bonds = []
    for b in range(L - 1):
        H = Jx * np.kron(Sx, Sx) + Jy * np.kron(Sy, Sy) + Jz * np.kron(Sz, Sz)
        wl = 1.0 if b == 0 else 0.5
        wr = 1.0 if b == L - 2 else 0.5
        H += wl * (hx * np.kron(Sx, eye) + hzv[b] * np.kron(Sz, eye))
        H += wr * (hx * np.kron(eye, Sx) + hzv[b + 1] * np.kron(eye, Sz))
        bonds.append(H)
    return NearestNeighborModel(np.stack(bonds))


def trotter2_scan(psi0: MPS, gates_half: torch.Tensor, gates_full: torch.Tensor,
                  n_steps: int, tp: TruncParams):
    """Second-order Suzuki-Trotter steps, even(dt/2) odd(dt) even(dt/2),
    with the entropies, max_chi and truncation error of every step kept on
    the device (no host read per step).  Returns (psi, traces) with
    entropies [..., n_steps, L+1], max_chi and trunc_err [..., n_steps]."""
    psi, outs = psi0, []

    def measure(psi, err):
        return dict(entropies=entanglement_entropy(psi),
                    max_chi=max_bond_dimension(psi), trunc_err=err)

    for _ in range(n_steps):
        psi, e1 = apply_bond_gates(psi, gates_half, 0, tp)
        psi, e2 = apply_bond_gates(psi, gates_full, 1, tp)
        psi, e3 = apply_bond_gates(psi, gates_half, 0, tp)
        outs.append(measure(psi, e1 + e2 + e3))
    return psi, _stack_traces(outs, lambda: measure(
        psi, psi.lam.new_zeros(psi.lead)), len(psi0.lead))


class TEBDEvolution:
    """Order-2 Trotter TEBD of a ``NearestNeighborModel``; a
    ``KickedIsingModel`` serves ``evolve_floquet_period``."""

    def __init__(self, model, dt: float = 0.1, max_chi: int = 100,
                 trunc_params: dict | TruncParams | None = None):
        self.model = model
        self.dt = dt
        self.max_chi = max_chi
        if isinstance(trunc_params, TruncParams):
            self.trunc_params = trunc_params
        elif trunc_params is None:
            self.trunc_params = TruncParams(chi_max=max_chi, svd_min=1e-12,
                                            trunc_cut=1e-10)
        else:
            d = dict(trunc_params)
            d.setdefault("chi_max", max_chi)
            self.trunc_params = TruncParams.from_dict(d)

    def _gates(self, psi: MPS):
        return (self.model.trotter_gates(self.dt / 2, dtype=psi.dtype,
                                         device=psi.device),
                self.model.trotter_gates(self.dt, dtype=psi.dtype,
                                         device=psi.device))

    def evolve(self, psi_initial: MPS, total_time: float,
               observe_every: int = 1) -> Tuple[List[MPS], List[float], Dict]:
        """(states, times, info): psi_initial, then the state after every
        ``observe_every``-th step as host MPS (moved off the card in
        chunks); info has wall_time, bond_dimensions and
        entanglement_entropies per stored state, truncation_errors (the
        sum over steps), final_bond_dim and n_steps."""
        n_steps = int(total_time / self.dt)
        gates_half, gates_full = self._gates(psi_initial)
        start = time.perf_counter()
        history = HostStates()
        times = [0.0]
        dims = [bond_dimensions(psi_initial)]
        ents = [entanglement_entropy(psi_initial)]
        errs = []
        psi = psi_initial
        for step in range(n_steps):
            psi, tr = trotter2_scan(psi, gates_half, gates_full, 1,
                                    self.trunc_params)
            if step % observe_every == 0:
                history.append(psi)
                times.append((step + 1) * self.dt)
                dims.append(bond_dimensions(psi))
                ents.append(tr["entropies"][..., 0, :])
            errs.append(tr["trunc_err"][..., 0])
        states = [psi_initial] + history.states()
        dims = torch.stack(dims).cpu().numpy()
        ents = torch.stack(ents).cpu().numpy()
        trunc = float(torch.stack(errs).sum()) if errs else 0.0
        wall_time = time.perf_counter() - start
        info = {
            "wall_time": wall_time,
            "bond_dimensions": list(dims),
            "entanglement_entropies": list(ents),
            "truncation_errors": trunc,
            "final_bond_dim": int(bond_dimensions(psi).max()),
            "n_steps": n_steps,
        }
        return states, times, info

    def evolve_traces(self, psi_initial: MPS, total_time: float) -> Tuple[Dict, Dict]:
        """All steps with traces only: (host traces of ``trotter2_scan``,
        info with wall_time, n_steps, steps_per_second)."""
        n_steps = int(total_time / self.dt)
        gates_half, gates_full = self._gates(psi_initial)
        start = time.perf_counter()
        _, tr = trotter2_scan(psi_initial, gates_half, gates_full, n_steps,
                              self.trunc_params)
        tr = to_host(tr)          # waits for the device
        wall_time = time.perf_counter() - start
        info = {"wall_time": wall_time, "n_steps": n_steps,
                "steps_per_second": (n_steps / wall_time if wall_time > 0
                                     else float("inf"))}
        return tr, info

    def real_time_evolution(self, psi_initial: MPS, hamiltonian,
                            total_time: float, observe_every: int = 1):
        """``evolve`` (the reference's signature; ``hamiltonian`` unused)."""
        return self.evolve(psi_initial, total_time, observe_every)

    def suzuki_trotter_gates(self, hamiltonian_terms: Dict,
                             dt: float) -> List[np.ndarray]:
        """exp(-i dt H_term) of every dense term but 'single_site_terms'
        (host numpy)."""
        return [G.expm_two_site(np.asarray(op), dt)
                for name, op in hamiltonian_terms.items()
                if name != "single_site_terms" and isinstance(op, np.ndarray)]

    def benchmark_performance(self, psi_initial: MPS, n_steps: int = 100) -> Dict:
        """wall_time, steps_per_second, final_bond_dim, memory_usage and the
        last step's truncation_error of ``evolve_traces``."""
        tr, info = self.evolve_traces(psi_initial, n_steps * self.dt)
        return {
            "wall_time": info["wall_time"],
            "steps_per_second": info["steps_per_second"],
            "final_bond_dim": int(tr["max_chi"][-1]),
            "memory_usage": float(np.sum(tr["max_chi"]) * 8 / 1024**2),
            "truncation_error": float(tr["trunc_err"][-1]),
        }

    def evolve_floquet_period(self, psi: MPS) -> MPS:
        """One Floquet period of the model (a ``KickedIsingModel``)."""
        return self.model.floquet_step(psi, self.trunc_params)

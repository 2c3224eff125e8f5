"""Imaginary-time TEBD ground-state preparation.

Port of ``timecrystal_tpu/dynamics/ground_state.py``.  The non-unitary
Trotter gates exp(-dt H_b) go through the same batched Hastings bond update
as real time (``core.truncate.apply_bond_gates``: the update needs only
theta and orthonormal SVD columns, whatever the gate), and
``TruncParams.renormalize`` restores the norm on every bond.  Each chunk of
steps keeps its energy trace on the device; the host reads it once per
chunk to test convergence, then walks a dt ladder (coarse steps burn off
excited weight, fine ones shrink the O(dt^2) Trotter bias).

Non-unitary gates degrade the B-form by O(dt) a sweep: the energy is the
Rayleigh quotient with exact environments (``bond_energies_exact``), which
stays right mid-ladder.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.mps import (MPS, create_initial_state, entanglement_entropy,
                        haar_product_state)
from ..core.observables import bond_energies_exact
from ..core.truncate import TruncParams, apply_bond_gates
from .tebd import NearestNeighborModel, _stack_traces


def imaginary_time_scan(psi0: MPS, gates_half: torch.Tensor,
                        gates_full: torch.Tensor, bond_H: torch.Tensor,
                        n_steps: int, tp: TruncParams):
    """``n_steps`` second-order imaginary-time sweeps, even(dt/2) odd(dt)
    even(dt/2), as ``tebd.trotter2_scan``, with the energy kept on the
    device.  Returns (psi, traces): energy [..., n_steps], entropies
    [..., n_steps, L+1], trunc_err [..., n_steps]."""
    psi, outs = psi0, []

    def measure(psi, err):
        return dict(energy=bond_energies_exact(psi, bond_H).sum(-1),
                    entropies=entanglement_entropy(psi), trunc_err=err)

    for _ in range(n_steps):
        psi, e1 = apply_bond_gates(psi, gates_half, 0, tp)
        psi, e2 = apply_bond_gates(psi, gates_full, 1, tp)
        psi, e3 = apply_bond_gates(psi, gates_half, 0, tp)
        outs.append(measure(psi, e1 + e2 + e3))
    return psi, _stack_traces(outs, lambda: measure(
        psi, psi.lam.new_zeros(psi.lead)), len(psi0.lead))


def find_ground_state(model: NearestNeighborModel, chi: int = 32,
                      psi0: MPS | None = None,
                      state_type: str = "haar_product",
                      seed: int = 0, dts=(0.1, 0.01, 1e-3),
                      chunk_steps: int = 20, max_chunks_per_dt: int = 200,
                      e_tol: float | None = None,
                      tp: TruncParams | None = None,
                      dtype=torch.complex64, device="cuda"):
    """Variational ground state by imaginary-time TEBD.

    The start is ``psi0`` or a ``state_type`` product state drawn from a
    numpy generator seeded with ``seed`` (default 'haar_product': a
    Haar-random unit vector per site, with weight in every symmetry sector;
    a sector-pure start such as 'neel' stays in its sector).  Each ``dts``
    leg runs chunks of ``chunk_steps`` until the energy moves less than
    ``e_tol * max(1, |E|)`` over a chunk, or ``max_chunks_per_dt`` chunks.
    ``e_tol`` defaults to 1e-10 in complex128 and 1e-6 in complex64 (the
    float32 energy jitters at ~1e-7 relative: a tighter tolerance never
    triggers); ``tp`` to no chi cap with svd_min at the dtype's noise
    floor (1e-14 / 1e-7) and renormalization on.

    Returns (psi, energy, info): energy is the last leg's fixed point (with
    its O(dt^2) Trotter bias); info has energy_trace, leg_energies,
    energy_extrapolated (Richardson from the last two legs when both
    converged and their dt differ), n_steps, wall_time, dts, converged
    (per leg) and the final entropies.
    """
    f64 = dtype == torch.complex128
    if e_tol is None:
        e_tol = 1e-10 if f64 else 1e-6
    if tp is None:
        tp = TruncParams(chi_max=0, svd_min=1e-14 if f64 else 1e-7)
    if psi0 is None:
        rng = np.random.default_rng(seed)
        if state_type == "haar_product":
            psi0 = haar_product_state(model.L, chi, d=model.d, dtype=dtype,
                                      device=device, rng=rng)
        else:
            psi0 = create_initial_state(model.L, state_type, chi=chi,
                                        d=model.d, dtype=dtype, device=device,
                                        rng=rng)
    bond_H = model.bond_terms(dtype=dtype, device=psi0.device)

    psi = psi0
    energy_trace: list = []
    leg_energies: list = []
    converged: list = []
    n_steps = 0
    t0 = time.perf_counter()
    last_tr = None
    for dt in dts:
        gates_half = model.trotter_gates(dt / 2, dtype=dtype, imag=True,
                                         device=psi0.device)
        gates_full = model.trotter_gates(dt, dtype=dtype, imag=True,
                                         device=psi0.device)
        prev_E = np.inf
        leg_converged = False
        for _ in range(max_chunks_per_dt):
            psi, tr = imaginary_time_scan(psi, gates_half, gates_full,
                                          bond_H, chunk_steps, tp)
            last_tr = tr
            e = tr["energy"].cpu().numpy()          # one host read a chunk
            energy_trace.append(e)
            n_steps += chunk_steps
            E = float(e[-1])
            if abs(E - prev_E) < e_tol * max(1.0, abs(E)):
                leg_converged = True
                break
            prev_E = E
        converged.append(leg_converged)
        leg_energies.append(float(energy_trace[-1][-1]))

    energy = float(energy_trace[-1][-1]) if energy_trace else float("nan")
    # Richardson dt -> 0 from the last two legs' fixed points:
    # E(dt) = E0 + c dt^2  =>  E0 = (E_fine - r^2 E_coarse) / (1 - r^2)
    energy_extrap = energy
    if len(leg_energies) >= 2 and all(converged[-2:]) and dts[-1] != dts[-2]:
        # equal final legs carry no dt contrast (1 - r^2 = 0)
        r = dts[-1] / dts[-2]
        energy_extrap = (leg_energies[-1] - r * r * leg_energies[-2]) \
            / (1.0 - r * r)
    info = {
        "energy_trace": (np.concatenate(energy_trace) if energy_trace
                         else np.zeros(0)),
        "leg_energies": leg_energies,
        "energy_extrapolated": energy_extrap,
        "n_steps": n_steps,
        "wall_time": time.perf_counter() - t0,
        "dts": tuple(dts),
        "converged": converged,
        "entropies": (last_tr["entropies"][-1].cpu().numpy()
                      if last_tr is not None else None),
    }
    return psi, energy, info

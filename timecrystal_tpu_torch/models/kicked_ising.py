"""Floquet kicked-Ising model.

Port of ``timecrystal_tpu/models/kicked_ising.py``.  One period is

    U_F = exp[-i tau/2 sum_j (J sz_j sz_{j+1} + h_j sz_j)]
        x exp[-i theta/2 sum_j sx_j]
        x exp[-i tau/2 sum_j (J sz_j sz_{j+1} + h_j sz_j)]

with the reference's quirks kept on purpose (MIGRATION.md): every bond gate
carries the full h_i and h_{i+1} (interior sites see 2 h_i per half-step),
even bonds are applied before odd ones, the exact pi-pulse is -i sigma_x,
and seeded disorder comes from numpy's legacy MT19937 stream.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import gates as G
from ..core.mps import MPS, apply_one_site_gates
from ..core.truncate import (TruncParams, apply_bond_gates,
                             apply_single_bond_gate, swap_gate)


def _tp_from(trunc_params: dict | TruncParams | None) -> TruncParams:
    """TruncParams from the reference-parity argument forms; a partial dict
    keeps the reference defaults (chi_max=100, trunc_cut=1e-10)."""
    if isinstance(trunc_params, TruncParams):
        return trunc_params
    if trunc_params is None:
        return TruncParams(chi_max=100, svd_min=1e-12, trunc_cut=1e-10)
    d = dict(trunc_params)
    d.setdefault("chi_max", 100)
    d.setdefault("trunc_cut", 1e-10)
    return TruncParams.from_dict(d)


@dataclass(frozen=True)
class FloquetGates:
    """Per-period gate set.  Leading axes of ``bond_gates`` and
    ``boundary_gate`` (if any) are ensemble axes."""

    bond_gates: torch.Tensor                    # [..., L-1, d, d, d, d]
    kick: torch.Tensor                          # [d, d] or [..., d, d]
    # periodic-BC boundary gate [..., d, d, d, d] for the SWAPPED layout
    # (left = site 0's field, right = site L-1's field); None when open
    boundary_gate: torch.Tensor | None = None

    def to(self, device) -> "FloquetGates":
        """The same gates on ``device``."""
        return FloquetGates(
            self.bond_gates.to(device), self.kick.to(device),
            None if self.boundary_gate is None else self.boundary_gate.to(device))


def make_floquet_gates(J, h_fields: torch.Tensor, tau, theta=np.pi,
                       dtype=torch.complex64, bc: str = "open") -> FloquetGates:
    """Analytic Floquet gates from the fields ``h_fields`` [..., L] (real
    tensor; its device is the gates' device).  ``tau`` and ``theta`` are
    floats or tensors over the leading axes (a tensor of kick angles gives
    one kick per realization, [..., d, d]: the drive-strength axis).
    Angles are computed in the fields' dtype, then cast to the real dtype
    of ``dtype``; the kick's in the real dtype of ``dtype``.  A float theta
    equal to pi is the exact -i sigma_x."""
    device = h_fields.device
    tau_half = (tau / 2.0 if not torch.is_tensor(tau)
                else tau.to(h_fields.dtype) / 2.0)
    angles = G.ising_bond_phase_angles(J, h_fields, tau_half)
    bond_gates = G.phases_to_bond_gates(angles, dtype=dtype)
    if not torch.is_tensor(theta) and float(theta) == float(np.pi):
        kick = G.pi_pulse_gate(dtype=dtype, device=device)
    else:
        kick = G.x_rotation_gate(theta, dtype=dtype, device=device)
    boundary = None
    if bc == "periodic":
        hb = torch.stack([h_fields[..., 0], h_fields[..., -1]], -1)
        b_angles = G.ising_bond_phase_angles(J, hb, tau_half)
        boundary = G.phases_to_bond_gates(b_angles, dtype=dtype)[..., 0, :, :, :, :]
    return FloquetGates(bond_gates=bond_gates, kick=kick,
                        boundary_gate=boundary)


def _apply_kick(psi: MPS, kick: torch.Tensor) -> MPS:
    """The kick on every site: ``kick`` [d, d] or [..., d, d] with the
    MPS's ensemble axes."""
    return apply_one_site_gates(psi, kick[..., None, :, :])


def floquet_period(psi: MPS, gates: FloquetGates, tp: TruncParams):
    """One full Floquet period: Ising half-step (even bonds, then odd), the
    kick on every site, the Ising half-step again; periodic chains add the
    boundary bond once per half-step.  Returns (psi, truncation error)."""
    psi, e1 = apply_bond_gates(psi, gates.bond_gates, 0, tp)
    psi, e2 = apply_bond_gates(psi, gates.bond_gates, 1, tp)
    eb1 = eb2 = 0.0
    if gates.boundary_gate is not None:
        psi, eb1 = apply_boundary_gate_periodic(psi, gates.boundary_gate, tp)
    psi = _apply_kick(psi, gates.kick)
    psi, e3 = apply_bond_gates(psi, gates.bond_gates, 0, tp)
    psi, e4 = apply_bond_gates(psi, gates.bond_gates, 1, tp)
    if gates.boundary_gate is not None:
        psi, eb2 = apply_boundary_gate_periodic(psi, gates.boundary_gate, tp)
    return psi, e1 + e2 + e3 + e4 + eb1 + eb2


def _square_diagonal_gates(g: torch.Tensor) -> torch.Tensor:
    """Elementwise square of the diagonal Ising bond gates: the half-step
    phases exp(-i tau/2 H_b) become the full step exp(-i tau H_b)."""
    return g * g


def ising_half_step(psi: MPS, gates: FloquetGates, tp: TruncParams):
    """H = exp(-i tau/2 sum_b H_b) alone (even bonds then odd, plus the
    boundary bond for periodic chains)."""
    psi, e1 = apply_bond_gates(psi, gates.bond_gates, 0, tp)
    psi, e2 = apply_bond_gates(psi, gates.bond_gates, 1, tp)
    err = e1 + e2
    if gates.boundary_gate is not None:
        psi, eb = apply_boundary_gate_periodic(psi, gates.boundary_gate, tp)
        err = err + eb
    return psi, err


def ising_half_step_inverse(psi: MPS, gates: FloquetGates, tp: TruncParams):
    """H^{-1} = H^dagger: the conjugated diagonal phase gates."""
    inv = gates.bond_gates.conj()
    psi, e1 = apply_bond_gates(psi, inv, 0, tp)
    psi, e2 = apply_bond_gates(psi, inv, 1, tp)
    err = e1 + e2
    if gates.boundary_gate is not None:
        psi, eb = apply_boundary_gate_periodic(psi, gates.boundary_gate.conj(), tp)
        err = err + eb
    return psi, err


def floquet_period_merged(phi: MPS, gates: FloquetGates, tp: TruncParams):
    """One Floquet period in the half-step frame phi = H psi: H^2 K, one
    Ising sweep per period instead of two.  sz, magnetizations and the
    Loschmidt echo are exact in this frame (H is z-diagonal); entropies and
    bond dimensions are those of the half-step-shifted state.  Valid only
    for diagonal bond gates."""
    full_bonds = _square_diagonal_gates(gates.bond_gates)
    phi = _apply_kick(phi, gates.kick)
    phi, e1 = apply_bond_gates(phi, full_bonds, 0, tp)
    phi, e2 = apply_bond_gates(phi, full_bonds, 1, tp)
    err = e1 + e2
    if gates.boundary_gate is not None:
        full_b = _square_diagonal_gates(gates.boundary_gate)
        phi, eb = apply_boundary_gate_periodic(phi, full_b, tp)
        err = err + eb
    return phi, err


def apply_boundary_gate_periodic(psi: MPS, boundary_gate: torch.Tensor,
                                 tp: TruncParams):
    """The (L-1, 0) bond of a periodic chain by a swap network: swap site 0
    to position L-2, apply the gate at the last bond, swap back.  Returns
    (psi, summed discarded weight)."""
    L = psi.L
    if L <= 2:
        return apply_single_bond_gate(psi, boundary_gate, 0, tp)
    sw = swap_gate(psi.d, psi.dtype, psi.device)
    disc = psi.lam.new_zeros(psi.lead)
    for b in range(0, L - 2):            # site 0 -> position L-2
        psi, e = apply_single_bond_gate(psi, sw, b, tp)
        disc = disc + e
    psi, e = apply_single_bond_gate(psi, boundary_gate, L - 2, tp)
    disc = disc + e
    for b in range(L - 3, -1, -1):       # swap back
        psi, e = apply_single_bond_gate(psi, sw, b, tp)
        disc = disc + e
    return psi, disc


def draw_disorder_reference(n_sites: int, h_disorder: float,
                            disorder_seed: int | None) -> np.ndarray:
    """Disorder fields with the reference's RNG, bit for bit (numpy legacy
    MT19937: np.random.seed(seed); np.random.uniform)."""
    if disorder_seed is not None:
        np.random.seed(disorder_seed)
    return np.random.uniform(-h_disorder, h_disorder, n_sites)


def draw_disorder_batch(generator: torch.Generator, n_realizations: int,
                        n_sites: int, h_disorder: float,
                        dtype=torch.float64) -> torch.Tensor:
    """Disorder batch [R, L] ~ U[-h, h] from an explicit torch.Generator
    (on the generator's device).  The JAX package draws this batch from
    ``jax.random``; the two streams differ, so parity runs pass the same
    fields to both packages explicitly."""
    u = torch.rand((n_realizations, n_sites), generator=generator,
                   dtype=dtype, device=generator.device)
    return (2.0 * u - 1.0) * h_disorder


class KickedIsingModel:
    """Floquet kicked-Ising model: parameters plus the precomputed gates."""

    def __init__(self, n_sites: int, J: float, h_disorder: float, tau: float,
                 bc: str = "open", disorder_seed: int | None = None,
                 h_fields: np.ndarray | None = None, theta: float = np.pi,
                 chi: int = 64, dtype=torch.complex64, device="cuda"):
        if bc not in ("open", "periodic"):
            raise ValueError(f"Unknown boundary condition: {bc}")
        self.n_sites = int(n_sites)
        self.J = float(J)
        self.h_disorder = float(h_disorder)
        self.tau = float(tau)
        self.bc = bc
        self.theta = float(theta)
        self.chi = int(chi)
        self.dtype = dtype
        self.device = torch.device(device)
        if h_fields is not None:
            self.h_fields = np.asarray(h_fields, dtype=np.float64)
        else:
            self.h_fields = draw_disorder_reference(n_sites, h_disorder,
                                                    disorder_seed)
        h = torch.as_tensor(self.h_fields, dtype=torch.float64,
                            device=self.device)
        self.gates = make_floquet_gates(self.J, h, self.tau, theta=self.theta,
                                        dtype=dtype, bc=bc)
        self.boundary_gate = self.gates.boundary_gate

    def floquet_step(self, psi: MPS,
                     trunc_params: dict | TruncParams | None = None) -> MPS:
        """One Floquet period (periodic chains include the boundary bond)."""
        psi_new, _ = floquet_period(psi, self.gates, _tp_from(trunc_params))
        return psi_new

    def evolve(self, psi_initial: MPS, n_steps: int,
               trunc_params: dict | TruncParams | None = None,
               fetch_every: int | None = None):
        """(states, times): psi_initial, then the state after every period
        as a host MPS.  States leave the card in chunks of ``fetch_every``
        (one stacked copy each; None keeps the pending states under 256
        MiB, ``core.mps.HostStates``), so a long history never piles up on
        the card; the chunk size changes nothing in the states.
        ``dynamics.tebd.CustomFloquet.evolve_floquet_traces`` keeps no
        states."""
        from ..core.mps import HostStates

        tp = _tp_from(trunc_params)
        history = HostStates(fetch_every)
        times = [0.0]
        psi = psi_initial
        for step in range(n_steps):
            psi, _ = floquet_period(psi, self.gates, tp)
            history.append(psi)
            times.append((step + 1) * 2 * self.tau)    # a period is 2 tau
        return [psi_initial] + history.states(), times

    def get_hamiltonian_terms(self) -> dict:
        """The model's terms for analysis (host numpy): J, h_fields, tau, the
        kick actually applied (-i sigma_x at theta = pi, else
        exp(-i theta/2 sigma_x)) and the half-step bond gates
        exp(-i tau/2 H_b), the boundary bond's last for periodic chains
        (L = 2 included: a two-site ring has two bonds)."""
        ising_gates = [
            G.expm_two_site(G.two_site_hamiltonian(
                self.J, self.h_fields[i], self.h_fields[i + 1]), self.tau / 2.0)
            for i in range(self.n_sites - 1)]
        if self.bc == "periodic":
            ising_gates.append(G.expm_two_site(G.two_site_hamiltonian(
                self.J, self.h_fields[-1], self.h_fields[0]), self.tau / 2.0))
        if abs(self.theta - np.pi) < 1e-15:
            pulse = np.asarray(-1j * G.SIGMA_X)
        else:
            th = float(self.theta)
            pulse = np.cos(th / 2) * np.eye(2) - 1j * np.sin(th / 2) * G.SIGMA_X
        return {"J": self.J, "h_fields": self.h_fields, "tau": self.tau,
                "pi_pulse": pulse, "ising_gates": ising_gates}

    def calculate_phase_diagram_point(self, psi_initial: MPS, n_steps: int = 200,
                                      trunc_params: dict | None = None) -> dict:
        """One phase-diagram point's observables by
        ``CustomFloquet.evolve_floquet_traces``.  Kept on purpose from the
        reference: the physical drive period 2 tau goes into
        ``subharmonic_response``, whose fftfreq has unit (per-sample)
        spacing, so for tau != 0.5 its 'fundamental' and 'subharmonic' bins
        are off the true ones (``analysis.detection`` bins A2T correctly)."""
        from ..core import observables as obs
        from ..dynamics.tebd import CustomFloquet

        traces, _, info = CustomFloquet(self, trunc_params).evolve_floquet_traces(
            psi_initial, n_steps)
        fund_amp, subharm_amp = obs.subharmonic_response(
            traces["magnetization"], 2 * self.tau)
        sz_final = traces["sz_sites"][-1]
        mag_a, mag_b = np.mean(sz_final[0::2]), np.mean(sz_final[1::2])
        return {
            "loschmidt_echo_final": float(traces["loschmidt_echo"][-1]),
            "subharmonic_amplitude": float(subharm_amp),
            "fundamental_amplitude": float(fund_amp),
            "order_parameter": float(abs(mag_a - mag_b)),
            "max_bond_dimension": int(info["final_bond_dim"]),
            "final_magnetization": float(traces["magnetization"][-1]),
        }

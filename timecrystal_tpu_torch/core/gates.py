"""Gate construction: Pauli algebra and analytic Floquet gates.

Port of ``timecrystal_tpu/core/gates.py``.  The Ising half-step bond gate is
a diagonal phase (J sz sz + h_i sz + h_j sz is diagonal in z), computed with
elementwise cos/sin; the pi-pulse is exactly -i sigma_x.  Gates are native
complex tensors.
"""

from __future__ import annotations

import numpy as np
import torch

SIGMA_X = np.array([[0, 1], [1, 0]], dtype=np.complex128)
SIGMA_Y = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
SIGMA_Z = np.array([[1, 0], [0, -1]], dtype=np.complex128)
SIGMA_I = np.eye(2, dtype=np.complex128)


def pauli_matrices() -> dict:
    """Pauli dict (host numpy complex128)."""
    return {"I": SIGMA_I.copy(), "X": SIGMA_X.copy(), "Y": SIGMA_Y.copy(),
            "Z": SIGMA_Z.copy()}


def gate_from_numpy(U, dtype=torch.complex64, device="cuda") -> torch.Tensor:
    """Dense complex operator (host numpy) -> complex tensor on ``device``
    (the MPO builders' entry; real and imaginary parts round separately,
    as the JAX package's real pairs do)."""
    return torch.as_tensor(np.asarray(U, dtype=np.complex128)).to(
        dtype=dtype, device=device)


def pauli_c(name: str, dtype=torch.complex64, device="cuda") -> torch.Tensor:
    """Pauli operator as a complex tensor on ``device``."""
    return torch.as_tensor(pauli_matrices()[name.upper()], dtype=dtype,
                           device=device)


def pi_pulse_gate(dtype=torch.complex64, device="cuda") -> torch.Tensor:
    """expm(-i pi/2 sigma_x) == -i sigma_x exactly."""
    return torch.as_tensor(-1j * SIGMA_X, dtype=dtype, device=device)


def x_rotation_gate(theta, dtype=torch.complex64, device="cuda") -> torch.Tensor:
    """exp(-i theta/2 sigma_x), with cos/sin evaluated in the real dtype
    of ``dtype`` (as the JAX package does in its working dtype).  ``theta``
    a float ([2, 2]) or a tensor of angles ([..., 2, 2])."""
    th = torch.as_tensor(theta, dtype=dtype.to_real(), device=device)
    c, s = torch.cos(th / 2)[..., None, None], torch.sin(th / 2)[..., None, None]
    eye = torch.eye(2, dtype=dtype, device=device)
    sx = torch.as_tensor(SIGMA_X, dtype=dtype, device=device)
    return c * eye - 1j * s * sx


def ising_bond_phase_angles(J, h_fields: torch.Tensor, tau_half) -> torch.Tensor:
    """Phase angles -tau_half * E of the per-bond Ising half-step gates.

    ``h_fields`` [..., L] real (leading axes: ensemble), ``tau_half`` a
    float or a tensor broadcastable to the leading axes.  Every bond gate
    carries the FULL h_b and h_{b+1} (the reference's interior-field
    double counting, kept on purpose).  Returns [..., L-1, 4] over the
    basis order (s_b, s_{b+1}) = (+,+), (+,-), (-,+), (-,-).
    """
    h = h_fields
    hl, hr = h[..., :-1], h[..., 1:]
    s = torch.tensor([1.0, -1.0], dtype=h.dtype, device=h.device)
    s1 = s.repeat_interleave(2)                 # [+ + - -]
    s2 = s.repeat(2)                            # [+ - + -]
    E = J * s1 * s2 + hl[..., None] * s1 + hr[..., None] * s2
    tau_half = torch.as_tensor(tau_half, dtype=h.dtype, device=h.device)
    if tau_half.dim():
        tau_half = tau_half[..., None, None]
    return -tau_half * E


def phases_to_bond_gates(angles: torch.Tensor, dtype=torch.complex64) -> torch.Tensor:
    """Diagonal phase angles [..., n, d*d] -> dense gates [..., n, d, d, d, d]
    (convention gates[b, p_out, q_out, p_in, q_in]).  The angles are cast
    to the real dtype of ``dtype`` before cos/sin."""
    dd = angles.shape[-1]
    d = int(round(np.sqrt(dd)))
    a = angles.to(dtype.to_real())
    ph = torch.complex(torch.cos(a), torch.sin(a))
    g = torch.diag_embed(ph)                    # [..., n, dd, dd]
    return g.reshape(*angles.shape[:-1], d, d, d, d)


def two_site_hamiltonian(J, h_left, h_right) -> np.ndarray:
    """Dense 4x4 bond Hamiltonian J ZZ + h_l Z x I + h_r I x Z (host numpy
    complex128; analysis and parity checks)."""
    return (J * np.kron(SIGMA_Z, SIGMA_Z)
            + h_left * np.kron(SIGMA_Z, SIGMA_I)
            + h_right * np.kron(SIGMA_I, SIGMA_Z))


def expm_two_site(H: np.ndarray, t) -> np.ndarray:
    """expm(-i t H) on the host (scipy, complex128): the generic bond gates
    of the Suzuki-Trotter TEBD (``t`` complex for imaginary time)."""
    import scipy.linalg

    return scipy.linalg.expm(-1j * t * np.asarray(H, dtype=np.complex128))


def create_time_evolution_gates(J: float, h: float, tau: float,
                                n_sites: int) -> dict:
    """The reference's gate-set helper with its intended semantics: a true
    matrix exponential of the two-site Hamiltonian (the reference
    exponentiates elementwise) and the exact pi-pulse.  Host numpy."""
    H = two_site_hamiltonian(J, h, h)
    return {"ising_evolution": expm_two_site(H, tau),
            "pi_pulse": np.asarray(-1j * SIGMA_X)}

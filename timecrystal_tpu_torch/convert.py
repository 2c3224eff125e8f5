"""Carry state between the JAX package and the port.

The JAX package stores complex tensors as (re, im) real pairs
(``MPS.B.re/.im``, ``MPS.lam``, ``FloquetGates.bond_gates/.kick/
.boundary_gate``, ``MPO.W.re/.im``); the port stores native complex tensors.  These
functions take and return numpy arrays only -- the caller does the
``np.asarray`` on the JAX side -- so this module never imports JAX.
Superket MPS (local dimension 4, ``dynamics.open_system``) go through the
MPS functions unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.mps import MPS
from .dynamics.tdvp import MPO
from .models.kicked_ising import FloquetGates


def complex_from_pair(re, im, device="cuda", dtype=None) -> torch.Tensor:
    """(re, im) numpy pair -> complex tensor (complex128 for float64 input,
    complex64 otherwise, unless ``dtype`` is given)."""
    re, im = np.asarray(re), np.asarray(im)
    if dtype is None:
        dtype = torch.complex128 if re.dtype == np.float64 else torch.complex64
    return torch.as_tensor(re + 1j * im, dtype=dtype, device=device)


def complex_to_pair(x: torch.Tensor):
    """Complex tensor -> (re, im) numpy pair on the host."""
    x = x.detach().cpu().resolve_conj().numpy()
    return np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)


def mps_from_numpy(B_re, B_im, lam, device="cuda", dtype=None) -> MPS:
    """The JAX package's MPS arrays (B.re, B.im, lam) -> port MPS."""
    B = complex_from_pair(B_re, B_im, device, dtype)
    return MPS(B=B, lam=torch.tensor(np.asarray(lam), dtype=B.dtype.to_real(),
                                     device=device))


def mps_to_numpy(psi: MPS):
    """Port MPS -> (B_re, B_im, lam) numpy arrays in the JAX package's
    layout (rebuild there with ``MPS(B=C(B_re, B_im), lam=lam)``)."""
    B_re, B_im = complex_to_pair(psi.B)
    return B_re, B_im, psi.lam.detach().cpu().numpy()


def gates_from_numpy(bond_re, bond_im, kick_re, kick_im, boundary_re=None,
                     boundary_im=None, device="cuda", dtype=None) -> FloquetGates:
    """The JAX package's FloquetGates arrays -> port FloquetGates."""
    boundary = (None if boundary_re is None else
                complex_from_pair(boundary_re, boundary_im, device, dtype))
    return FloquetGates(
        bond_gates=complex_from_pair(bond_re, bond_im, device, dtype),
        kick=complex_from_pair(kick_re, kick_im, device, dtype),
        boundary_gate=boundary)


def gates_to_numpy(gates: FloquetGates) -> dict:
    """Port FloquetGates -> dict of numpy (re, im) arrays keyed like the
    arguments of ``gates_from_numpy``."""
    out = {}
    out["bond_re"], out["bond_im"] = complex_to_pair(gates.bond_gates)
    out["kick_re"], out["kick_im"] = complex_to_pair(gates.kick)
    if gates.boundary_gate is not None:
        out["boundary_re"], out["boundary_im"] = complex_to_pair(
            gates.boundary_gate)
    return out


def mpo_from_numpy(W_re, W_im, device="cuda", dtype=None) -> MPO:
    """The JAX package's MPO arrays (W.re, W.im) [L, Dw, Dw, d, d] -> port
    MPO."""
    return MPO(W=complex_from_pair(W_re, W_im, device, dtype))


def mpo_to_numpy(mpo: MPO):
    """Port MPO -> (W_re, W_im) numpy pair (rebuild there with
    ``MPO(W=C(W_re, W_im))``)."""
    return complex_to_pair(mpo.W)


def noise_from_numpy(normals, device="cuda", dtype=torch.float64) -> torch.Tensor:
    """The JAX package's dephasing draws -> the port's ``noise`` input of
    ``dynamics.open_system._evolve_stochastic_scan``.  ``normals``
    [..., n_periods, L]: per trajectory, the unit normals the JAX scan
    draws once a period (``key, sub = split(key)``, then ``normal(sub,
    (L,))``), replayed by the caller on its side."""
    return torch.as_tensor(np.asarray(normals)).to(dtype=dtype, device=device)

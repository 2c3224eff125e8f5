"""TDVP time evolution (single-site and two-site) with Lanczos.

Port of ``timecrystal_tpu/dynamics/tdvp.py``: ``TDVPEvolution`` with
tdvp_type in {'single_site', 'two_site'}, trunc_params {chi_max, svd_min,
trunc_cut}, lanczos_params {N_max, E_tol, N_min}; ``TDVPFloquetEvolution``
with the three-step Floquet split and ``benchmark_vs_tebd``.

  * The Hamiltonian is an MPO of fixed bond dimension, a complex
    W [L, Dw, Dw, d, d] on the device.
  * Lanczos runs at a static Krylov dimension (lanczos_params['N_max']);
    breakdown is masked with ``torch.where``, so no step reads a device
    value on the host.  exp(-i dt T) of the small tridiagonal T goes
    through ``torch.linalg.eigh``, a plain op in the JAX package too.
  * Each ``lax.scan`` over sites is a Python loop over sites; the
    back-evolution that JAX always computes and then drops on the boundary
    site by a where-select is skipped by a static ``if`` (same result).
  * The two-site split is ``csvd(method=tp.svd_method)``: on a CUDA tensor
    'auto' is the V-accumulating Jacobi kernel (``ops/jacobi_svd.jacobi_svd``).
    Single-site splits use ``cqr_tall`` / ``heigh`` (``torch.linalg.eigh``).

The per-bond Schmidt values land in lam during the right-to-left sweep, so
the returned MPS is in the diagonal-gauge (B, lam) form the rest of the port
assumes.  TDVP evolves one chain: an MPS with ensemble axes is refused.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core import gates as G
from ..core.mps import (MPS, apply_one_site_gates, create_initial_state,
                        entanglement_entropy, max_bond_dimension, overlap)
from ..core.truncate import TruncParams, truncation_mask
from ..models.kicked_ising import KickedIsingModel
from ..ops.csvd import cqr_tall, csvd, heigh
from .tebd import CustomFloquet


@dataclass(frozen=True)
class MPO:
    """Matrix product operator: complex W [L, Dw, Dw, d, d] (wl, wr, p_out,
    p_in).  The left edge selects row Dw-1 ("not yet started"), the right
    edge column 0 ("finished"): the lower-triangular W-matrix layout."""

    W: torch.Tensor

    @property
    def L(self) -> int:
        return self.W.shape[0]

    @property
    def Dw(self) -> int:
        return self.W.shape[1]

    def to(self, device) -> "MPO":
        return MPO(W=self.W.to(device))


def build_mpo(L: int, couplings: List[Tuple[float, np.ndarray, np.ndarray]],
              onsite, d: int = 2, dtype=torch.complex64,
              device="cuda") -> MPO:
    """Lower-triangular MPO for H = sum_b sum_k J_k A_k(b) B_k(b+1) +
    sum_i D_i.  couplings: [(J_k, A_k, B_k)] with A on the left site;
    onsite: [d, d] or a per-site list (disordered fields)."""
    nc = len(couplings)
    Dw = nc + 2
    W = np.zeros((L, Dw, Dw, d, d), dtype=complex)
    eye = np.eye(d)
    if onsite is None:
        onsite = np.zeros((d, d))
    onsite_list = [np.asarray(onsite)] * L if np.ndim(onsite) == 2 else list(onsite)
    for i in range(L):
        W[i, 0, 0] = eye
        W[i, Dw - 1, Dw - 1] = eye
        W[i, Dw - 1, 0] = onsite_list[i]
        for k, (J, A, B) in enumerate(couplings):
            W[i, 1 + k, 0] = np.asarray(B)
            W[i, Dw - 1, 1 + k] = J * np.asarray(A)
    return MPO(W=G.gate_from_numpy(W, dtype=dtype, device=device))


def spin_chain_mpo(L: int, Jx=0.0, Jy=0.0, Jz=1.0, hx=0.0, hz=0.0,
                   hz_fields=None, dtype=torch.complex64, device="cuda") -> MPO:
    """TeNPy-SpinChain equivalent MPO (S = sigma/2)."""
    Sx, Sy, Sz = G.SIGMA_X / 2, G.SIGMA_Y / 2, G.SIGMA_Z / 2
    couplings = []
    if Jx:
        couplings.append((Jx, Sx, Sx))
    if Jy:
        couplings.append((Jy, Sy, Sy))
    if Jz:
        couplings.append((Jz, Sz, Sz))
    hzv = np.zeros(L) + (hz if hz_fields is None else np.asarray(hz_fields))
    onsite = [hx * Sx + hzv[i] * Sz for i in range(L)]
    return build_mpo(L, couplings, onsite, dtype=dtype, device=device)


def ising_fields_mpo(L: int, J: float, h_fields, dtype=torch.complex64,
                     device="cuda") -> MPO:
    """H = sum_b J sz sz + sum_i h_i sz (Pauli convention), the kicked-Ising
    Ising part, for Floquet-via-TDVP."""
    hf = np.asarray(h_fields)
    onsite = [hf[i] * G.SIGMA_Z for i in range(L)]
    return build_mpo(L, [(J, G.SIGMA_Z, G.SIGMA_Z)], onsite, dtype=dtype,
                     device=device)


# ---------------------------------------------------------------------------
# Environments and effective Hamiltonians: Lenv[w, a_bra, a_ket],
# Renv[w, b_bra, b_ket]
# ---------------------------------------------------------------------------

def _edge(Dw: int, chi: int, row: int, dtype, device) -> torch.Tensor:
    E = torch.zeros((Dw, chi, chi), dtype=dtype, device=device)
    E[row] = torch.eye(chi, dtype=dtype, device=device)
    return E


def _left_edge(Dw: int, chi: int, dtype, device) -> torch.Tensor:
    return _edge(Dw, chi, Dw - 1, dtype, device)


def _right_edge(Dw: int, chi: int, dtype, device) -> torch.Tensor:
    return _edge(Dw, chi, 0, dtype, device)


def _update_left(Lenv, A, W):
    """Lenv'[w, bbra, bket] = sum Lenv[v, x, c] conj(A)[x, p, bbra]
    W[v, w, p, q] A[c, q, bket]."""
    T = torch.einsum("vxc,cqd->vxqd", Lenv, A)
    T = torch.einsum("vwpq,vxqd->wxpd", W, T)
    return torch.einsum("xpb,wxpd->wbd", A.conj(), T)


def _update_right(Renv, B, W):
    """Renv'[v, abra, aket] = sum Renv[w, x, d] conj(B)[abra, p, x]
    W[v, w, p, q] B[aket, q, d]."""
    T = torch.einsum("wxd,cqd->wxcq", Renv, B)
    T = torch.einsum("vwpq,wxcq->vxcp", W, T)
    return torch.einsum("apx,vxcp->vac", B.conj(), T)


def _h1_matvec(Lenv, W, Renv, v):
    """One-site effective Hamiltonian applied to v [aket, q, bket]."""
    T = torch.einsum("vxc,cqd->vxqd", Lenv, v)
    T = torch.einsum("vwpq,vxqd->wxpd", W, T)
    return torch.einsum("wbd,wxpd->xpb", Renv, T)


def _h0_matvec(Lenv, Renv, c):
    """Zero-site (bond) effective Hamiltonian applied to c [a, b]."""
    T = torch.einsum("wxc,cd->wxd", Lenv, c)
    return torch.einsum("wbd,wxd->xb", Renv, T)


def _h2_matvec(Lenv, Wl, Wr, Renv, v):
    """Two-site effective Hamiltonian applied to v [a, p, q, b]."""
    T = torch.einsum("uxa,asrb->uxsrb", Lenv, v)
    T = torch.einsum("uwps,uxsrb->wxprb", Wl, T)
    T = torch.einsum("wvqr,wxprb->vxpqb", Wr, T)
    return torch.einsum("vyb,vxpqb->xpqy", Renv, T)


# ---------------------------------------------------------------------------
# Lanczos exponential
# ---------------------------------------------------------------------------

def lanczos_expm_apply(matvec, v0: torch.Tensor, dt: float, m: int,
                       sign: float = -1.0) -> torch.Tensor:
    """exp(sign * i * dt * H) v0 in an m-step Lanczos Krylov space.

    Static m; breakdown (beta <= 1e-12) zeroes that beta and every later
    Krylov vector through ``torch.where`` (the tridiagonal then decouples,
    which is exact), so the loop never reads a device value.  Full
    reorthogonalization against the Krylov basis, as in the JAX package."""
    shape = v0.shape
    rdtype = v0.real.dtype
    nrm0 = torch.linalg.vector_norm(v0)
    v = (v0 * (1.0 / torch.clamp(nrm0, min=1e-30))).reshape(-1)
    Vs = torch.zeros((m, v.numel()), dtype=v0.dtype, device=v0.device)
    Vs[0] = v
    alphas, betas = [], []
    zero = torch.zeros((), dtype=rdtype, device=v0.device)
    v_prev = torch.zeros_like(v)
    beta_prev = zero
    alive = torch.ones((), dtype=torch.bool, device=v0.device)
    for j in range(m):
        vj = Vs[j]
        w = matvec(vj.reshape(shape)).reshape(-1)
        alpha = torch.vdot(vj, w).real
        alphas.append(torch.where(alive, alpha, zero))
        if j == m - 1:
            break
        w = w - vj * alpha - v_prev * beta_prev
        w = w - (Vs.conj() @ w) @ Vs
        beta = torch.linalg.vector_norm(w)
        ok = alive & (beta > 1e-12)
        betas.append(torch.where(ok, beta, zero))
        Vs[j + 1] = w * torch.where(ok, 1.0 / torch.clamp(beta, min=1e-30), zero)
        v_prev, beta_prev, alive = vj, beta, ok
    a = torch.stack(alphas)
    T = torch.diag(a)
    if m > 1:
        b = torch.stack(betas)
        T = T + torch.diag(b, 1) + torch.diag(b, -1)
    wT, UT = torch.linalg.eigh(T)
    phase = torch.polar(torch.ones_like(wT), sign * dt * wT)
    c = UT.to(v0.dtype) @ (phase * UT[0].to(v0.dtype))      # exp(..T) e1, [m]
    return (c @ Vs).reshape(shape) * nrm0


# ---------------------------------------------------------------------------
# Sweep integrators
# ---------------------------------------------------------------------------

def _split_right_diag(Cc: torch.Tensor, tol_rel: float = 1e-14):
    """Split the center C [a, q, b] = (V diag(s)) B with B right-isometric
    and the left factor diagonalized, so the bond's Schmidt values s land
    in the stored lam (diagonal gauge)."""
    chi, d, _ = Cc.shape
    M = Cc.reshape(chi, d * chi)
    w, V = heigh(M @ M.mH)                        # ascending
    w, V = w.flip(-1), V.flip(-1)
    s = torch.sqrt(torch.clamp(w, min=0.0))
    ok = s > tol_rel * (s[0] + 1e-300)
    zero = torch.zeros_like(s)
    inv = torch.where(ok, 1.0 / torch.clamp(s, min=1e-300), zero)
    B = (V.mH @ M) * (inv * ok)[:, None].to(Cc.dtype)
    Cbond = V * (s * ok)[None, :].to(Cc.dtype)
    return Cbond, torch.where(ok, s, zero), B.reshape(chi, d, chi)


def _right_envs(psi: MPS, W: torch.Tensor) -> list:
    """R_of[i] covers sites i..L-1, i = 0..L, with R_of[L] the edge."""
    R = _right_edge(W.shape[1], psi.chi, psi.dtype, psi.device)
    R_of = [R]
    for i in range(psi.L - 1, -1, -1):
        R = _update_right(R, psi.B[i], W[i])
        R_of.append(R)
    return R_of[::-1]


def _single_chain(psi: MPS, mpo: MPO) -> None:
    if psi.lead:
        raise ValueError(f"TDVP evolves one chain; got ensemble axes {psi.lead}")
    if mpo.W.device != psi.device:
        raise ValueError(f"MPO on {mpo.W.device}, MPS on {psi.device}")


def tdvp1_step(psi: MPS, mpo: MPO, dt: float, m: int) -> MPS:
    """One symmetric single-site TDVP step (L->R then R->L, dt/2 each)."""
    _single_chain(psi, mpo)
    L, chi, d = psi.L, psi.chi, psi.d
    W = mpo.W.to(psi.dtype)
    R_of = _right_envs(psi, W)
    L_edge = _left_edge(mpo.Dw, chi, psi.dtype, psi.device)
    R_edge = R_of[L]

    # left-to-right half sweep over sites 0..L-2
    Lenv = L_edge
    Cc = psi.B[0] * psi.lam[0][:, None, None].to(psi.dtype)
    A_stack, Lenvs = [], [L_edge]
    for i in range(L - 1):
        Cc = lanczos_expm_apply(
            lambda v: _h1_matvec(Lenv, W[i], R_of[i + 1], v),
            Cc, dt / 2, m, sign=-1.0)
        Q, Rb = cqr_tall(Cc.reshape(chi * d, chi))
        A_i = Q.reshape(chi, d, chi)
        Lenv = _update_left(Lenv, A_i, W[i])
        Rb = lanczos_expm_apply(
            lambda c: _h0_matvec(Lenv, R_of[i + 1], c),
            Rb, dt / 2, m, sign=+1.0)
        Cc = torch.einsum("ab,bqc->aqc", Rb, psi.B[i + 1])
        A_stack.append(A_i)
        Lenvs.append(Lenv)
    # last site: forward dt/2 only (the center stays for the return sweep)
    Cc = lanczos_expm_apply(
        lambda v: _h1_matvec(Lenv, W[L - 1], R_edge, v), Cc, dt / 2, m, sign=-1.0)

    # right-to-left half sweep over sites L-1..1
    Renv = R_edge
    B_new = [None] * L
    lam_new = psi.lam.clone()
    for i in range(L - 1, 0, -1):
        Cc = lanczos_expm_apply(
            lambda v: _h1_matvec(Lenvs[i], W[i], Renv, v),
            Cc, dt / 2, m, sign=-1.0)
        Cbond, s, B_i = _split_right_diag(Cc)
        Renv = _update_right(Renv, B_i, W[i])
        Cbond = lanczos_expm_apply(
            lambda c: _h0_matvec(Lenvs[i], Renv, c),
            Cbond, dt / 2, m, sign=+1.0)
        Cc = torch.einsum("apb,bc->apc", A_stack[i - 1], Cbond)
        B_new[i] = B_i
        lam_new[i] = s.to(lam_new.dtype)
    # site 0: final forward dt/2; the trivial left bond makes Cc the new B_0
    B_new[0] = lanczos_expm_apply(
        lambda v: _h1_matvec(L_edge, W[0], Renv, v), Cc, dt / 2, m, sign=-1.0)
    return MPS(B=torch.stack(B_new), lam=lam_new)


def tdvp2_step(psi: MPS, mpo: MPO, dt: float, m: int, tp: TruncParams):
    """One symmetric two-site TDVP step with SVD truncation.  Returns
    (psi, truncation error as a 0-d device tensor)."""
    _single_chain(psi, mpo)
    L, chi, d = psi.L, psi.chi, psi.d
    dtype = psi.dtype
    W = mpo.W.to(dtype)

    def split_theta(theta):
        U, S, Vh = csvd(theta.reshape(chi * d, d * chi), method=tp.svd_method)
        S_top = S[:chi]
        mask = truncation_mask(S_top, chi, tp)
        zero = torch.zeros_like(S_top)
        S_k = torch.where(mask, S_top, zero)
        disc = torch.where(mask, zero, S_top * S_top).sum() + (S[chi:] ** 2).sum()
        S_k = S_k / torch.clamp(torch.sqrt((S_k * S_k).sum()), min=1e-30)
        mf = mask.to(dtype)
        A = (U[:, :chi] * mf[None, :]).reshape(chi, d, chi)
        Br = (Vh[:chi, :] * mf[:, None]).reshape(chi, d, chi)
        return A, S_k, Br, disc

    R_of = _right_envs(psi, W)
    Lenv = _left_edge(mpo.Dw, chi, dtype, psi.device)
    Cc = psi.B[0] * psi.lam[0][:, None, None].to(dtype)
    A_stack, Lenvs = [], [Lenv]
    disc = torch.zeros((), dtype=psi.lam.dtype, device=psi.device)
    for i in range(L - 1):
        theta = torch.einsum("apb,bqc->apqc", Cc, psi.B[i + 1])
        theta = lanczos_expm_apply(
            lambda v: _h2_matvec(Lenv, W[i], W[i + 1], R_of[i + 2], v),
            theta, dt / 2, m, sign=-1.0)
        A, S_k, Br, e = split_theta(theta)
        Lenv = _update_left(Lenv, A, W[i])
        Cc = Br * S_k[:, None, None].to(dtype)
        if i < L - 2:
            # back-evolve the new center, except on the last bond
            Cc = lanczos_expm_apply(
                lambda v: _h1_matvec(Lenv, W[i + 1], R_of[i + 2], v),
                Cc, dt / 2, m, sign=+1.0)
        A_stack.append(A)
        Lenvs.append(Lenv)
        disc = disc + e

    Renv = R_of[L]
    B_new = [None] * L
    lam_new = psi.lam.clone()
    for i in range(L - 2, -1, -1):
        theta = torch.einsum("apm,mqb->apqb", A_stack[i], Cc)
        theta = lanczos_expm_apply(
            lambda v: _h2_matvec(Lenvs[i], W[i], W[i + 1], Renv, v),
            theta, dt / 2, m, sign=-1.0)
        A, S_k, Br, e = split_theta(theta)
        Renv = _update_right(Renv, Br, W[i + 1])
        Cc = A * S_k[None, None, :].to(dtype)
        if i > 0:
            Cc = lanczos_expm_apply(
                lambda v: _h1_matvec(Lenvs[i], W[i], Renv, v),
                Cc, dt / 2, m, sign=+1.0)
        B_new[i + 1] = Br
        lam_new[i + 1] = S_k.to(lam_new.dtype)
        disc = disc + e
    B_new[0] = Cc
    return MPS(B=torch.stack(B_new), lam=lam_new), disc


# ---------------------------------------------------------------------------
# API classes (the recovered reference surface)
# ---------------------------------------------------------------------------

DEFAULT_LANCZOS = {"N_max": 10, "E_tol": 1e-10, "N_min": 2}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _max_chi(psi: MPS) -> int:
    return int(max_bond_dimension(psi))


class TDVPEvolution:
    """TDVP evolution wrapper (single-site or two-site).

    ``tdvp_type`` in {'single_site', 'two_site'}, trunc_params {chi_max,
    svd_min, trunc_cut}, lanczos_params {N_max, E_tol, N_min} (N_max = the
    static Krylov dimension; E_tol / N_min are accepted for compatibility,
    as in the JAX package).  ``model``: an MPO or any object with ``mpo()``;
    it is moved to ``device``, where the states must live too."""

    def __init__(self, model, dt: float = 0.1, max_chi: int = 100,
                 tdvp_type: str = "two_site",
                 trunc_params: dict | TruncParams | None = None,
                 lanczos_params: dict | None = None, device="cuda"):
        if tdvp_type not in ("single_site", "two_site"):
            raise ValueError(f"Unknown tdvp_type: {tdvp_type}")
        self.model = model
        self.dt = float(dt)
        self.max_chi = int(max_chi)
        self.tdvp_type = tdvp_type
        self.device = torch.device(device)
        if isinstance(trunc_params, TruncParams):
            self.trunc_params = trunc_params
        else:
            d = dict(trunc_params or {})
            d.setdefault("chi_max", max_chi)
            d.setdefault("svd_min", 1e-12)
            self.trunc_params = TruncParams.from_dict(d)
        self.lanczos_params = {**DEFAULT_LANCZOS, **(lanczos_params or {})}

    @classmethod
    def from_spin_chain(cls, L: int, Jx=0.0, Jy=0.0, Jz=1.0, hx=0.0, hz=0.0,
                        dtype=torch.complex64, device="cuda", **kw):
        """The SpinChain-model variant of the reference's _create_tenpy_model
        (finite chain, S = sigma/2)."""
        return cls(spin_chain_mpo(L, Jx, Jy, Jz, hx, hz, dtype=dtype,
                                  device=device), device=device, **kw)

    def _mpo(self) -> MPO:
        if isinstance(self.model, MPO):
            mpo = self.model
        elif hasattr(self.model, "mpo"):
            mpo = self.model.mpo()
        else:
            raise TypeError("TDVPEvolution needs an MPO or an object with .mpo()")
        return mpo.to(self.device)

    def step(self, psi: MPS):
        """One dt step; returns (psi, trunc_err) with trunc_err on the device."""
        m = int(self.lanczos_params["N_max"])
        if self.tdvp_type == "single_site":
            return (tdvp1_step(psi, self._mpo(), self.dt, m),
                    psi.lam.new_zeros(()))
        return tdvp2_step(psi, self._mpo(), self.dt, m, self.trunc_params)

    def evolve(self, psi_initial: MPS, total_time: float,
               observe_every: int = 1) -> Tuple[List[MPS], List[float], Dict]:
        """(states, times, info); observed states are host copies, fetched
        once per observed step.  info: wall_time, bond_dimensions,
        entanglement_entropies, truncation_errors, algorithm,
        max_chi_reached, n_steps."""
        n_steps = int(round(total_time / self.dt))
        states, times = [psi_initial], [0.0]
        chis = [_max_chi(psi_initial)]
        ents = [entanglement_entropy(psi_initial).cpu().numpy()]
        terr = psi_initial.lam.new_zeros(())
        psi = psi_initial
        start = time.perf_counter()
        for k in range(n_steps):
            psi, err = self.step(psi)
            terr = terr + err          # on the device; fetched once below
            if k % observe_every == 0:
                host = MPS(B=psi.B.cpu(), lam=psi.lam.cpu())
                states.append(host)
                times.append((k + 1) * self.dt)
                chis.append(_max_chi(host))
                ents.append(entanglement_entropy(host).numpy())
        info = {
            "wall_time": time.perf_counter() - start,
            "bond_dimensions": chis,
            "entanglement_entropies": ents,
            "truncation_errors": float(terr),
            "algorithm": f"TDVP ({self.tdvp_type})",
            "max_chi_reached": max(chis),
            "n_steps": n_steps,
        }
        return states, times, info

    def real_time_evolution(self, psi_initial: MPS, hamiltonian,
                            total_time: float, observe_every: int = 1):
        """Evolve under a given MPO Hamiltonian (reference method name)."""
        saved, self.model = self.model, hamiltonian
        try:
            return self.evolve(psi_initial, total_time, observe_every)
        finally:
            self.model = saved

    def evolve_floquet_period(self, psi: MPS) -> MPS:
        """One Floquet period via the attached model's floquet_step when it
        has one, else one TDVP step of the MPO."""
        if hasattr(self.model, "floquet_step"):
            return self.model.floquet_step(psi, self.trunc_params)
        psi, _ = self.step(psi)
        return psi

    def benchmark_performance(self, system_sizes: List[int],
                              n_periods: int = 5) -> Dict:
        """Wall-time scan over system sizes (the reference surface): one
        untimed warm-up step, then n_periods steps of spin_chain_mpo(L,
        Jz=1, hx=0.3) from the Neel state."""
        results = {}
        for L in system_sizes:
            mpo = spin_chain_mpo(L, Jz=1.0, hx=0.3, device=self.device)
            psi = create_initial_state(L, "neel", chi=min(self.max_chi, 32),
                                       device=self.device)
            saved, self.model = self.model, mpo
            try:
                self.step(psi)
                _sync(self.device)
                t0 = time.perf_counter()
                for _ in range(n_periods):
                    psi, _ = self.step(psi)
                _sync(self.device)
                wall = time.perf_counter() - t0
                results[L] = {"wall_time": wall,
                              "periods_per_second": n_periods / wall}
            finally:
                self.model = saved
        return results


class TDVPFloquetEvolution:
    """Three-step Floquet evolution via TDVP: TDVP under the Ising
    Hamiltonian for tau/2, the exact kick, TDVP for tau/2 -- the integrator
    alternative to the gate-based CustomFloquet.  The Ising MPO carries the
    gate path's effective fields (interior h_i doubled: the reference's
    double counting), so both evolve the same Hamiltonian."""

    def __init__(self, kicked_ising_model, dt: float = 0.1, max_chi: int = 100,
                 tdvp_type: str = "two_site",
                 lanczos_params: dict | None = None, device="cuda"):
        self.model = kicked_ising_model
        self.dt = float(dt)
        self.max_chi = int(max_chi)
        self.tdvp_type = tdvp_type
        self.device = torch.device(device)
        self.lanczos_params = {**DEFAULT_LANCZOS, **(lanczos_params or {})}
        if getattr(kicked_ising_model, "bc", "open") == "periodic":
            raise NotImplementedError(
                "TDVPFloquetEvolution supports open chains only; "
                "bc='periodic' is routed by the gate-based CustomFloquet")
        h_eff = np.asarray(self.model.h_fields).copy()
        if h_eff.shape[0] > 2:
            h_eff[1:-1] *= 2.0
        self.mpo = ising_fields_mpo(self.model.n_sites, self.model.J, h_eff,
                                    dtype=self.model.dtype, device=self.device)
        self.kick = self.model.gates.kick.to(self.device)
        self.engine = TDVPEvolution(self.mpo, dt=dt, max_chi=max_chi,
                                    tdvp_type=tdvp_type,
                                    lanczos_params=self.lanczos_params,
                                    device=self.device)

    def _half_ising(self, psi: MPS) -> MPS:
        """TDVP integration of exp(-i tau/2 H_ising) in equal dt slices."""
        t_half = self.model.tau / 2.0
        n = max(1, int(round(t_half / self.dt)))
        saved_dt = self.engine.dt
        self.engine.dt = t_half / n
        try:
            for _ in range(n):
                psi, _ = self.engine.step(psi)
        finally:
            self.engine.dt = saved_dt
        return psi

    def evolve_floquet_period(self, psi: MPS) -> MPS:
        psi = self._half_ising(psi)
        psi = apply_one_site_gates(psi, self.kick)
        return self._half_ising(psi)

    def benchmark_vs_tebd(self, system_sizes: List[int],
                          n_periods: int = 3) -> Dict:
        """TEBD-vs-TDVP comparison (the reference surface): {tebd_times,
        tdvp_times, tebd_chi_max, tdvp_chi_max, speedup, error}, each keyed
        by L; one untimed period of each path first."""
        out = {"tebd_times": {}, "tdvp_times": {}, "tebd_chi_max": {},
               "tdvp_chi_max": {}, "speedup": {}, "error": {}}
        for L in system_sizes:
            m = KickedIsingModel(L, self.model.J, self.model.h_disorder,
                                 self.model.tau, disorder_seed=42,
                                 theta=self.model.theta, chi=self.max_chi,
                                 dtype=self.model.dtype, device=self.device)
            psi0 = create_initial_state(L, "neel", chi=self.max_chi,
                                        dtype=self.model.dtype,
                                        device=self.device)
            flo = CustomFloquet(m, TruncParams(chi_max=self.max_chi,
                                               svd_min=1e-10))
            flo.model.floquet_step(psi0, flo.trunc_params)
            _sync(self.device)
            t0 = time.perf_counter()
            psi_tebd = psi0
            for _ in range(n_periods):
                psi_tebd = flo.model.floquet_step(psi_tebd, flo.trunc_params)
            _sync(self.device)
            t_tebd = time.perf_counter() - t0

            tfe = TDVPFloquetEvolution(m, dt=self.dt, max_chi=self.max_chi,
                                       tdvp_type=self.tdvp_type,
                                       lanczos_params=self.lanczos_params,
                                       device=self.device)
            tfe.evolve_floquet_period(psi0)
            _sync(self.device)
            t0 = time.perf_counter()
            psi_tdvp = psi0
            for _ in range(n_periods):
                psi_tdvp = tfe.evolve_floquet_period(psi_tdvp)
            _sync(self.device)
            t_tdvp = time.perf_counter() - t0

            ov = complex(overlap(psi_tebd, psi_tdvp))
            out["tebd_times"][L] = t_tebd
            out["tdvp_times"][L] = t_tdvp
            out["tebd_chi_max"][L] = _max_chi(psi_tebd)
            out["tdvp_chi_max"][L] = _max_chi(psi_tdvp)
            out["speedup"][L] = t_tebd / t_tdvp if t_tdvp > 0 else float("inf")
            out["error"][L] = float(1.0 - min(1.0, abs(ov) ** 2))
        return out

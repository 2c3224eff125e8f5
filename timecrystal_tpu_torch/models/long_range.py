"""Long-range kicked-Ising model: power-law ZZ couplings J/|i-j|^alpha.

Port of ``timecrystal_tpu/models/long_range.py``.

  * J(r) = J / r^alpha is fitted by a sum of ``n_exp`` exponentials
    (``fit_power_law_exponentials``, host numpy; the fit residual is carried
    on the model), which makes the Ising half-step Hamiltonian

        H_z = sum_{i<j} J(j-i) sz_i sz_j + sum_i h_i sz_i

    an exact finite-state-machine MPO of bond dimension n_exp + 2
    (``long_range_ising_mpo`` / ``build_fsm_mpo``).
  * The Floquet period U_F = e^{-i tau/2 H_z} . KICK . e^{-i tau/2 H_z} is
    integrated by two-site TDVP (``dynamics/tdvp.py``): its SVD splits run
    the V-accumulating Jacobi kernel on a CUDA device.
  * ``alpha=None`` (or inf) reduces exactly to nearest-neighbor couplings
    (single channel, lam = 0).

Disorder fields enter the MPO once: the reference's interior double
counting belongs to its nearest-neighbor gate path only.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from ..core import gates as G
from ..core.mps import MPS, apply_one_site_gates, create_initial_state
from ..core.observables import (calculate_loschmidt_echo,
                                extract_subharmonic_amplitude, sz_sites)
from ..core.truncate import TruncParams
from ..dynamics.tdvp import DEFAULT_LANCZOS, MPO, TDVPEvolution
from .kicked_ising import draw_disorder_reference


def fit_power_law_exponentials(alpha: float, r_max: int, n_exp: int = 12
                               ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Fit r^{-alpha} on r = 1..r_max by sum_k c_k lam_k^r: relative least
    squares on a log-spaced decay-rate grid whose upper end scales with
    alpha.  Returns (c [n_exp], lam [n_exp], max relative error)."""
    if alpha <= 0:
        raise ValueError(f"alpha must be positive, got {alpha}")
    if r_max < 2:
        # a single distance: one channel reproduces it exactly
        return np.array([1.0]), np.array([0.0]), 0.0
    r = np.arange(1, r_max + 1, dtype=np.float64)
    target = r ** (-float(alpha))
    x = np.logspace(np.log10(0.5 / r_max),
                    np.log10(max(6.0, 2.5 * float(alpha))), int(n_exp))
    lam = np.exp(-x)
    A = lam[None, :] ** r[:, None]
    # rows scaled by 1/target => minimize the RELATIVE residual
    c, *_ = np.linalg.lstsq(A / target[:, None], np.ones_like(r), rcond=None)
    rel = float(np.max(np.abs(A @ c - target) / target))
    return c, lam, rel


def build_fsm_mpo(L: int,
                  channels: List[Tuple[float, float, np.ndarray, np.ndarray]],
                  onsite, d: int = 2, dtype=torch.complex64,
                  device="cuda") -> MPO:
    """Finite-state-machine MPO for exponentially decaying couplings:
    ``channels`` [(c_k, lam_k, A_k, B_k)] encode
    H = sum_k sum_{i<j} c_k lam_k^{j-i} A_k(i) B_k(j) + sum_i onsite_i.
    lam_k = 0 is the nearest-neighbor channel (the start weight c_k applies
    to distance 1 alone).  Same lower-triangular layout as
    ``dynamics.tdvp.build_mpo``, with the decay on the carry diagonal."""
    nc = len(channels)
    Dw = nc + 2
    W = np.zeros((L, Dw, Dw, d, d), dtype=complex)
    eye = np.eye(d)
    if onsite is None:
        onsite = np.zeros((d, d))
    onsite_list = ([np.asarray(onsite)] * L if np.ndim(onsite) == 2
                   else list(onsite))
    if len(onsite_list) != L:
        raise ValueError(f"onsite list has {len(onsite_list)} entries, "
                         f"expected {L}")
    for i in range(L):
        W[i, 0, 0] = eye
        W[i, Dw - 1, Dw - 1] = eye
        W[i, Dw - 1, 0] = onsite_list[i]
        for k, (ck, lamk, A, B) in enumerate(channels):
            start = ck * lamk if lamk != 0.0 else ck
            W[i, Dw - 1, 1 + k] = start * np.asarray(A)
            W[i, 1 + k, 1 + k] = lamk * eye
            W[i, 1 + k, 0] = np.asarray(B)
    return MPO(W=G.gate_from_numpy(W, dtype=dtype, device=device))


def long_range_ising_mpo(L: int, J: float, alpha: float | None, h_fields,
                         n_exp: int = 12, dtype=torch.complex64,
                         device="cuda"):
    """H_z = sum_{i<j} (J/|i-j|^alpha) sz_i sz_j + sum_i h_i sz_i as an FSM
    MPO.  Returns (mpo, max relative fit error of J(r)); alpha=None or inf
    gives exact nearest-neighbor couplings (fit error 0)."""
    hf = np.asarray(h_fields, dtype=np.float64)
    onsite = [hf[i] * G.SIGMA_Z for i in range(L)]
    if alpha is None or np.isinf(alpha):
        channels = [(float(J), 0.0, G.SIGMA_Z, G.SIGMA_Z)]
        return build_fsm_mpo(L, channels, onsite, dtype=dtype,
                             device=device), 0.0
    c, lam, rel = fit_power_law_exponentials(float(alpha), L - 1, n_exp)
    channels = [(float(J) * float(ck), float(lk), G.SIGMA_Z, G.SIGMA_Z)
                for ck, lk in zip(c, lam)]
    return build_fsm_mpo(L, channels, onsite, dtype=dtype, device=device), rel


def power_law_couplings(L: int, J: float, alpha: float | None) -> np.ndarray:
    """The exact coupling table J(r) for r = 1..L-1."""
    r = np.arange(1, L, dtype=np.float64)
    if alpha is None or np.isinf(alpha):
        out = np.zeros(L - 1)
        out[0] = J
        return out
    return J * r ** (-float(alpha))


def fitted_couplings(L: int, J: float, alpha: float | None,
                     n_exp: int = 12) -> np.ndarray:
    """J(r) as the MPO encodes it (the exponential-sum fit), so that oracle
    comparisons isolate the integrator error from the fit error."""
    if alpha is None or np.isinf(alpha):
        return power_law_couplings(L, J, alpha)
    c, lam, _ = fit_power_law_exponentials(float(alpha), L - 1, n_exp)
    r = np.arange(1, L, dtype=np.float64)
    return J * (lam[None, :] ** r[:, None] @ c)


class LongRangeKickedIsing:
    """Floquet kicked-Ising with power-law ZZ interactions, TDVP-driven:
    U_F = exp(-i tau/2 H_z) exp(-i theta/2 sum_j sx_j) exp(-i tau/2 H_z).
    Each half-step is ``substeps`` two-site TDVP steps under the FSM MPO;
    the kick is the exact one-site gate.  The constructor mirrors
    ``KickedIsingModel`` (disorder_seed / h_fields / theta / chi / dtype /
    device) plus (alpha, n_exp, substeps)."""

    def __init__(self, n_sites: int, J: float, h_disorder: float, tau: float,
                 alpha: float | None = 1.5, disorder_seed: int | None = None,
                 h_fields: np.ndarray | None = None, theta: float = np.pi,
                 chi: int = 64, n_exp: int = 12, substeps: int = 2,
                 lanczos_params: dict | None = None, dtype=torch.complex64,
                 device="cuda"):
        self.n_sites = int(n_sites)
        self.J = float(J)
        self.h_disorder = float(h_disorder)
        self.tau = float(tau)
        self.alpha = None if alpha is None else float(alpha)
        self.theta = float(theta)
        self.chi = int(chi)
        self.n_exp = int(n_exp)
        self.substeps = int(substeps)
        self.dtype = dtype
        self.device = torch.device(device)
        if h_fields is not None:
            self.h_fields = np.asarray(h_fields, dtype=np.float64)
        else:
            self.h_fields = draw_disorder_reference(n_sites, h_disorder,
                                                    disorder_seed)
        self.mpo, self.fit_rel_err = long_range_ising_mpo(
            self.n_sites, self.J, self.alpha, self.h_fields,
            n_exp=self.n_exp, dtype=dtype, device=self.device)
        if self.theta == float(np.pi):
            self.kick = G.pi_pulse_gate(dtype=dtype, device=self.device)
        else:
            self.kick = G.x_rotation_gate(self.theta, dtype=dtype,
                                          device=self.device)
        self._engine = TDVPEvolution(
            self.mpo, dt=self.tau / 2.0 / self.substeps, max_chi=self.chi,
            tdvp_type="two_site",
            trunc_params=TruncParams(chi_max=self.chi, svd_min=1e-12),
            lanczos_params={**DEFAULT_LANCZOS, **(lanczos_params or {})},
            device=self.device)

    def _half_step(self, psi: MPS) -> MPS:
        for _ in range(self.substeps):
            psi, _ = self._engine.step(psi)
        return psi

    def floquet_step(self, psi: MPS,
                     trunc_params: dict | TruncParams | None = None) -> MPS:
        """One Floquet period (KickedIsingModel's method name); a per-call
        ``trunc_params`` overrides the engine's for this period."""
        if trunc_params is None:
            return self._floquet_step_inner(psi)
        saved = self._engine.trunc_params
        if isinstance(trunc_params, TruncParams):
            self._engine.trunc_params = trunc_params
        else:
            d = dict(trunc_params)
            d.setdefault("chi_max", self.chi)
            self._engine.trunc_params = TruncParams.from_dict(d)
        try:
            return self._floquet_step_inner(psi)
        finally:
            self._engine.trunc_params = saved

    def _floquet_step_inner(self, psi: MPS) -> MPS:
        psi = self._half_step(psi)
        psi = apply_one_site_gates(psi, self.kick)
        return self._half_step(psi)

    def evolve(self, psi_initial: MPS, n_periods: int):
        """Evolve recording (traces, times, info): sz_sites [n+1, L],
        magnetization, staggered_magnetization, loschmidt_echo -- the
        CustomFloquet trace contract.  The observables stay on the device
        and reach the host once, after the last period."""
        L = self.n_sites
        sz, le = [sz_sites(psi_initial)], []
        psi = psi_initial
        start = time.perf_counter()
        for _ in range(n_periods):
            psi = self._floquet_step_inner(psi)
            sz.append(sz_sites(psi))
            le.append(calculate_loschmidt_echo(psi_initial, psi))
        sz_arr = torch.stack(sz).cpu().numpy()
        le_arr = np.ones(n_periods + 1)
        if le:
            le_arr[1:] = torch.stack(le).cpu().numpy()
        wall = time.perf_counter() - start
        signs = np.where(np.arange(L) % 2 == 0, 1.0, -1.0)
        traces = {
            "sz_sites": sz_arr,
            "magnetization": sz_arr.sum(axis=1),
            "staggered_magnetization": (sz_arr * signs).sum(axis=1) / L,
            "loschmidt_echo": le_arr,
        }
        times = np.arange(n_periods + 1) * 2 * self.tau
        info = {"wall_time": wall,
                "periods_per_second": (n_periods / wall if wall > 0
                                       else float("inf")),
                "fit_rel_err": self.fit_rel_err,
                "algorithm": "TDVP (two_site) long-range Floquet"}
        return traces, times, info


def scan_interaction_range(alphas, L: int = 12, J: float = 1.0,
                           h_disorder: float = 0.25, tau: float = 2.0,
                           theta: float = np.pi, n_periods: int = 24,
                           n_realizations: int = 3, chi: int = 48,
                           substeps: int = 2, seed0: int = 42,
                           dtype=torch.complex64, device="cuda",
                           progress: bool = False):
    """Subharmonic response A2T vs interaction range alpha: for each alpha,
    ``n_realizations`` disorder draws (seeds seed0, seed0+1, ...) of
    ``LongRangeKickedIsing`` from the Neel state, scored by the subharmonic
    amplitude of the staggered magnetization.  alpha entries may be
    None/inf (nearest-neighbor limit).

    Returns {"alphas", "a2t" [n_alpha], "a2t_std", "a2t_all" [n_alpha,
    n_realizations], "fit_rel_err" [n_alpha]}."""
    alphas = list(alphas)
    a2t_all = np.zeros((len(alphas), n_realizations))
    fit_errs = np.zeros(len(alphas))
    psi0 = create_initial_state(L, "neel", chi=chi, dtype=dtype, device=device)
    it = enumerate(alphas)
    if progress:
        try:
            from tqdm import tqdm
            it = tqdm(list(it), desc="alpha scan")
        except ImportError:
            pass
    for ia, alpha in it:
        for r in range(n_realizations):
            model = LongRangeKickedIsing(
                L, J, h_disorder, tau, alpha=alpha,
                disorder_seed=seed0 + r, theta=theta, chi=chi,
                substeps=substeps, dtype=dtype, device=device)
            traces, times, _ = model.evolve(psi0, n_periods)
            a2t_all[ia, r] = extract_subharmonic_amplitude(
                times, traces["staggered_magnetization"], 2 * tau)
        fit_errs[ia] = model.fit_rel_err
    return {
        "alphas": alphas,
        "a2t": a2t_all.mean(axis=1),
        "a2t_std": a2t_all.std(axis=1),
        "a2t_all": a2t_all,
        "fit_rel_err": fit_errs,
    }

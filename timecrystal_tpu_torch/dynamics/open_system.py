"""Open-system evolution: stochastic dephasing and Lindblad dynamics.

Port of ``timecrystal_tpu/dynamics/open_system.py``.

  * ``OpenSystemEvolution``: each Floquet period is followed by a random Z
    rotation per site, diag(e^{-ia}, e^{+ia}) with a ~ N(0, gamma dt): the
    channel average decays coherences as E[e^{2ia}] = e^{-2 gamma dt}.  The
    noise is an input of the period loop (unit normals [..., n_periods,
    L]); the wrappers draw it on the host, in float64, from an explicit
    ``torch.Generator`` (which advances from call to call) or a numpy seed,
    so the card and a complex128 host run of the same rows see the same
    noise.  A trajectory ensemble is one more leading axis.
  * ``LindbladEvolution``: drho/dt = -i[H, rho] + gamma sum_j (Z_j rho Z_j
    - rho) on rho vectorized as a local-dimension-4 superket MPS: bond
    supergates exp(dt(-i)(H_b x I - I x H_b^T)) through the same batched
    bond update, and the diagonal dephasing semigroup exp(dt gamma (Z x Z -
    I)) split symmetrically around them (Strang, O(dt^2)).
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core import gates as G
from ..core.mps import (MPS, HostStates, apply_one_site_gates,
                        expectation_one_site, max_bond_dimension, overlap,
                        product_state)
from ..core.observables import (add_derived_magnetization,
                                calculate_loschmidt_echo)
from ..core.truncate import TruncParams, apply_bond_gates
from ..models.kicked_ising import floquet_period
from .tebd import _stack_traces, to_host


# ---------------------------------------------------------------------------
# Stochastic pure-state dephasing (OpenSystemEvolution)
# ---------------------------------------------------------------------------

def dephasing_noise(shape, generator: torch.Generator | None = None,
                    seed: int | None = None) -> torch.Tensor:
    """Unit normals of ``shape`` on the host in float64: from ``generator``
    (a CPU ``torch.Generator``; it advances) or, without one, from
    ``np.random.default_rng(seed)``."""
    if generator is not None:
        return torch.randn(tuple(shape), generator=generator,
                           dtype=torch.float64)
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        tuple(shape)))


def _evolve_stochastic_scan(psi0: MPS, gates, noise, gamma_dt,
                            n_periods: int, tp: TruncParams,
                            ref_state: MPS | None = None):
    """``n_periods`` of one Floquet period then a random Z rotation per
    site, diag(e^{-ia}, e^{+ia}) with a = noise * sqrt(gamma_dt).

    ``noise``: unit normals [..., n_periods, L] (any device; cast to the
    state's real dtype), its leading axes the trajectories'; ``gamma_dt`` a
    float or one value per trajectory [...].  ``psi0`` and ``gates`` may
    carry leading axes that broadcast against them.  Returns (psi, traces)
    with device tensors sz_sites, sx_sites [..., n_periods, L], max_chi,
    trunc_err [..., n_periods] and, given ``ref_state``, loschmidt_echo
    [..., n_periods] (|<ref|psi>|^2)."""
    real, dev, L = psi0.dtype.to_real(), psi0.device, psi0.L
    noise = torch.as_tensor(noise).to(device=dev, dtype=real)
    if tuple(noise.shape[-2:]) != (n_periods, L):
        raise ValueError(f"noise has shape {tuple(noise.shape)}, needs "
                         f"[..., {n_periods}, {L}]")
    amp = torch.sqrt(torch.as_tensor(gamma_dt, dtype=real, device=dev))
    angles = noise * (amp[..., None, None] if amp.dim() else amp)
    sz_op = G.pauli_c("z", psi0.dtype, dev)
    sx_op = G.pauli_c("x", psi0.dtype, dev)

    def measure(psi, err):
        out = dict(sz_sites=expectation_one_site(psi, sz_op).real,
                   sx_sites=expectation_one_site(psi, sx_op).real,
                   max_chi=max_bond_dimension(psi),
                   trunc_err=torch.broadcast_to(err, psi.lead))
        if ref_state is not None:
            out["loschmidt_echo"] = calculate_loschmidt_echo(ref_state, psi)
        return out

    psi, outs = psi0, []
    for p in range(n_periods):
        psi, err = floquet_period(psi, gates, tp)
        a = angles[..., p, :]                                   # [..., L]
        ph = torch.polar(torch.ones_like(a), -a)
        diag = torch.stack([ph, ph.conj()], -1).to(psi.dtype)   # [..., L, 2]
        B = psi.B * diag[..., :, None, :, None]
        psi = MPS(B=B, lam=psi.lam.expand(B.shape[:-4] + psi.lam.shape[-2:]))
        outs.append(measure(psi, err))
    lead = outs[0]["trunc_err"].dim() if outs else len(psi0.lead)
    return psi, _stack_traces(outs, lambda: measure(
        psi, psi.lam.new_zeros(psi.lead)), lead)


class OpenSystemEvolution:
    """Stochastic pure-state dephasing around the Floquet drive of a
    ``KickedIsingModel``.  The noise comes from the instance's CPU
    ``torch.Generator`` (``self.generator``, seeded with ``seed``); it
    advances with every call, so repeated calls draw fresh noise."""

    def __init__(self, model, gamma: float, max_chi: int = 64,
                 trunc_params: dict | TruncParams | None = None, seed: int = 0):
        self.model = model
        self.gamma = float(gamma)
        self.max_chi = int(max_chi)
        if isinstance(trunc_params, TruncParams):
            self.trunc_params = trunc_params
        else:
            d = dict(trunc_params or {})
            d.setdefault("chi_max", max_chi)
            self.trunc_params = TruncParams.from_dict(d)
        self.generator = torch.Generator().manual_seed(seed)

    def _dt(self) -> float:
        return 2.0 * self.model.tau          # one Floquet period

    def _run(self, psi0: MPS, lead: tuple, n_periods: int, ref_state=None):
        noise = dephasing_noise(lead + psi0.lead + (n_periods, psi0.L),
                                generator=self.generator)
        return _evolve_stochastic_scan(psi0, self.model.gates, noise,
                                       self.gamma * self._dt(), n_periods,
                                       self.trunc_params, ref_state=ref_state)

    def evolve_floquet_period(self, psi: MPS) -> MPS:
        """One drive period followed by the dephasing kicks."""
        return self._run(psi, (), 1)[0]

    def evolve(self, psi0: MPS, n_periods: int) -> Tuple[Dict, List[float], Dict]:
        """One trajectory: (host traces, times, info).  Traces:
        sz_sites / sx_sites [n, L], max_chi, trunc_err, loschmidt_echo
        against psi0 [n], magnetization and staggered_magnetization; no
        t=0 row."""
        start = time.perf_counter()
        _, tr = self._run(psi0, (), n_periods, ref_state=psi0)
        traces = add_derived_magnetization(to_host(tr), psi0.L)
        times = [(p + 1) * self._dt() for p in range(n_periods)]
        info = {"wall_time": time.perf_counter() - start,
                "n_periods": n_periods, "gamma": self.gamma}
        return traces, times, info

    def evolve_ensemble(self, psi0: MPS, n_periods: int,
                        n_trajectories: int, mesh=None,
                        axis_name: str = "batch"
                        ) -> Tuple[Dict, List[float], Dict]:
        """``n_trajectories`` trajectories on one leading axis: the channel
        average.  Returns (mean traces, times, info): sz_sites, sx_sites
        and their _std [n, L], loschmidt_echo (the mean return fidelity),
        max_chi (the max over trajectories), the derived magnetizations,
        and per_trajectory max_chi and trunc_err [T, n].

        ``mesh`` (a ``parallel.sweep.BatchMesh``, or 'auto':
        ``parallel.sweep.resolve_mesh``) shards the trajectories over its
        devices and ranks: the noise of all T trajectories is drawn
        first (every rank draws the same from a generator seeded alike),
        then each shard evolves its rows on its device; the padding rows
        are dropped before any statistic.  ``axis_name`` is the JAX
        package's and is ignored."""
        from ..parallel.sweep import BatchMesh, map_rows, resolve_mesh

        start = time.perf_counter()
        noise = dephasing_noise((n_trajectories,) + psi0.lead
                                + (n_periods, psi0.L), generator=self.generator)

        def shard(r, dev):
            p0 = MPS(B=psi0.B.to(dev), lam=psi0.lam.to(dev))
            return to_host(_evolve_stochastic_scan(
                p0, self.model.gates.to(dev), r["noise"],
                self.gamma * self._dt(), n_periods, self.trunc_params,
                ref_state=p0)[1])

        tr = map_rows(shard, {"noise": noise.numpy()},
                      resolve_mesh(mesh, psi0.device) or BatchMesh((psi0.device,)))
        sz, sx = tr["sz_sites"], tr["sx_sites"]               # [T, n, L]
        traces = {
            "sz_sites": sz.mean(axis=0), "sz_sites_std": sz.std(axis=0),
            "sx_sites": sx.mean(axis=0), "sx_sites_std": sx.std(axis=0),
            "loschmidt_echo": tr["loschmidt_echo"].mean(axis=0),
            "max_chi": tr["max_chi"].max(axis=0),
            "per_trajectory": {"max_chi": tr["max_chi"],
                               "trunc_err": tr["trunc_err"]},
        }
        add_derived_magnetization(traces, psi0.L)
        times = [(p + 1) * self._dt() for p in range(n_periods)]
        info = {"wall_time": time.perf_counter() - start,
                "n_periods": n_periods, "n_trajectories": n_trajectories,
                "gamma": self.gamma}
        return traces, times, info

    # the reference's stubs: they pass the state through
    def psi_to_rho(self, psi: MPS) -> MPS:
        return psi

    def rho_to_psi_approximate(self, rho: MPS) -> MPS:
        return rho


# ---------------------------------------------------------------------------
# Vectorized density-matrix Lindblad evolution
# ---------------------------------------------------------------------------

def density_mps_from_product(basis_indices, chi: int, dtype=torch.complex64,
                             device="cuda") -> MPS:
    """rho = |b><b| of a product state as a superket MPS (d = 4), with
    vec(rho)_[p*2+q] = rho_{p,q} per site (p the ket, q the bra index)."""
    idx = np.asarray(basis_indices)
    return product_state(idx * 2 + idx, chi=chi, d=4, dtype=dtype,
                         device=device)


def vec_identity_mps(L: int, chi: int, dtype=torch.complex64,
                     device="cuda") -> MPS:
    """vec(I) as a superket MPS, |00> + |11> per site (unnormalized):
    Tr(rho) = <vec(I)|vec(rho)>."""
    B = torch.zeros((L, chi, 4, chi), dtype=dtype, device=device)
    B[:, 0, 0, 0] = 1.0
    B[:, 0, 3, 0] = 1.0
    lam = torch.zeros((L + 1, chi), dtype=dtype.to_real(), device=device)
    lam[:, 0] = 1.0
    return MPS(B=B, lam=lam)


def trace_rho(rho: MPS) -> torch.Tensor:
    """Tr(rho) (complex, one per chain) by the transfer contraction with
    vec(I)."""
    return overlap(vec_identity_mps(rho.L, rho.chi, rho.dtype, rho.device), rho)


def expectation_rho_one_site(rho: MPS, op: np.ndarray) -> np.ndarray:
    """Tr(rho O_i) for every site, host numpy complex [L]: vec(I) with site
    i's vector replaced by vec(O^dag) (``overlap`` conjugates its first
    argument: <vec(X)|vec(rho)> = Tr(X^dag rho)); the L probes are one
    leading axis of one contraction."""
    L = rho.L
    opv = torch.as_tensor(np.asarray(op).conj().T.reshape(4),
                          dtype=rho.dtype, device=rho.device)
    ident = vec_identity_mps(L, rho.chi, rho.dtype, rho.device)
    B = ident.B.expand((L,) + ident.B.shape).clone()
    sites = torch.arange(L, device=rho.device)
    B[sites, sites, 0, :, 0] = opv
    probes = MPS(B=B, lam=ident.lam.expand((L,) + ident.lam.shape))
    return overlap(probes, rho).cpu().numpy()


def _pair_permutation() -> np.ndarray:
    """Permutation matrix reshuffling (k1 k2 b1 b2) -> (k1 b1 k2 b2)."""
    P = np.zeros((16, 16))
    for k1 in range(2):
        for k2 in range(2):
            for b1 in range(2):
                for b2 in range(2):
                    src = ((k1 * 2 + k2) * 2 + b1) * 2 + b2
                    dst = ((k1 * 2 + b1) * 2 + k2) * 2 + b2
                    P[dst, src] = 1.0
    return P


class LindbladEvolution:
    """Trotterized Lindblad master equation on a vectorized density MPS,

        drho/dt = -i[H, rho] + gamma sum_j (Z_j rho Z_j - rho),

    ``hamiltonian`` a ``dynamics.tebd.NearestNeighborModel`` (bond terms
    H_b).  Gates are built on the host (scipy expm, complex128) and cast to
    ``dtype`` on ``device``."""

    def __init__(self, hamiltonian, gamma: float, max_chi: int = 64,
                 dtype=torch.complex64, device="cuda"):
        self.H = hamiltonian
        self.gamma = float(gamma)
        self.max_chi = int(max_chi)
        self.dtype = dtype
        self.device = torch.device(device)

    def dephasing_superoperator(self, site: int) -> np.ndarray:
        """The one-site dephasing generator gamma (Z x Z - I), 4x4
        diagonal (the same on every site)."""
        Z = np.asarray(G.SIGMA_Z)
        return self.gamma * (np.kron(Z, Z) - np.eye(4))

    def _bond_supergates(self, dt: float) -> torch.Tensor:
        """exp(dt (-i)(H_b x I - I x H_b^T)) of every bond, reordered from
        (ket1 ket2 bra1 bra2) to per-site superkets (ket1 bra1)(ket2 bra2):
        [L-1, 4, 4, 4, 4]."""
        import scipy.linalg

        eye4, P = np.eye(4), _pair_permutation()
        gates = []
        for Hb in self.H.bond_H:
            Lb = -1j * (np.kron(Hb, eye4) - np.kron(eye4, Hb.T))
            gates.append(scipy.linalg.expm(dt * (P @ Lb @ P.T)))
        g = np.stack(gates).reshape(-1, 4, 4, 4, 4)
        return G.gate_from_numpy(g, dtype=self.dtype, device=self.device)

    def _dephasing_gates(self, dt: float) -> torch.Tensor:
        """The diagonal semigroup exp(dt gamma (Z x Z - I)), [4, 4]."""
        d = np.exp(dt * np.diag(self.dephasing_superoperator(0)))
        return G.gate_from_numpy(np.diag(d).astype(complex), dtype=self.dtype,
                                 device=self.device)

    def _single_step(self, rho: MPS, gates_half, gates_full, deph_half,
                     tp: TruncParams) -> MPS:
        """One Strang step: dephasing half-step, even(dt/2) odd(dt)
        even(dt/2) bond supergates, dephasing half-step.  The dephasing
        gates are not unitary: after them the B tensors are only
        approximately right-isometric (O(gamma dt)) while lam is untouched,
        and the bond updates truncate in that gauge."""
        rho = apply_one_site_gates(rho, deph_half)
        rho, _ = apply_bond_gates(rho, gates_half, 0, tp)
        rho, _ = apply_bond_gates(rho, gates_full, 1, tp)
        rho, _ = apply_bond_gates(rho, gates_half, 0, tp)
        return apply_one_site_gates(rho, deph_half)

    def evolve(self, rho_initial: MPS, total_time: float, dt: float,
               observe_every: int = 1):
        """Evolve vec(rho): (rhos, times, info) with rho_initial and the
        state after every ``observe_every``-th step as host MPS (moved off
        the card in chunks), info wall_time, n_steps and final_trace.
        Truncation keeps chi_max = max_chi, svd_min 1e-12 and
        renormalize=False: the superket norm is not conserved (purity
        decays), Tr(rho) is (``trace_rho``)."""
        n_steps = int(round(total_time / dt))
        tp = TruncParams(chi_max=self.max_chi, svd_min=1e-12,
                         renormalize=False)
        gates_half = self._bond_supergates(dt / 2)
        gates_full = self._bond_supergates(dt)
        deph_half = self._dephasing_gates(dt / 2)
        history = HostStates()
        times = [0.0]
        rho = rho_initial
        start = time.perf_counter()
        for k in range(n_steps):
            rho = self._single_step(rho, gates_half, gates_full, deph_half, tp)
            if k % observe_every == 0:
                history.append(rho)
                times.append((k + 1) * dt)
        rhos = [rho_initial] + history.states()
        info = {"wall_time": time.perf_counter() - start, "n_steps": n_steps,
                "final_trace": complex(trace_rho(rho).cpu())}
        return rhos, times, info

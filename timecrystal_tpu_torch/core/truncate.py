"""Batched two-site MPS updates: theta contraction -> SVD -> truncation.

Port of ``timecrystal_tpu/core/truncate.py``.  All bonds of one parity are
updated as ONE batched SVD call; the ensemble axis R (the JAX package's
``vmap``) is folded into the bond axis before the SVD, so one kernel call
sees R * n_bonds matrices (320 at R=16, L=40).  Hastings-style update: the
new left tensor is built from theta without the left Schmidt values.

Truncation semantics (TeNPy's options): ``chi_max`` caps the kept count,
``svd_min`` drops small singular values, ``trunc_cut`` drops the largest
tail whose discarded weight stays below trunc_cut^2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.csvd import csvd_topk
from .mps import MPS

# Saturated-steady-state SVD fast paths (ops/csvd.py) whose reported
# trunc_err carries a projection leak + float32 noise floor rather than the
# true discarded weight; chi-escalation decisions must never read error off
# them (the staged evolutions replace them by 'jacobi' below the cap).
PROJECTED_SVD_METHODS = frozenset(
    {"jacobi_proj", "jacobi_core", "jacobi_core_fast"})


class TruncParams(NamedTuple):
    chi_max: int = 0          # 0 => no chi cap beyond the padded chi
    svd_min: float = 1e-12
    trunc_cut: float = 0.0    # 0 => disabled
    renormalize: bool = True
    # 'native' | 'jacobi' | 'jacobi_full' | 'auto' | a projected method
    # (PROJECTED_SVD_METHODS; ops/csvd.py)
    svd_method: str = "auto"
    jacobi_sweeps: int = 0    # 0 = dtype default (ops/jacobi_svd.py)

    @classmethod
    def reference_hot_path(cls) -> "TruncParams":
        """The mode the reference actually runs in: unbounded chi (up to
        padding) with tiny singular values trimmed (its hot path never
        forwards trunc_params)."""
        return cls(chi_max=0, svd_min=1e-14, trunc_cut=0.0, renormalize=True)

    @classmethod
    def from_dict(cls, d: dict | None) -> "TruncParams":
        if d is None:
            return cls(chi_max=100, svd_min=1e-12)   # the reference defaults
        return cls(
            chi_max=int(d.get("chi_max", 0) or 0),
            svd_min=float(d.get("svd_min", 1e-12)),
            trunc_cut=float(d.get("trunc_cut", 0.0) or 0.0),
            renormalize=bool(d.get("renormalize", True)),
            svd_method=str(d.get("svd_method", "auto")),
            jacobi_sweeps=int(d.get("jacobi_sweeps", 0)),
        )


def truncation_mask(S: torch.Tensor, chi: int, tp: TruncParams) -> torch.Tensor:
    """Boolean keep-mask over singular values S [..., chi] (sorted desc)."""
    k = torch.arange(S.shape[-1], device=S.device)
    mask = torch.ones(S.shape, dtype=torch.bool, device=S.device)
    if tp.chi_max and tp.chi_max < chi:
        mask &= k < tp.chi_max
    if tp.svd_min > 0.0:
        mask &= S >= tp.svd_min
    if tp.trunc_cut > 0.0:
        # discard the largest suffix with total discarded weight <=
        # trunc_cut^2, jointly with the other criteria
        zero = torch.zeros_like(S)
        disc_sq = torch.where(mask, zero, S * S)
        keep_sq = torch.where(mask, S * S, zero)
        tail_sq = torch.cumsum(keep_sq.flip(-1), -1).flip(-1)
        total_disc = disc_sq.sum(-1, keepdim=True)
        mask &= (tail_sq + total_disc) > tp.trunc_cut ** 2
    return mask


def apply_bond_gates(psi: MPS, gates: torch.Tensor, start: int, tp: TruncParams):
    """Apply two-site gates to every bond (start, start+2, ...) in one batch.

    ``gates`` [..., L-1, d, d, d, d] (a gate per bond, convention
    gates[b, p_out, q_out, p_in, q_in]; leading axes broadcast against the
    MPS's ensemble axes).  Returns (new MPS, trunc_err [...]) with
    trunc_err the discarded weight summed over the updated bonds.

    The algebra deliberately duplicates ``bond_update_core`` (the
    single-bond path) rather than looping over it; any change to the
    truncation/renormalization logic must be made in BOTH
    (tests/test_torch_truncate.py pins them together)."""
    L, chi, d = psi.L, psi.chi, psi.d
    n = len(range(start, L - 1, 2))
    if n == 0:
        return psi, psi.lam.new_zeros(psi.lead)
    sl_l, sl_r = slice(start, L - 1, 2), slice(start + 1, L, 2)
    Bl = psi.B[..., sl_l, :, :, :]            # [..., n, chi, d, chi]
    Br = psi.B[..., sl_r, :, :, :]
    lamL = psi.lam[..., sl_l, :]              # [..., n, chi]
    g = gates[..., sl_l, :, :, :, :]          # [..., n, d, d, d, d]

    # theta_tilde = B_l B_r (no left lambda -- Hastings), then the gate
    tt = torch.einsum("...napb,...nbqc->...napqc", Bl, Br)
    tt = torch.einsum("...npqrs,...narsc->...napqc", g, tt)
    lead = tt.shape[:-5]
    theta = tt * lamL[..., :, :, None, None, None].to(tt.dtype)
    M = theta.reshape(*lead, n, chi * d, d * chi)
    # top-chi SVD; the R and bond axes are flattened inside csvd_topk
    S_top, Vh_top, disc_tail = csvd_topk(M, chi, method=tp.svd_method,
                                         jacobi_sweeps=tp.jacobi_sweeps)
    mask = truncation_mask(S_top, chi, tp)
    zero = torch.zeros_like(S_top)
    S_kept = torch.where(mask, S_top, zero)
    # discarded weight: everything masked out plus the tail beyond chi
    disc = (torch.where(mask, zero, S_top * S_top).sum((-2, -1))
            + disc_tail.sum(-1))
    nrm = torch.clamp(torch.sqrt((S_kept * S_kept).sum(-1, keepdim=True)),
                      min=1e-30)                        # [..., n, 1]
    S_new = S_kept / nrm if tp.renormalize else S_kept

    Vh_kept = Vh_top * mask[..., None].to(Vh_top.dtype)  # [..., n, chi, d*chi]
    Br_new = Vh_kept.reshape(*lead, n, chi, d, chi)
    # Hastings: B_l_new = theta_tilde . V_kept
    Mt = tt.reshape(*lead, n, chi * d, d * chi)
    Bl_new = Mt @ Vh_kept.mH                             # [..., n, chi*d, chi]
    if tp.renormalize:
        Bl_new = Bl_new * (1.0 / nrm)[..., None].to(Bl_new.dtype)
    Bl_new = Bl_new.reshape(*lead, n, chi, d, chi)

    B = psi.B.expand(lead + psi.B.shape[-4:]).clone()
    B[..., sl_l, :, :, :] = Bl_new
    B[..., sl_r, :, :, :] = Br_new
    lam = psi.lam.expand(lead + psi.lam.shape[-2:]).clone()
    lam[..., sl_r, :] = S_new.to(lam.dtype)
    return MPS(B=B, lam=lam), disc.to(lam.dtype)


def bond_update_core(Bl: torch.Tensor, Br: torch.Tensor, lamL: torch.Tensor,
                     gate: torch.Tensor, tp: TruncParams):
    """Two-site update on bare tensors: (Bl [..., chi, d, chi], Br, lamL
    [..., chi], gate [..., d, d, d, d]) -> (Bl_new, Br_new, S_new, disc)."""
    chi, d = Bl.shape[-3], Bl.shape[-2]
    tt = torch.einsum("...apb,...bqc->...apqc", Bl, Br)
    tt = torch.einsum("...pqrs,...arsc->...apqc", gate, tt)
    lead = tt.shape[:-4]
    theta = tt * lamL[..., :, None, None, None].to(tt.dtype)
    M = theta.reshape(*lead, chi * d, d * chi)
    S_top, Vh_top, disc_tail = csvd_topk(M, chi, method=tp.svd_method,
                                         jacobi_sweeps=tp.jacobi_sweeps)
    mask = truncation_mask(S_top, chi, tp)
    zero = torch.zeros_like(S_top)
    S_kept = torch.where(mask, S_top, zero)
    disc = torch.where(mask, zero, S_top * S_top).sum(-1) + disc_tail
    nrm = torch.clamp(torch.sqrt((S_kept * S_kept).sum(-1, keepdim=True)),
                      min=1e-30)
    S_new = S_kept / nrm if tp.renormalize else S_kept
    Vh_kept = Vh_top * mask[..., None].to(Vh_top.dtype)
    Br_new = Vh_kept.reshape(*lead, chi, d, chi)
    Mt = tt.reshape(*lead, chi * d, d * chi)
    Bl_new = Mt @ Vh_kept.mH
    if tp.renormalize:
        Bl_new = Bl_new * (1.0 / nrm)[..., None].to(Bl_new.dtype)
    Bl_new = Bl_new.reshape(*lead, chi, d, chi)
    return Bl_new, Br_new, S_new, disc


def apply_single_bond_gate(psi: MPS, gate: torch.Tensor, bond: int,
                           tp: TruncParams):
    """Apply one two-site gate at a single bond.  Returns (psi, disc)."""
    Bl_new, Br_new, S_new, disc = bond_update_core(
        psi.B[..., bond, :, :, :], psi.B[..., bond + 1, :, :, :],
        psi.lam[..., bond, :], gate, tp)
    lead = Bl_new.shape[:-3]
    B = psi.B.expand(lead + psi.B.shape[-4:]).clone()
    B[..., bond, :, :, :] = Bl_new
    B[..., bond + 1, :, :, :] = Br_new
    lam = psi.lam.expand(lead + psi.lam.shape[-2:]).clone()
    lam[..., bond + 1, :] = S_new.to(lam.dtype)
    return MPS(B=B, lam=lam), disc.to(lam.dtype)


def swap_gate(d: int = 2, dtype=torch.complex64, device="cuda") -> torch.Tensor:
    """SWAP gate [p, q, r, s] = delta_{p s} delta_{q r}."""
    eye = torch.eye(d, dtype=dtype, device=device)
    return torch.einsum("ps,qr->pqrs", eye, eye)


def apply_two_site_gate(psi: MPS, gate, i: int, j: int,
                        trunc_params: dict | TruncParams | None = None) -> MPS:
    """Apply a single d^2 x d^2 gate on adjacent sites (i, j); only bond
    min(i, j) is re-SVD'd and truncated.  ``gate`` may be numpy or a
    tensor, [d*d, d*d] or [d, d, d, d]."""
    if abs(i - j) != 1:
        raise ValueError("Sites must be adjacent for two-site gate")
    tp = trunc_params if isinstance(trunc_params, TruncParams) else \
        TruncParams.from_dict(trunc_params if isinstance(trunc_params, dict)
                              else None)
    d = psi.d
    g = torch.as_tensor(gate, dtype=psi.dtype, device=psi.device).reshape(d, d, d, d)
    if i > j:
        # caller gave (right, left): exchange the gate's two site axes
        i, j = j, i
        g = g.permute(1, 0, 3, 2)
    psi_new, _ = apply_single_bond_gate(psi, g, i, tp)
    return psi_new

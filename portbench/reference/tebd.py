"""Plain TEBD of the Floquet kicked-Ising chain: the benchmark's reference.

Written from the model's definition, independently of the program under
test, and importing nothing of it.  One period is

    U_F = H K H,   H = prod_b exp(-i tau/2 (J z_b z_{b+1} + h_b z_b + h_{b+1} z_{b+1})),
                   K = prod_j exp(-i theta/2 x_j),

with every bond carrying the full fields of both of its sites (the
source project's convention) and the bonds of H applied even ones first.
The chain is a matrix-product state in right-canonical form (tensors
B [R, L, chi, 2, chi], Schmidt values lam [R, L+1, chi]) with one chi
shared by every bond, grown as the Schmidt ranks grow.  Each two-site
update contracts the pair, applies the diagonal gate, takes a library SVD
(LAPACK through ``torch.linalg.svd``), truncates by the configuration's
rule and renormalizes; the new left tensor is theta without the left
Schmidt values times V (Hastings' form).

``frame='strict'`` applies H K H each period.  ``frame='merged'`` evolves
phi = H psi with one full step H^2 after each kick; z-diagonal H leaves
<z_j> unchanged, and for a product start H psi0 is psi0 up to a phase, so
sz and the Loschmidt echo are those of psi, while the Schmidt ranks
(max_chi) are phi's.

Precisions: 'complex128' is the reference.  'tf32' is the control: complex64
storage, every product of a contraction formed from operands rounded to
TF32's 10-bit mantissa (the tensor cores' TF32 mode, which rounds the
inputs of a float32 matmul and accumulates in float32), and the SVD in
complex64.  'complex64' is a witness in the program's own precision:
complex64 storage and products, LAPACK's SVD in complex64, no rounding to
TF32.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

PRECISIONS = ("complex128", "complex64", "tf32")
SZ_TOL_LAM = 1e-14       # a Schmidt value above this counts to max_chi


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (complex64 or float32) with each float32 rounded to the
    nearest TF32 value (10 mantissa bits; ties to even)."""
    real = torch.view_as_real(x.resolve_conj()) if x.is_complex() else x
    bits = real.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    out = bits.view(torch.float32)
    return torch.view_as_complex(out) if x.is_complex() else out


class _Arith:
    """The arithmetic of one precision: the complex dtype and the einsum
    whose operands are rounded first (TF32) or not."""

    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.tf32 = precision == "tf32"
        self.cdtype = (torch.complex128 if precision == "complex128"
                       else torch.complex64)
        self.rdtype = self.cdtype.to_real()

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return tf32_round(x) if self.tf32 else x

    def einsum(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, *[self.r(o) for o in ops])

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.r(a) @ self.r(b)


POOL_MIN_SIDE = 64      # smaller SVDs run faster one after another


def _svd(M: torch.Tensor, pool: ThreadPoolExecutor, workers: int):
    """(S, Vh) of the batch M [B, n, n] by LAPACK, over ``workers`` blocks
    of the batch in the threads of ``pool`` when the matrices are large
    enough."""
    if workers <= 1 or M.shape[-1] < POOL_MIN_SIDE or M.shape[0] < 2 * workers:
        _, S, Vh = torch.linalg.svd(M, full_matrices=False)
        return S, Vh
    parts = list(pool.map(lambda x: torch.linalg.svd(x, full_matrices=False),
                          M.chunk(workers)))
    return torch.cat([p[1] for p in parts]), torch.cat([p[2] for p in parts])


def keep_mask(S: torch.Tensor, cap: int, svd_min: float,
              trunc_cut: float) -> torch.Tensor:
    """Which singular values S [..., k] (descending) a bond keeps: at most
    ``cap``, none below ``svd_min``, and, with ``trunc_cut``, not the
    longest tail whose weight together with the weight already dropped
    stays within trunc_cut**2."""
    idx = torch.arange(S.shape[-1])
    keep = (idx < cap) & (S >= svd_min)
    if trunc_cut > 0.0:
        w = S * S
        dropped = torch.where(keep, 0.0, w).sum(-1, keepdim=True)
        kept_w = torch.where(keep, w, 0.0)
        tail = kept_w.flip(-1).cumsum(-1).flip(-1)     # weight of [k:] kept
        keep &= (tail + dropped) > trunc_cut ** 2
    return keep


class Chain:
    """R chains as one right-canonical MPS with a common bond width."""

    def __init__(self, basis: np.ndarray, R: int, ar: _Arith,
                 pool: ThreadPoolExecutor, workers: int):
        L = len(basis)
        self.pool, self.workers = pool, workers
        self.ar, self.R, self.L, self.chi = ar, R, L, 1
        self.B = torch.zeros(R, L, 1, 2, 1, dtype=ar.cdtype)
        self.B[:, np.arange(L), 0, np.asarray(basis), 0] = 1.0
        self.lam = torch.zeros(R, L + 1, 1, dtype=ar.rdtype)
        self.lam[..., 0] = 1.0
        self.basis = np.asarray(basis)

    def _widen(self, chi: int) -> None:
        if chi <= self.chi:
            return
        c = self.chi
        B = self.B.new_zeros(self.R, self.L, chi, 2, chi)
        B[:, :, :c, :, :c] = self.B
        lam = self.lam.new_zeros(self.R, self.L + 1, chi)
        lam[..., :c] = self.lam
        self.B, self.lam, self.chi = B, lam, chi

    def bond_layer(self, parity: int, phases: torch.Tensor,
                   trunc: dict) -> torch.Tensor:
        """The diagonal two-site gates ``phases`` [R, L-1, 2, 2] (unit
        complex numbers) on bonds parity, parity+2, ...; returns the
        discarded weight [R] summed over those bonds."""
        ar, R, L, chi = self.ar, self.R, self.L, self.chi
        left = np.arange(parity, L - 1, 2)
        nb = len(left)
        if nb == 0:
            return torch.zeros(R, dtype=ar.rdtype)
        Bl, Br = self.B[:, left], self.B[:, left + 1]
        tt = ar.einsum("rnapb,rnbqc->rnapqc", Bl, Br)
        tt = ar.r(tt) * ar.r(phases[:, left])[:, :, None, :, :, None]
        lamL = self.lam[:, left].to(ar.cdtype)[:, :, :, None, None, None]
        theta = (tt * lamL).reshape(R * nb, 2 * chi, 2 * chi)
        S, Vh = _svd(theta, self.pool, self.workers)
        cap = min(int(trunc["chi_cap"]), 2 * chi)
        keep = keep_mask(S, cap, float(trunc["svd_min"]),
                         float(trunc.get("trunc_cut", 0.0)))
        disc = torch.where(keep, 0.0, S * S).sum(-1)
        k = max(int(keep.sum(-1).max()), 1)
        S_k = torch.where(keep, S, 0.0)[:, :k]
        nrm = torch.sqrt((S_k * S_k).sum(-1)).clamp_min(1e-300)
        Vh_k = Vh[:, :k] * keep[:, :k, None].to(Vh.dtype)
        Bl_new = ar.matmul(tt.reshape(R * nb, 2 * chi, 2 * chi), Vh_k.mH)
        Bl_new = Bl_new / nrm[:, None, None].to(ar.cdtype)
        self._widen(k)
        c = self.chi
        Bn_l = self.B.new_zeros(R * nb, chi, 2, c)
        Bn_l[..., :k] = Bl_new.reshape(R * nb, chi, 2, k)
        Bn_r = self.B.new_zeros(R * nb, c, 2, c)
        Bn_r[:, :k, :, :chi] = Vh_k.reshape(R * nb, k, 2, chi)
        self.B[:, left, :chi] = Bn_l.reshape(R, nb, chi, 2, c)
        self.B[:, left + 1] = Bn_r.reshape(R, nb, c, 2, c)
        lam = self.lam.new_zeros(R * nb, c)
        lam[:, :k] = (S_k / nrm[:, None]).to(ar.rdtype)
        self.lam[:, left + 1] = lam.reshape(R, nb, c)
        return disc.reshape(R, nb).sum(-1).to(torch.float64)

    def select(self, rows) -> None:
        """Keep the chains ``rows`` (a boolean mask over R) alone."""
        rows = torch.as_tensor(rows)
        self.B, self.lam = self.B[rows], self.lam[rows]
        self.R = int(self.B.shape[0])

    def kick(self, K: torch.Tensor) -> None:
        """The one-site gate K [R, 2, 2] on every site."""
        self.B = self.ar.einsum("rpq,rlaqb->rlapb", K, self.B)

    def sz(self) -> torch.Tensor:
        """<z_j> for every site [R, L]; left environment diag(lam_j^2)."""
        ar = self.ar
        z = torch.tensor([1.0, -1.0], dtype=ar.cdtype)
        w = (self.lam[:, :-1] ** 2).to(ar.cdtype)
        zb = self.B * z[None, None, None, :, None]
        per_a = ar.einsum("rlapb,rlapb->rla", self.B.conj(), zb)
        return (per_a * w).sum(-1).real.to(torch.float64)

    def echo(self) -> torch.Tensor:
        """|<psi0|psi>|^2 [R] with psi0 the product state of ``basis``."""
        v = self.B[:, 0, 0, self.basis[0], :]              # [R, chi]
        for i in range(1, self.L):
            v = self.ar.einsum("ra,rab->rb", v, self.B[:, i, :, self.basis[i], :])
        return (v[:, 0].abs() ** 2).to(torch.float64)

    def max_chi(self) -> torch.Tensor:
        inner = (self.lam[:, 1:-1] > SZ_TOL_LAM).sum(-1)
        return inner.amax(-1).clamp_min(1).to(torch.float64)


def bond_phases(J: float, h: np.ndarray, tau_half: np.ndarray,
                cdtype) -> torch.Tensor:
    """exp(-i tau_half E) of every bond, [R, L-1, 2, 2] over (s_b, s_b+1),
    E = J s s' + h_b s + h_b+1 s'."""
    s = np.array([1.0, -1.0])
    E = (J * s[:, None] * s[None, :]
         + h[:, :-1, None, None] * s[None, None, :, None]
         + h[:, 1:, None, None] * s[None, None, None, :])
    ang = -np.asarray(tau_half, float)[:, None, None, None] * E
    return torch.from_numpy(np.exp(1j * ang)).to(cdtype)


def kick_gates(thetas: np.ndarray, cdtype) -> torch.Tensor:
    """exp(-i theta/2 x) [R, 2, 2]."""
    c, s = np.cos(thetas / 2.0), np.sin(thetas / 2.0)
    K = np.zeros((len(thetas), 2, 2), complex)
    K[:, 0, 0] = K[:, 1, 1] = c
    K[:, 0, 1] = K[:, 1, 0] = -1j * s
    return torch.from_numpy(K).to(cdtype)


def evolve(h_fields, taus, thetas, basis, n_periods: int, J: float,
           trunc: dict, frame: str = "strict", precision: str = "complex128",
           workers: int = 8, until_trunc: float | None = None) -> dict:
    """Traces of R chains over ``n_periods`` periods, the t=0 row first:
    sz_sites [R, n+1, L], loschmidt_echo, max_chi, trunc_err [R, n+1]
    (the weight discarded in each period), staggered_magnetization
    [R, n+1] = (1/L) sum_j (-1)^j sz_j.  ``trunc`` holds chi_cap, svd_min
    and trunc_cut; ``h_fields`` [R, L], ``taus`` and ``thetas`` [R].
    With ``until_trunc`` a chain stops after its first period that
    discards more than that; its later rows are NaN."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)      # parallel over SVD blocks, not inside ops
    try:
        with ThreadPoolExecutor(max(int(workers), 1)) as pool:
            return _evolve(h_fields, taus, thetas, basis, n_periods, J,
                           trunc, frame, precision, pool, int(workers),
                           until_trunc)
    finally:
        torch.set_num_threads(n_threads)


def _evolve(h_fields, taus, thetas, basis, n_periods, J, trunc, frame,
            precision, pool, workers, until_trunc):
    h = np.asarray(h_fields, float)
    R, L = h.shape
    taus = np.broadcast_to(np.asarray(taus, float), (R,))
    thetas = np.broadcast_to(np.asarray(thetas, float), (R,))
    ar = _Arith(precision)
    half = bond_phases(J, h, taus / 2.0, ar.cdtype)
    full = bond_phases(J, h, taus, ar.cdtype)
    K = kick_gates(thetas, ar.cdtype)
    psi = Chain(basis, R, ar, pool, workers)

    def sweep(ph):
        return psi.bond_layer(0, ph, trunc) + psi.bond_layer(1, ph, trunc)

    if frame == "merged":
        sweep(half)
    elif frame != "strict":
        raise ValueError(f"unknown frame {frame}")
    live = np.arange(R)                 # the chains still evolved
    nan = torch.full((R,), float("nan"), dtype=torch.float64)

    def row(sz, le, chi, err):
        out = dict(sz=torch.full((R, L), float("nan"), dtype=torch.float64),
                   le=nan.clone(), chi=nan.clone(), err=nan.clone())
        out["sz"][live], out["le"][live] = sz, le
        out["chi"][live], out["err"][live] = chi, err
        return out

    ones = torch.ones(R, dtype=torch.float64)
    rows = [row(psi.sz(), ones, ones, 0 * ones)]
    for _ in range(n_periods):
        if not len(live):
            rows.append(row(torch.zeros(0, L), *(torch.zeros(0),) * 3))
            continue
        if frame == "strict":
            err = sweep(half)
            psi.kick(K)
            err = err + sweep(half)
        else:
            psi.kick(K)
            err = sweep(full)
        rows.append(row(psi.sz(), psi.echo(), psi.max_chi(), err))
        if until_trunc is not None and bool((err > until_trunc).any()):
            stay = (err <= until_trunc).numpy()
            live, half, full, K = live[stay], half[stay], full[stay], K[stay]
            psi.select(stay)
    sz = torch.stack([r["sz"] for r in rows], 1).numpy()
    signs = np.where(np.arange(L) % 2 == 0, 1.0, -1.0)
    return {
        "sz_sites": sz,
        "loschmidt_echo": torch.stack([r["le"] for r in rows], 1).numpy(),
        "max_chi": torch.stack([r["chi"] for r in rows], 1).numpy(),
        "trunc_err": torch.stack([r["err"] for r in rows], 1).numpy(),
        "staggered_magnetization": (sz * signs).sum(-1) / L,
    }

"""The reference of the saturated steady state: a given MPS continued.

Plain PyTorch, importing nothing of the program under test; the chain,
its gates and its arithmetic are ``tebd``'s.

  * ``continue_merged``: R chains from a given right-canonical MPS (B
    [R, L, chi, 2, chi], lam [R, L+1, chi]) over n periods in the merged
    frame, as the program runs a chunk: the entry half-step H, then per
    period the kick and the full step H^2.  Every bond layer takes
    LAPACK's SVD and keeps the top ``chi_cap`` (the exact top-k) above
    ``svd_min``; per period sz, the Loschmidt echo against the product
    state ``basis`` and the discarded weight.
  * ``entry_thetas``: the two-site matrices [R * n_even, 2 chi, 2 chi] of
    the entry half-step's first layer (the even bonds) of every chain,
    formed as the program forms them (theta without the left Schmidt
    values, the gate, then the left Schmidt values).
  * ``topk``: the exact top-k singular values and right vectors of given
    matrices by LAPACK, in a precision: 'complex128' (the reference),
    'complex64' (a witness in the program's precision) or 'tf32' (the
    control: the matrix rounded to TF32's 10-bit mantissa first).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import tebd


def _threads(fn, workers: int):
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)      # parallel over SVD blocks, not inside ops
    try:
        with ThreadPoolExecutor(max(int(workers), 1)) as pool:
            return fn(pool)
    finally:
        torch.set_num_threads(n_threads)


def _chain(B, lam, basis, ar, pool, workers) -> tebd.Chain:
    c = tebd.Chain(basis, int(B.shape[0]), ar, pool, workers)
    c.B = torch.as_tensor(B).to(ar.cdtype).clone()
    c.lam = torch.as_tensor(lam).to(ar.rdtype).clone()
    c.chi = int(c.B.shape[-1])
    return c


def continue_merged(B, lam, h_fields, tau: float, theta: float, basis,
                    n_periods: int, J: float, trunc: dict,
                    precision: str = "complex128", workers: int = 8) -> dict:
    """Traces of the chains (B, lam) continued ``n_periods`` merged
    periods: sz_sites [R, n, L], loschmidt_echo and trunc_err [R, n] (the
    weight each period discarded), entry_err [R] (the entry half-step's).
    ``trunc`` holds chi_cap, svd_min and trunc_cut."""
    h = np.asarray(h_fields, float)
    R = h.shape[0]
    taus = np.full(R, float(tau))

    def go(pool):
        ar = tebd._Arith(precision)
        half = tebd.bond_phases(J, h, taus / 2.0, ar.cdtype)
        full = tebd.bond_phases(J, h, taus, ar.cdtype)
        K = tebd.kick_gates(np.full(R, float(theta)), ar.cdtype)
        psi = _chain(B, lam, basis, ar, pool, workers)

        def sweep(ph):
            return psi.bond_layer(0, ph, trunc) + psi.bond_layer(1, ph, trunc)

        entry = sweep(half)
        sz, le, err = [], [], []
        for _ in range(n_periods):
            psi.kick(K)
            err.append(sweep(full))
            sz.append(psi.sz())
            le.append(psi.echo())
        return {"sz_sites": torch.stack(sz, 1).numpy(),
                "loschmidt_echo": torch.stack(le, 1).numpy(),
                "trunc_err": torch.stack(err, 1).numpy(),
                "entry_err": entry.numpy()}

    return _threads(go, workers)


def entry_thetas(B, lam, h_fields, tau: float, J: float,
                 precision: str = "complex128") -> torch.Tensor:
    """[R * n_even, 2 chi, 2 chi]: theta of every even bond of every chain
    under the entry half-step's gates, rows (left index, left spin),
    columns (right spin, right index)."""
    ar = tebd._Arith(precision)
    B = torch.as_tensor(B).to(ar.cdtype)
    lam = torch.as_tensor(lam).to(ar.rdtype)
    h = np.asarray(h_fields, float)
    R, L, chi = B.shape[0], B.shape[1], B.shape[2]
    half = tebd.bond_phases(J, h, np.full(R, float(tau)) / 2.0, ar.cdtype)
    left = np.arange(0, L - 1, 2)
    tt = ar.einsum("rnapb,rnbqc->rnapqc", B[:, left], B[:, left + 1])
    tt = ar.r(tt) * ar.r(half[:, left])[:, :, None, :, :, None]
    lamL = lam[:, left].to(ar.cdtype)[:, :, :, None, None, None]
    return (tt * lamL).reshape(R * len(left), 2 * chi, 2 * chi)


def topk(theta: torch.Tensor, k: int, precision: str = "complex128",
         workers: int = 8):
    """(S [B, k] float64, V [B, n, k]) of theta [B, m, n] by LAPACK in
    ``precision``: exact for 'complex128'; 'complex64' rounds theta to
    complex64 first, 'tf32' to TF32."""
    if precision == "complex128":
        M = theta.to(torch.complex128)
    elif precision == "complex64":
        M = theta.to(torch.complex64)
    elif precision == "tf32":
        M = tebd.tf32_round(theta.to(torch.complex64))
    else:
        raise ValueError(f"precision must be one of {tebd.PRECISIONS}")
    S, Vh = _threads(lambda pool: tebd._svd(M, pool, workers), workers)
    return S[:, :k].to(torch.float64), Vh[:, :k].mH


def kept_weight(theta: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """||theta V||_F^2 [B] in complex128: the weight a truncation to the
    columns of V keeps."""
    TV = theta.to(torch.complex128) @ V.to(torch.complex128)
    return (TV.real ** 2 + TV.imag ** 2).sum((-2, -1))

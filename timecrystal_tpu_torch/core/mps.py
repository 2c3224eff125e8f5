"""Fixed-shape padded-bond Matrix Product States.

Port of ``timecrystal_tpu/core/mps.py``.  An MPS is

  ``B``   : complex [..., L, chi, d, chi] -- right-canonical B tensors, axes
            (left, phys, right);
  ``lam`` : real    [..., L+1, chi]       -- Schmidt values, lam[i] on the
            bond left of site i.

The optional leading axes carry an ensemble (the JAX package ``vmap``s
whole evolutions; here the realization axis R is written out).  Bond
dimensions below the padded ``chi`` are zero Schmidt values with zero
rows/columns in the neighbouring B tensors, so every contraction is exact
at a fixed shape.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class MPS:
    """Padded fixed-shape MPS in right-canonical (B, lambda) form."""

    B: torch.Tensor    # complex [..., L, chi, d, chi]
    lam: torch.Tensor  # real    [..., L+1, chi]

    @property
    def L(self) -> int:
        return self.B.shape[-4]

    @property
    def chi(self) -> int:
        return self.B.shape[-3]

    @property
    def d(self) -> int:
        return self.B.shape[-2]

    @property
    def dtype(self) -> torch.dtype:
        return self.B.dtype

    @property
    def device(self) -> torch.device:
        return self.B.device

    @property
    def lead(self) -> tuple:
        """Leading (ensemble) axes, () for a single chain."""
        return tuple(self.B.shape[:-4])


def pad_mps(psi: MPS, new_chi: int) -> MPS:
    """Embed an MPS into a larger padded bond dimension (exact: the new
    directions carry zero weight)."""
    chi = psi.chi
    if new_chi < chi:
        raise ValueError(f"pad_mps: new_chi {new_chi} < current chi {chi}")
    if new_chi == chi:
        return psi
    lead, L, d = psi.lead, psi.L, psi.d
    B = psi.B.new_zeros(lead + (L, new_chi, d, new_chi))
    B[..., :chi, :, :chi] = psi.B
    lam = psi.lam.new_zeros(lead + (L + 1, new_chi))
    lam[..., :chi] = psi.lam
    return MPS(B=B, lam=lam)


def product_state(basis_indices, chi: int, d: int = 2,
                  dtype=torch.complex64, device="cuda") -> MPS:
    """Product-state MPS |i_0 ... i_{L-1}> with padded bond chi.

    ``basis_indices``: ints [..., L] (0 = up for d=2); leading axes become
    the MPS's ensemble axes."""
    idx = torch.tensor(np.asarray(basis_indices), dtype=torch.int64,
                       device=device)
    lead, L = tuple(idx.shape[:-1]), idx.shape[-1]
    onehot = torch.nn.functional.one_hot(idx, d).to(dtype)     # [..., L, d]
    B = torch.zeros(lead + (L, chi, d, chi), dtype=dtype, device=device)
    B[..., 0, :, 0] = onehot
    lam = torch.zeros(lead + (L + 1, chi), dtype=dtype.to_real(),
                      device=device)
    lam[..., 0] = 1.0
    return MPS(B=B, lam=lam)


def state_basis_indices(n_sites: int, state_type: str, d: int = 2,
                        rng: np.random.Generator | None = None) -> np.ndarray:
    """Basis-index realization of a named product state ('up' == index 0).
    'random' draws from ``rng`` (a fresh default_rng when None)."""
    if state_type == "all_up":
        return np.zeros(n_sites, dtype=np.int32)
    if state_type == "all_down":
        return np.full(n_sites, d - 1, dtype=np.int32)
    if state_type == "neel":
        return np.array([0 if i % 2 == 0 else d - 1 for i in range(n_sites)],
                        dtype=np.int32)
    if state_type == "random":
        gen = rng if rng is not None else np.random.default_rng()
        return gen.integers(0, d, size=n_sites).astype(np.int32)
    raise ValueError(f"Unknown state type: {state_type}")


def create_initial_state(n_sites: int, state_type: str = "all_up",
                         chi: int = 64, d: int = 2, dtype=torch.complex64,
                         device="cuda",
                         rng: np.random.Generator | None = None) -> MPS:
    """Named initial product states (all_up / all_down / neel / random)."""
    idx = state_basis_indices(n_sites, state_type, d=d, rng=rng)
    return product_state(idx, chi=chi, d=d, dtype=dtype, device=device)


def haar_product_state(n_sites: int, chi: int, d: int = 2,
                       dtype=torch.complex64, device="cuda",
                       rng: np.random.Generator | int | None = None) -> MPS:
    """Product state with an independent Haar-random local unit vector per
    site (complex Gaussian, normalized), drawn from ``rng`` (a numpy
    Generator or seed; a fresh default_rng when None).  Unlike a random
    basis state it has weight in every symmetry sector."""
    gen = rng if isinstance(rng, np.random.Generator) else np.random.default_rng(rng)
    v = gen.normal(size=(n_sites, d)) + 1j * gen.normal(size=(n_sites, d))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    tensors = [v[i].reshape(1, d, 1) for i in range(n_sites)]
    lams = [np.ones(1)] * (n_sites + 1)
    return from_dense_tensors(tensors, lams, chi, dtype=dtype, device=device)


def from_dense_tensors(tensors: list, lams: list, chi: int,
                       dtype=torch.complex64, device="cuda") -> MPS:
    """Padded MPS from dense per-site B tensors [chi_l, d, chi_r] and
    per-bond Schmidt vectors (host numpy)."""
    L, d = len(tensors), tensors[0].shape[1]
    B = np.zeros((L, chi, d, chi), dtype=np.complex128)
    lam = np.zeros((L + 1, chi))
    for i, T in enumerate(tensors):
        cl, _, cr = T.shape
        B[i, :cl, :, :cr] = T
    for i, s in enumerate(lams):
        lam[i, :len(s)] = s
    return MPS(B=torch.as_tensor(B).to(dtype=dtype, device=device),
               lam=torch.as_tensor(lam).to(dtype=dtype.to_real(), device=device))


def apply_sz(psi: MPS, site: int) -> MPS:
    """sigma^z at one site (diagonal unitary: B-form and Schmidt values are
    preserved)."""
    if psi.d != 2:
        raise ValueError(f"apply_sz requires local dimension d=2, got d={psi.d}")
    zdiag = torch.tensor([1.0, -1.0], dtype=psi.dtype, device=psi.device)
    B = psi.B.clone()
    B[..., site, :, :, :] = B[..., site, :, :, :] * zdiag[:, None]
    return MPS(B=B, lam=psi.lam)


def overlap(psi1: MPS, psi2: MPS) -> torch.Tensor:
    """<psi1|psi2> (complex, one per chain) by a left-to-right transfer
    contraction."""
    lead = torch.broadcast_shapes(psi1.lead, psi2.lead)
    E = psi2.B.new_zeros(lead + (psi1.chi, psi2.chi))
    E[..., 0, 0] = 1.0
    B1c = psi1.B.conj()
    for i in range(psi2.L):
        # E'[b,c] = sum_{a,p,b'} conj(B1[a,p,b]) E[a,b'] B2[b',p,c]
        T = torch.einsum("...ab,...bpc->...apc", E, psi2.B[..., i, :, :, :])
        E = torch.einsum("...apb,...apc->...bc", B1c[..., i, :, :, :], T)
    return E[..., 0, 0]


def norm_squared(psi: MPS) -> torch.Tensor:
    """<psi|psi> (real), one per chain."""
    return overlap(psi, psi).real


def expectation_one_site(psi: MPS, op: torch.Tensor) -> torch.Tensor:
    """<psi| op_i |psi> for every site, [..., L] complex.  The left
    environment at site i is diag(lam[i]^2), the right one the identity
    (right canonicity)."""
    w = (psi.lam[..., :-1, :] ** 2).to(psi.dtype)            # [..., L, chi]
    T = torch.einsum("pq,...laqb->...lapb", op, psi.B)
    T2 = torch.einsum("...lapb,...lapb->...la", psi.B.conj(), T)
    return (T2 * w).sum(-1)


def entanglement_entropy(psi: MPS, eps: float = 1e-30) -> torch.Tensor:
    """Von Neumann entropy at every bond from the Schmidt values, [..., L+1]."""
    p = psi.lam ** 2
    return -torch.where(p > eps, p * torch.log(p + eps),
                        torch.zeros_like(p)).sum(-1)


def entanglement_spectrum(psi: MPS, cut: int) -> torch.Tensor:
    """Schmidt values at bond ``cut``, [..., chi]."""
    return psi.lam[..., cut, :]


def bond_dimensions(psi: MPS, tol: float = 1e-14) -> torch.Tensor:
    """Effective bond dimension per bond: count of lam > tol, [..., L+1]."""
    return (psi.lam > tol).sum(-1)


def max_bond_dimension(psi: MPS, tol: float = 1e-14) -> torch.Tensor:
    """Largest effective inner bond dimension (at least 1), [...]."""
    inner = bond_dimensions(psi, tol)[..., 1:-1]
    if inner.shape[-1] == 0:
        return torch.ones(psi.lead, dtype=inner.dtype, device=inner.device)
    return inner.amax(-1).clamp_min(1)


def to_statevector(psi: MPS) -> np.ndarray:
    """Dense complex statevector [d**L] on the host; small single chains
    only (tests)."""
    if psi.lead:
        raise ValueError("to_statevector takes a single chain")
    B = psi.B.detach().cpu().numpy()
    vec = np.zeros((1, psi.chi), dtype=complex)
    vec[0, 0] = 1.0
    for i in range(psi.L):
        vec = np.einsum("na,apb->npb", vec, B[i]).reshape(-1, psi.chi)
    return vec[:, 0]


def apply_one_site_gates(psi: MPS, gates: torch.Tensor) -> MPS:
    """Apply a single-site gate per site: ``gates`` [d, d] (one gate for
    every site and chain) or [..., L, d, d]."""
    if gates.dim() == 2:
        B = torch.einsum("pq,...laqb->...lapb", gates, psi.B)
    else:
        B = torch.einsum("...lpq,...laqb->...lapb", gates, psi.B)
    return MPS(B=B, lam=psi.lam)


class HostStates:
    """A state history kept on the host: ``append`` holds device states
    until ``chunk`` of them are pending, then moves them in one stacked
    copy, so a long history never piles up on the card.  ``chunk`` None
    sizes it from the first state so pending states stay under 256 MiB
    (at most 32)."""

    def __init__(self, chunk: int | None = None):
        self.chunk = chunk
        self._pending: list = []
        self._host: list = []

    def append(self, psi: MPS) -> None:
        if self.chunk is None:
            nbytes = (psi.B.numel() * psi.B.element_size()
                      + psi.lam.numel() * psi.lam.element_size())
            self.chunk = int(max(1, min(32, (256 * 2**20) // max(nbytes, 1))))
        self._pending.append(psi)
        if len(self._pending) >= self.chunk:
            self.flush()

    def flush(self) -> None:
        if self._pending:
            self._host.append(MPS(
                B=torch.stack([p.B for p in self._pending]).cpu(),
                lam=torch.stack([p.lam for p in self._pending]).cpu()))
            self._pending = []

    def stacked(self) -> MPS:
        """Every state so far as one host MPS with a leading history axis
        (None before the first state)."""
        self.flush()
        if not self._host:
            return None
        return MPS(B=torch.cat([h.B for h in self._host]),
                   lam=torch.cat([h.lam for h in self._host]))

    def states(self) -> list:
        """Every state so far, as a list of host MPS."""
        s = self.stacked()
        if s is None:
            return []
        return [MPS(B=s.B[i], lam=s.lam[i]) for i in range(s.B.shape[0])]

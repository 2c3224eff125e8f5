"""Site-sharded TEBD: one chain split over the ranks of a process group.

Port of ``timecrystal_tpu/parallel/site_shard.py``.  Rank r owns the
L/world consecutive sites [r L/world, (r+1) L/world), an even count, on its
device.  With an even block every bond between two ranks has odd global
parity, so

  * even sweeps are local (one batched bond update per rank);
  * odd sweeps are the local odd bonds plus one boundary bond per pair of
    neighbouring ranks: the right neighbour's first site tensor is sent
    left, the bond updates there (``core.truncate.bond_update_core``), and
    the updated tensor and the new Schmidt values are sent back.

Per-site observables are local (B form: the left environment is
diag(lam^2)); the Loschmidt echo's [chi, chi] transfer environment is
relayed rank to rank in chain order.  The traces of every rank travel once,
after the last period, in one all-gather.  With Gloo the point-to-point
tensors are staged through host copies; with NCCL device tensors are sent.
Complex tensors travel as their real views.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core import gates as G
from ..core.mps import MPS, expectation_one_site
from ..core.truncate import TruncParams, apply_bond_gates, bond_update_core
from ..models.kicked_ising import FloquetGates, _apply_kick, _square_diagonal_gates
from .multihost import gather, global_mesh
from .sweep import BatchMesh


class _Link:
    """Point-to-point messages between neighbouring ranks."""

    def __init__(self, mesh: BatchMesh, device: torch.device):
        self.rank, self.world = mesh.rank, mesh.world
        self.device = device
        self.host = mesh.backend != "nccl"

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        t = torch.view_as_real(t) if t.is_complex() else t
        return t.contiguous().cpu() if self.host else t.contiguous()

    def exchange(self, send: dict, recv: dict) -> dict:
        """Post every receive ({name: (src, like)}) and send ({name: (dst,
        tensor)}), wait for all; the received tensors on this rank's
        device, shaped and typed like ``like``."""
        bufs, works, sent = {}, [], []
        for k, (src, like) in recv.items():
            bufs[k] = torch.empty_like(self._wire(like))
            works.append(dist.irecv(bufs[k], src))
        for dst, t in send.values():
            sent.append(self._wire(t))       # alive until the waits below
            works.append(dist.isend(sent[-1], dst))
        for w in works:
            w.wait()
        out = {}
        for k, (_, like) in recv.items():
            b = bufs[k].to(self.device)
            out[k] = torch.view_as_complex(b) if like.is_complex() else b
        return out


def _sweep(B, lam, gates, start: int, tp: TruncParams, link: _Link | None):
    """One parity sweep over this rank's block: the local bonds, then for
    start=1 the boundary bond with the right neighbour.  ``lam`` carries a
    dummy last row that no local bond reads.  Returns (B, lam, disc)."""
    psi, disc = apply_bond_gates(MPS(B=B, lam=lam), gates, start, tp)
    B, lam = psi.B, psi.lam
    if start != 1 or link is None:
        return B, lam, disc
    r, W = link.rank, link.world
    recv = {"nbr": (r + 1, B[0])} if r < W - 1 else {}
    send = {"first": (r - 1, B[0])} if r > 0 else {}
    got = link.exchange(send, recv)
    send, recv = {}, {}
    if r < W - 1:
        Bl, Br, S, e = bond_update_core(B[-1], got["nbr"], lam[-2],
                                        gates[-1], tp)
        B = B.clone()
        B[-1] = Bl
        disc = disc + e.to(disc.dtype)
        send = {"B": (r + 1, Br), "S": (r + 1, S.to(lam.dtype))}
    if r > 0:
        recv = {"B": (r - 1, B[0]), "S": (r - 1, lam[0])}
    got = link.exchange(send, recv)
    if r > 0:
        B = B.clone()
        B[0] = got["B"]
        lam = lam.clone()
        lam[0] = got["S"]
    return B, lam, disc


def _overlap_relay(B1, B2, link: _Link | None):
    """<psi1|psi2> of two site-sharded states: the [chi, chi] environment
    enters from the left neighbour, takes this rank's transfer maps in
    chain order (``core.mps.overlap``'s contraction) and leaves to the
    right one.  The value is valid on the last rank only."""
    E = B2.new_zeros((B1.shape[-3], B2.shape[-3]))
    if link is not None and link.rank > 0:
        E = link.exchange({}, {"E": (link.rank - 1, E)})["E"]
    else:
        E[0, 0] = 1.0
    B1c = B1.conj()
    for i in range(B2.shape[0]):
        T = torch.einsum("...ab,...bpc->...apc", E, B2[i])
        E = torch.einsum("...apb,...apc->...bc", B1c[i], T)
    if link is not None and link.rank < link.world - 1:
        link.exchange({"E": (link.rank + 1, E)}, {})
    return E[0, 0]


def evolve_floquet_sharded(psi0: MPS, gates: FloquetGates, n_periods: int,
                           tp: TruncParams, mesh: BatchMesh | None = None,
                           frame: str = "strict", device="cuda"):
    """Site-sharded Floquet evolution of one chain: every rank calls it with
    the same full ``psi0`` and ``gates`` and evolves its block of sites on
    its device (``mesh`` defaults to ``global_mesh(device)``; one device a
    rank).  L must split into equal even blocks over the ranks; periodic
    chains are refused.  ``frame='merged'`` evolves phi = H psi as
    ``dynamics.tebd.evolve_floquet_scan`` does and maps the state back.

    Returns ((B, lam) of this rank's block, traces) with host numpy traces,
    the same on every rank: sz_sites [n, L], loschmidt_echo [n] (against
    psi0), trunc_err [n] (summed over all bonds) and trunc_err_boundary
    (the merged frame's entry and exit; 0 in the strict frame)."""
    mesh = mesh or global_mesh(device)
    if len(mesh.devices) != 1:
        raise ValueError("evolve_floquet_sharded takes one device a rank")
    if psi0.lead:
        raise ValueError("evolve_floquet_sharded evolves one chain")
    if gates.boundary_gate is not None:
        raise NotImplementedError(
            "evolve_floquet_sharded does not support periodic boundary "
            "conditions; use the single-device drivers (CustomFloquet / "
            "evolve_floquet_scan route bc='periodic' via the swap network)")
    L, W, r = psi0.L, mesh.world, mesh.rank
    if L % W != 0 or (L // W) % 2 != 0:
        raise ValueError(f"L={L} must split into even-length blocks over "
                         f"{W} ranks")
    if frame not in ("strict", "merged"):
        raise ValueError(f"unknown frame: {frame!r} (use 'strict' or "
                         "'merged')")
    dev = mesh.devices[0]
    link = _Link(mesh, dev) if W > 1 else None
    n = L // W
    blk = slice(r * n, (r + 1) * n)
    d = psi0.d
    eye = torch.eye(d, dtype=psi0.dtype, device=dev)
    # one gate row a site: the last site's row is the boundary bond's, and
    # the chain's last row an identity that is never applied
    g = torch.cat([gates.bond_gates.to(dev),
                   torch.einsum("pr,qs->pqrs", eye, eye)[None]])[blk]
    kick = gates.kick.to(dev)
    B = psi0.B[blk].to(dev)
    lam = torch.cat([psi0.lam[blk], psi0.lam.new_zeros((1, psi0.chi))]).to(dev)
    sz_op = G.pauli_c("z", psi0.dtype, dev)
    merged = frame == "merged"
    e_bnd = lam.new_zeros(())

    def half(B, lam, gg):
        B, lam, e1 = _sweep(B, lam, gg, 0, tp, link)
        B, lam, e2 = _sweep(B, lam, gg, 1, tp, link)
        return B, lam, e1 + e2

    if merged:
        B, lam, e_bnd = half(B, lam, g)
    B0 = B
    g_sq = _square_diagonal_gates(g)
    sz, le, err = [], [], []
    for _ in range(n_periods):
        if merged:
            B = _apply_kick(MPS(B=B, lam=lam), kick).B
            B, lam, e = half(B, lam, g_sq)
        else:
            B, lam, e = half(B, lam, g)
            B = _apply_kick(MPS(B=B, lam=lam), kick).B
            B, lam, e2 = half(B, lam, g)
            e = e + e2
        sz.append(expectation_one_site(MPS(B=B, lam=lam), sz_op).real)
        ov = _overlap_relay(B0, B, link)
        le.append(ov.real * ov.real + ov.imag * ov.imag)
        err.append(e)
    if merged:
        B, lam, e = half(B, lam, g.conj())
        e_bnd = e_bnd + e

    def stack(xs, shape):
        return (torch.stack(xs) if xs else lam.new_zeros(shape)).cpu().numpy()

    tr = gather({"sz": stack(sz, (0, n))[None], "le": stack(le, (0,))[None],
                 "err": stack(err, (0,))[None],
                 "bnd": e_bnd.reshape(1).cpu().numpy()})
    traces = {"sz_sites": np.concatenate(list(tr["sz"]), axis=-1),
              "loschmidt_echo": tr["le"][-1],
              "trunc_err": tr["err"].sum(axis=0),
              "trunc_err_boundary": float(tr["bnd"].sum())}
    return (B, lam[:-1]), traces

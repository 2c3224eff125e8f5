"""Scale-out of ensemble and phase-grid sweeps over ``torch.distributed``.

Port of ``timecrystal_tpu/parallel/multihost.py``.  The workload is
independent per realization, so every process (rank) runs the SAME call:
the batch is padded to a multiple of the global device count, each rank
evolves its block of rows on its own device(s), and the only traffic
between ranks is one all-gather of the host traces at the end, after which
every rank holds the full batch.

The backend is the caller's choice, never a silent one: 'nccl' for one GPU
per rank; 'gloo' for CPU ranks, and for ranks that share one GPU (NCCL
refuses two ranks on one device).  Gloo collectives run on host tensors, so
the traces are gathered from the host either way.

    from timecrystal_tpu_torch.parallel import multihost as mh
    mh.initialize("gloo", "tcp://localhost:29511", world_size=2, rank=r)
    traces = mh.evolve_batch_multihost(h_fields, taus, basis, spec)
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .sweep import BatchMesh, SweepSpec, _basis_indices, _evolve_rows

BACKENDS = ("gloo", "nccl")


def initialize(backend: str, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               timeout_s: float = 600.0) -> None:
    """Join the process group of a multi-process run.

    ``world_size`` and ``rank`` default to $WORLD_SIZE and $RANK, and
    ``init_method`` to 'env://' ($MASTER_ADDR / $MASTER_PORT); pass
    'tcp://host:port' to name the rendezvous directly.  Nothing happens for
    a world of one process or when the group already exists.  With 'nccl'
    the rank's current CUDA device is set to ``rank % device_count``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}: {backend!r}")
    if dist.is_initialized():
        return
    world_size = int(world_size if world_size is not None
                     else os.environ.get("WORLD_SIZE", 1))
    if world_size == 1:
        return
    rank = int(rank if rank is not None else os.environ["RANK"])
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))


def process_count() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(device="cuda") -> BatchMesh:
    """This rank's ``BatchMesh``: one device, this rank of the process
    group's world.  ``device`` 'cuda' takes cuda:(rank % device_count), so
    ranks on one card share it; 'cpu' (or an indexed device) as named."""
    world, rank, backend = 1, 0, None
    if dist.is_initialized():
        world, rank, backend = dist.get_world_size(), dist.get_rank(), \
            dist.get_backend()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("global_mesh: no CUDA device")
        dev = torch.device("cuda", rank % n)
    return BatchMesh((dev,), rank, world, backend)


def gather(tree: dict) -> dict:
    """Host arrays [rows, ...] of every rank -> the arrays of all ranks
    joined on the row axis, in rank order, on every rank.  Every rank
    passes the same keys, shapes and dtypes (equal shards); the arrays
    travel as one byte buffer in ONE all-gather (on the host for Gloo, on
    the rank's device for NCCL).  The tree as given without a group."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return tree
    keys = sorted(tree)
    arrs = [np.ascontiguousarray(tree[k]) for k in keys]
    flat = np.concatenate([a.reshape(-1).view(np.uint8) for a in arrs])
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    buf = torch.from_numpy(flat).to(dev)
    bufs = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
    dist.all_gather(bufs, buf)
    parts = [b.cpu().numpy() for b in bufs]
    out, off = {}, 0
    for k, a in zip(keys, arrs):
        out[k] = np.concatenate([p[off:off + a.nbytes].view(a.dtype)
                                 .reshape(a.shape) for p in parts])
        off += a.nbytes
    return out


def evolve_batch_multihost(h_fields, taus, basis_indices, spec: SweepSpec,
                           mesh: BatchMesh | None = None,
                           axis_name: str = "batch",
                           correlation_site: int | None = None,
                           two_time_anchor: int | None = None, thetas=None,
                           device="cuda") -> dict:
    """Fixed-chi batched Floquet evolution over every rank's devices
    (``parallel.sweep.evolve_batch_sharded`` across processes): every rank
    passes the same arguments, evolves its block of the padded batch, and
    returns the FULL host traces [R, n_periods+1, ...] after one
    all-gather.  ``mesh`` defaults to ``global_mesh(device)``; ``thetas``
    [R] are per-realization kick angles (the drive-strength axis)."""
    mesh = mesh or global_mesh(device)
    return _evolve_rows(h_fields, taus, basis_indices, spec, mesh,
                        correlation_site, two_time_anchor, thetas)


def disorder_ensemble_multihost(generator: torch.Generator,
                                n_realizations: int, spec: SweepSpec,
                                h_disorder: float, tau: float,
                                state_type: str = "neel",
                                mesh: BatchMesh | None = None,
                                device="cuda") -> dict:
    """``parallel.sweep.disorder_ensemble`` (fixed chi) over every rank: the
    fields come from ``generator``, seeded alike on every rank, so the
    ranks draw the same batch without communicating."""
    from ..models.kicked_ising import draw_disorder_batch

    h = draw_disorder_batch(generator, n_realizations, spec.L, h_disorder)
    return evolve_batch_multihost(h, np.full(n_realizations, tau),
                                  _basis_indices(spec.L, state_type), spec,
                                  mesh=mesh, device=device)

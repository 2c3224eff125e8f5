"""Batched disorder ensembles and phase-diagram grids.

Port of ``timecrystal_tpu/parallel/sweep.py``: the fixed-chi ensemble
(``evolve_batch``, ``disorder_ensemble``, ``phase_grid_batch``,
``ensemble_a2t``) and the chi-staged one (``evolve_batch_auto``).  The JAX
version ``vmap``s whole evolutions over the realization axis; here that
axis R is the MPS's leading batch axis, and ``core.truncate`` folds it into
the bond axis, so one SVD call takes R * n_bonds matrices (1800 on the
phase diagram's 120-point grid at L=16).

Scale-out of the batch axis: a ``BatchMesh`` names the devices that share
it -- this process's devices and, under ``torch.distributed``, this rank of
the world (``parallel.multihost``).  The batch is padded to a multiple of
the mesh's device count with copies of realization 0, every device evolves
its shard independently, and the host traces are joined (across ranks, one
all-gather) with the padding dropped.  Each shard's Jacobi SVD calls run
their own batch-max sweep exit (no collective per sweep), so on the card a
sharded run differs from an unsharded one at the float32 class (up to ~3e-5
sigma_max at tol 1e-6); on the CPU, where 'native' LAPACK runs, the two are
equal bit for bit.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core.mps import MPS, pad_mps, product_state
from ..core.observables import (add_derived_magnetization,
                                extract_subharmonic_amplitude)
from ..core.truncate import PROJECTED_SVD_METHODS, TruncParams
from ..dynamics.tebd import (_next_chi, _stage_decision, _stage_err_tol,
                             _trace_keys, evolve_floquet_scan, to_host)
from ..models.kicked_ising import draw_disorder_batch, make_floquet_gates
from ..ops.fft import batched_subharmonic_amplitude


@dataclass(frozen=True)
class BatchMesh:
    """The devices that share the batch axis: ``devices`` of this process
    and, under ``torch.distributed``, this ``rank`` of ``world`` processes
    (each holding as many devices; every rank makes the same call).
    ``backend`` is the process group's ('gloo' or 'nccl'), None alone."""

    devices: tuple
    rank: int = 0
    world: int = 1
    backend: str | None = None

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a BatchMesh needs at least one device")
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))

    @property
    def size(self) -> int:
        """Devices on the batch axis over every rank."""
        return self.world * len(self.devices)


def default_mesh(device="cuda") -> BatchMesh:
    """A mesh over the local CUDA devices (``device`` 'cuda'), or over the
    one ``device`` named."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("default_mesh: no CUDA device")
        return BatchMesh(tuple(torch.device("cuda", i) for i in range(n)))
    return BatchMesh((dev,))


def resolve_mesh(mesh, device):
    """A ``mesh`` argument: 'auto' is ``default_mesh()`` when ``device`` is
    CUDA and there are several CUDA devices, else None (one device);
    anything else as given."""
    if not (isinstance(mesh, str) and mesh == "auto"):
        return mesh
    if torch.device(device).type == "cuda" and torch.cuda.device_count() > 1:
        return default_mesh()
    return None


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _pad_rows(x: np.ndarray, rows: int) -> np.ndarray:
    """``x`` [R, ...] padded to ``rows`` rows with copies of row 0."""
    pad = rows - x.shape[0]
    return x if pad == 0 else np.concatenate(
        [x, np.repeat(x[:1], pad, axis=0)])


def _local_rows(mesh: BatchMesh, R: int):
    """(padded global row count, [(device, lo, hi)] of this process's
    shards): R padded to a multiple of the mesh size, rank r owning the
    r-th equal block, split evenly over its devices."""
    per = -(-R // mesh.size)
    lo0 = mesh.rank * per * len(mesh.devices)
    return per * mesh.size, [(d, lo0 + j * per, lo0 + (j + 1) * per)
                             for j, d in enumerate(mesh.devices)]


def _map_devices(fn, args: list, devices: list) -> list:
    """[fn(a, d)]: one thread a device when several CUDA devices share the
    work (each enqueues on its own device), in order otherwise."""
    if len(set(devices)) > 1 and all(d.type == "cuda" for d in devices):
        with ThreadPoolExecutor(len(devices)) as ex:
            return list(ex.map(fn, args, devices))
    return [fn(a, d) for a, d in zip(args, devices)]


def _join_ranks(tree: dict, mesh: BatchMesh | None) -> dict:
    """Host arrays [local rows, ...] of every rank joined on the row axis
    (one all-gather); as given without other ranks."""
    if mesh is None or mesh.world == 1:
        return tree
    from .multihost import gather

    return gather(tree)


def map_rows(fn, rows: dict, mesh: BatchMesh) -> dict:
    """The host traces of ``fn`` over the rows of ``rows`` (host arrays
    [R, ...] of equal R) sharded over ``mesh``: the rows padded with copies
    of row 0 to a multiple of the mesh size, each local shard evaluated as
    ``fn({name: part}, device)`` (host numpy arrays [shard, ...] back), the
    shards and ranks joined and the padding dropped."""
    R = len(next(iter(rows.values())))
    R_pad, shards = _local_rows(mesh, R)
    padded = {k: _pad_rows(np.asarray(v), R_pad) for k, v in rows.items()}
    parts = _map_devices(fn, [{k: v[lo:hi] for k, v in padded.items()}
                              for _, lo, hi in shards],
                         [d for d, _, _ in shards])
    out = _join_ranks({k: np.concatenate([p[k] for p in parts])
                       for k in parts[0]}, mesh)
    return {k: v[:R] for k, v in out.items()}


class SweepSpec(NamedTuple):
    """Static configuration of a batched Floquet evolution."""

    L: int
    chi: int
    n_periods: int
    J: float = 1.0
    theta: float = float(np.pi)
    tp: TruncParams = TruncParams.reference_hot_path()
    dtype: str = "float32"   # 'float32' (complex64) | 'float64' (complex128)
    frame: str = "strict"    # 'strict' | 'merged' (see tebd.evolve_floquet_scan)


def _basis_indices(L: int, state_type: str) -> np.ndarray:
    if state_type == "neel":
        return np.array([0 if i % 2 == 0 else 1 for i in range(L)], np.int32)
    if state_type == "all_up":
        return np.zeros(L, np.int32)
    if state_type == "all_down":
        return np.ones(L, np.int32)
    raise ValueError(f"Unknown state type for sweeps: {state_type}")


def _with_initial_row(cat: dict, basis: np.ndarray,
                      correlation_site: int | None = None,
                      two_time_anchor: int | None = None) -> dict:
    """The ensemble traces [R, n_periods+1, ...] from the per-period host
    traces ``cat`` [R, n_periods, ...] (``tebd._trace_keys``): the t=0 row
    of the product state ``basis`` prepended (sz = 1 - 2 basis, LE and
    max_chi 1, entropy and trunc_err 0, zz_corr s_i s_j, zz2t_re the same
    equal-time profile at the anchor and zz2t_im 0), the mid-chain entropy
    kept, and the magnetizations derived."""
    R, _, L = cat["sz_sites"].shape
    sz0 = np.broadcast_to((1.0 - 2.0 * basis).astype(cat["sz_sites"].dtype),
                          (R, L))

    def first(k, value):
        return np.concatenate([np.full((R, 1), value, cat[k].dtype), cat[k]],
                              axis=1)

    traces = {
        "sz_sites": np.concatenate([sz0[:, None, :], cat["sz_sites"]], axis=1),
        "loschmidt_echo": first("loschmidt_echo", 1),
        "max_chi": first("max_chi", 1),
        "entropy_mid": np.concatenate(
            [np.zeros((R, 1), cat["entropies"].dtype),
             cat["entropies"][:, :, L // 2]], axis=1),
        "trunc_err": first("trunc_err", 0),
    }
    def profile(i, dtype):
        # zz_correlation_profile of the product state: s_i s_j, exactly 1
        # at j == i (s = 1 - 2 basis)
        s = (1.0 - 2.0 * basis).astype(dtype)
        zz0 = s[i] * s
        zz0[i] = 1.0
        return np.broadcast_to(zz0, (R, 1, L))

    if correlation_site is not None:
        traces["zz_corr"] = np.concatenate(
            [profile(correlation_site, cat["zz_corr"].dtype), cat["zz_corr"]],
            axis=1)
    if two_time_anchor is not None:
        # at t=0 the two-time and equal-time profiles coincide (real)
        dt = cat["zz2t_re"].dtype
        traces["zz2t_re"] = np.concatenate(
            [profile(two_time_anchor, dt), cat["zz2t_re"]], axis=1)
        traces["zz2t_im"] = np.concatenate(
            [np.zeros((R, 1, L), dt), cat["zz2t_im"]], axis=1)
    return add_derived_magnetization(traces, L)


def _stage_tp(tp: TruncParams, device: torch.device) -> TruncParams:
    """svd_method of the batched evolutions: 'auto' is pinned to the Jacobi
    kernel on a CUDA device.  The staged escalation criteria read
    truncation error and significant-rank occupancy off the SVD output, so
    the SVD must have the Jacobi noise floor (junk sigmas of a noisier SVD
    force spurious escalation).  On the CPU 'auto' stays (-> 'native'),
    as in the JAX package.  The fixed-chi ``evolve_batch`` takes the same
    rule: the JAX package's batch-size routing there (``_resolve_svd_method``)
    guards the TPU worker's Gram/eigh faults and has no counterpart here."""
    if tp.svd_method != "auto" or torch.device(device).type == "cpu":
        return tp
    return tp._replace(svd_method="jacobi")


def _working_dtypes(spec: SweepSpec):
    cdtype = torch.complex64 if spec.dtype == "float32" else torch.complex128
    return cdtype, cdtype.to_real()


def evolve_batch(h_fields, taus, basis_indices, spec: SweepSpec,
                 correlation_site: int | None = None,
                 two_time_anchor: int | None = None, thetas=None,
                 device="cuda") -> dict:
    """Fixed-chi Floquet evolution of a batch of realizations (the phase
    diagram's path): every realization padded at ``spec.chi`` for all
    ``spec.n_periods`` periods, in ``spec.frame``.

    ``h_fields`` [R, L], ``taus`` [R] and ``thetas`` [R] (numpy or
    tensors; ``thetas`` optional) are cast to the spec's real dtype on
    ``device``.  ``thetas`` gives each realization its own kick angle (the
    drive-strength axis, pulse imperfection eps = 1 - theta/pi) and
    overrides ``spec.theta``.  svd_method 'auto' is 'jacobi' on a CUDA
    device and 'native' on the CPU (``_stage_tp``).

    Returns host numpy traces [R, n_periods+1, ...] with the t=0 row:
    sz_sites, loschmidt_echo, max_chi, entropy_mid, trunc_err,
    magnetization, staggered_magnetization; with ``correlation_site=i``
    also zz_corr [R, n_periods+1, L], the <sz_i sz_j> profile of every
    period; with ``two_time_anchor=i`` also zz2t_re / zz2t_im [R,
    n_periods+1, L], the two-time correlator <sz_i(0) sz_j(t)>: sz_i psi0
    evolves beside psi0 on one leading axis (one SVD call serves both, 2x
    the matrices), and every other trace, trunc_err included, is psi's."""
    device = torch.device(device)
    cdtype, rdtype = _working_dtypes(spec)
    h = torch.as_tensor(h_fields, dtype=rdtype, device=device)
    R, L = h.shape
    basis = np.asarray(basis_indices)
    theta = (spec.theta if thetas is None
             else torch.as_tensor(thetas, dtype=rdtype, device=device))
    gates = make_floquet_gates(
        spec.J, h, torch.as_tensor(taus, dtype=rdtype, device=device),
        theta=theta, dtype=cdtype)
    psi0 = product_state(np.broadcast_to(basis, (R, L)), chi=spec.chi,
                         dtype=cdtype, device=device)
    _, tr = evolve_floquet_scan(psi0, gates, spec.n_periods,
                                _stage_tp(spec.tp, device), frame=spec.frame,
                                correlation_site=correlation_site,
                                two_time_anchor=two_time_anchor)
    keys = _trace_keys(correlation_site, two_time_anchor is not None)
    return _with_initial_row(to_host({k: tr[k] for k in keys}), basis,
                             correlation_site, two_time_anchor)


def evolve_batch_auto(h_fields, taus, basis_indices, spec: SweepSpec,
                      chi_start: int = 32, chunk_periods: int = 5,
                      checkpoint_dir: str | None = None,
                      mesh: BatchMesh | None = None,
                      axis_name: str = "batch", growth: float = 2.0,
                      cap_svd_method: str | None = None,
                      correlation_site: int | None = None,
                      device="cuda"):
    """Chi-staged batched Floquet evolution: the ensemble production path.

    All realizations share ONE chi schedule.  Evolution starts padded at
    ``chi_start`` and proceeds in chunks; when any realization truncates
    real weight the chunk re-runs from the (exact) pre-chunk state at the
    next ladder chi, and at 15/16 significant occupancy the schedule grows
    ahead without a re-run (dynamics.tebd._stage_decision).

    ``cap_svd_method``: the svd_method of chunks AT the ladder cap, where
    truncation error no longer drives escalation (a projected method,
    ``core.truncate.PROJECTED_SVD_METHODS``: the saturated steady leg).
    Below the cap a projected method is replaced by 'jacobi'.

    ``correlation_site=i`` adds ``zz_corr [R, n_periods+1, L]``.

    ``checkpoint_dir``: after each kept chunk its traces
    (``batch_auto_chunks/chunk_NNNNN.npz``) and then the state
    (``batch_auto_state.npz``, with the schedule and a fingerprint of the
    fields, taus, basis, spec, ladder and mesh layout) are written there; a
    later call with the same arguments resumes after the last chunk on
    disk, to a shorter or longer ``n_periods``.  Another fingerprint
    raises.  (The JAX package also reads its older single-file trace
    layout; the port never wrote it.)

    ``mesh`` (a ``BatchMesh``): the batch is padded to a multiple of the
    mesh size with copies of realization 0 and sharded; every shard
    evolves its chunk on its device, the chunk's decision data of every
    shard and rank are joined on the host, so the schedule is the same
    everywhere, and every rank returns the full traces (the padding
    dropped).  Under ``torch.distributed`` each rank checkpoints its own
    rows under ``checkpoint_dir/rank_NNNN``; a resume needs the same
    layout.  ``axis_name`` is the JAX package's and is ignored.

    ``h_fields`` [R, L] and ``taus`` [R] (numpy or tensors) are cast to the
    spec's real dtype on ``device`` (or the mesh's devices).  Returns
    (traces, info): host numpy traces [R, n_periods+1, ...] (t=0 row
    prepended) and info with wall_time, chain_periods_per_second,
    chi_pad_used, chi_escalations, n_rerun_periods.

    The JAX version floors chi at 16 on the TPU, because n = 2 chi < 32
    routes to the Gram/eigh SVD there; this port sends every even n to the
    Jacobi kernel, so it has no floor.
    """
    cdtype, rdtype = _working_dtypes(spec)
    err_tol = _stage_err_tol(cdtype, spec.tp.svd_min, spec.L - 1)
    h_np, taus_np = _host(h_fields), _host(taus)
    basis = np.asarray(basis_indices)
    R_out, L = h_np.shape
    if mesh is None:
        R, shards = R_out, [(torch.device(device), 0, R_out)]
    else:
        R, shards = _local_rows(mesh, R_out)
    devices = [d for d, _, _ in shards]
    h_pad, taus_pad = _pad_rows(h_np, R), _pad_rows(taus_np, R)
    cap = min(spec.chi, spec.tp.chi_max) if spec.tp.chi_max else spec.chi
    chi = min(chi_start, cap)
    n_periods = spec.n_periods
    keys = _trace_keys(correlation_site)

    start = time.perf_counter()
    gates = [make_floquet_gates(
        spec.J, torch.as_tensor(h_pad[lo:hi], dtype=rdtype, device=d),
        torch.as_tensor(taus_pad[lo:hi], dtype=rdtype, device=d),
        theta=spec.theta, dtype=cdtype) for d, lo, hi in shards]

    def fresh(c):
        return [product_state(np.broadcast_to(basis, (hi - lo, L)), chi=c,
                              dtype=cdtype, device=d) for d, lo, hi in shards]

    def pad_all(states, c):
        return [pad_mps(p, c) for p in states]

    psi = fresh(chi)
    psi0 = psi
    p_done, n_rerun = 0, 0
    escalations: list = []
    chunks: list = []

    wall_prev = 0.0
    if checkpoint_dir is not None:
        from ..utils.checkpoint import (atomic_savez, fingerprint, load_state,
                                        save_state, state_exists)
        if mesh is not None and mesh.world > 1:
            checkpoint_dir = os.path.join(checkpoint_dir,
                                          f"rank_{mesh.rank:04d}")
        ck_state = os.path.join(checkpoint_dir, "batch_auto_state")
        ck_chunks = os.path.join(checkpoint_dir, "batch_auto_chunks")

        def chunk_path(i):
            return os.path.join(ck_chunks, f"chunk_{i:05d}.npz")

        fp = fingerprint(
            spec._replace(n_periods=0), np.round(h_np, 12).tolist(),
            np.round(taus_np, 12).tolist(), basis.tolist(), chi_start, growth,
            chunk_periods, cap_svd_method, correlation_site,
            None if mesh is None else (mesh.world, mesh.rank, mesh.size))
        if state_exists(ck_state):
            state, meta = load_state(ck_state, device="cpu", dtype=cdtype)
            if meta.get("fingerprint") != fp:
                raise ValueError(
                    f"checkpoint at {checkpoint_dir} was written by a run "
                    "with different parameters (fields/taus/spec/ladder/"
                    "mesh); refusing to resume -- delete it or point "
                    "elsewhere")
            off = shards[0][1]
            psi = [MPS(B=state.B[lo - off:hi - off].to(d),
                       lam=state.lam[lo - off:hi - off].to(d))
                   for d, lo, hi in shards]
            p_done, chi = int(meta["p_done"]), int(meta["chi"])
            escalations = list(meta["escalations"])
            n_rerun = int(meta["n_rerun"])
            wall_prev = float(meta["wall_time"])
            psi0 = fresh(chi)
            # chunk files are written before the state: every chunk the
            # state counts is on disk (a later one is recomputed)
            chunks = []
            for i in range(int(meta["n_chunks"])):
                with np.load(chunk_path(i)) as z:
                    chunks.append({k: z[k] for k in keys})

    while p_done < n_periods:
        n = min(chunk_periods, n_periods - p_done)
        if cap_svd_method and chi >= cap:
            tp = spec.tp._replace(svd_method=cap_svd_method)
        else:
            tp = _stage_tp(spec.tp, devices[0])
            if chi < cap and tp.svd_method in PROJECTED_SVD_METHODS:
                # below the cap escalation reads trunc_err, which projected
                # methods report at the noise floor
                tp = tp._replace(svd_method="jacobi")

        def run(i, d, n=n, tp=tp):
            p, t = evolve_floquet_scan(psi[i], gates[i], n, tp,
                                       ref_state=psi0[i], frame=spec.frame,
                                       correlation_site=correlation_site)
            return p, dict(to_host(t), exit_lam=p.lam.cpu().numpy())

        outs = _map_devices(run, list(range(len(shards))), devices)
        psi_next = [p for p, _ in outs]
        tr = _join_ranks({k: np.concatenate([t[k] for _, t in outs])
                          for k in outs[0][1]}, mesh)
        exit_lam = tr.pop("exit_lam")
        # the batch shares one schedule: ANY realization's truncation
        # escalates all; the merged frame's entry/exit error is included
        errs = np.append(np.ravel(tr["trunc_err"]),
                         np.ravel(tr["trunc_err_boundary"]))
        saturated, ahead = _stage_decision(errs, exit_lam, chi, err_tol)
        if saturated and chi < cap:
            new_chi = _next_chi(chi, cap, growth)
            escalations.append({"period": p_done, "from": chi, "to": new_chi})
            n_rerun += n
            chi = new_chi
            psi = pad_all(psi, chi)
            psi0 = pad_all(psi0, chi)
            continue
        if ahead and chi < cap and p_done + n < n_periods:
            new_chi = _next_chi(chi, cap, growth)
            escalations.append({"period": p_done + n, "from": chi,
                                "to": new_chi, "ahead": True})
            chi = new_chi
            psi_next = pad_all(psi_next, chi)
            psi0 = pad_all(psi0, chi)
        psi = psi_next
        chunks.append({k: tr[k] for k in keys})
        p_done += n
        if checkpoint_dir is not None:
            atomic_savez(chunk_path(len(chunks) - 1), **chunks[-1])
            save_state(ck_state, MPS(B=torch.cat([p.B.cpu() for p in psi]),
                                     lam=torch.cat([p.lam.cpu() for p in psi])),
                       {"p_done": p_done, "chi": chi,
                        "escalations": escalations, "n_chunks": len(chunks),
                        "n_rerun": n_rerun,
                        "wall_time": wall_prev + time.perf_counter() - start,
                        "fingerprint": fp})

    wall_time = wall_prev + time.perf_counter() - start
    # the slice keeps [R, n_periods] when a resumed checkpoint holds more
    cat = {k: np.concatenate([c[k] for c in chunks], axis=1)[:, :n_periods]
           for k in keys}
    traces = _with_initial_row(cat, basis, correlation_site)
    traces = {k: v[:R_out] for k, v in traces.items()}
    info = {
        "wall_time": wall_time,
        "chain_periods_per_second": (R_out * n_periods / wall_time
                                     if wall_time > 0 else float("inf")),
        "chi_pad_used": chi,
        "chi_escalations": escalations,
        "n_rerun_periods": n_rerun,
    }
    return traces, info


def evolve_batch_sharded(h_fields, taus, basis_indices, spec: SweepSpec,
                         mesh: BatchMesh | None = None,
                         axis_name: str = "batch",
                         correlation_site: int | None = None,
                         two_time_anchor: int | None = None, thetas=None,
                         device="cuda") -> dict:
    """``evolve_batch`` with the realization batch sharded over ``mesh``
    (default: ``default_mesh(device)``, the local CUDA devices): padded to
    a multiple of the mesh size with copies of realization 0, each shard
    evolved by ``evolve_batch`` on its device, the host traces joined and
    the padding dropped.  A mesh of several ranks routes to
    ``multihost.evolve_batch_multihost`` (every rank returns the full
    traces).  ``axis_name`` is the JAX package's and is ignored."""
    mesh = mesh or default_mesh(device)
    if mesh.world > 1:
        from .multihost import evolve_batch_multihost

        return evolve_batch_multihost(
            h_fields, taus, basis_indices, spec, mesh=mesh,
            correlation_site=correlation_site,
            two_time_anchor=two_time_anchor, thetas=thetas)
    return _evolve_rows(h_fields, taus, basis_indices, spec, mesh,
                        correlation_site, two_time_anchor, thetas)


def _evolve_rows(h_fields, taus, basis_indices, spec, mesh, correlation_site,
                 two_time_anchor, thetas) -> dict:
    rows = {"h": _host(h_fields), "taus": _host(taus)}
    if thetas is not None:
        rows["thetas"] = _host(thetas)

    def shard(r, d):
        return evolve_batch(r["h"], r["taus"], basis_indices, spec,
                            correlation_site=correlation_site,
                            two_time_anchor=two_time_anchor,
                            thetas=r.get("thetas"), device=d)

    return map_rows(shard, rows, mesh)


def disorder_ensemble(generator: torch.Generator, n_realizations: int,
                      spec: SweepSpec, h_disorder: float, tau: float,
                      state_type: str = "neel", mesh=None, staged: bool = False,
                      chi_start: int = 32, chunk_periods: int = 5,
                      cap_svd_method: str | None = None,
                      correlation_site: int | None = None,
                      two_time_anchor: int | None = None,
                      device="cuda") -> dict:
    """Batched disorder ensemble: fields [R, L] ~ U[-h, h] drawn from
    ``generator`` (``draw_disorder_batch``; the JAX package draws them from
    a JAX key, so the two packages' fields differ), one ``tau`` for all,
    evolved by ``evolve_batch`` or, with ``staged=True``, by the chi-staged
    ``evolve_batch_auto`` (``chi_start``, ``chunk_periods``,
    ``cap_svd_method``), either with ``correlation_site``;
    ``two_time_anchor`` (``evolve_batch``'s) takes the fixed-chi path only.
    A ``mesh`` shards the batch (``evolve_batch_sharded``, or the staged
    evolution's ``mesh``).  Returns the traces dict of either."""
    if staged and two_time_anchor is not None:
        raise ValueError("two_time_anchor takes the fixed-chi ensemble "
                         "(staged=False)")
    h = draw_disorder_batch(generator, n_realizations, spec.L, h_disorder)
    taus = np.full(n_realizations, tau)
    basis = _basis_indices(spec.L, state_type)
    if staged:
        traces, _ = evolve_batch_auto(h, taus, basis, spec,
                                      chi_start=chi_start,
                                      chunk_periods=chunk_periods, mesh=mesh,
                                      cap_svd_method=cap_svd_method,
                                      correlation_site=correlation_site,
                                      device=device)
        return traces
    if mesh is not None:
        return evolve_batch_sharded(h, taus, basis, spec, mesh,
                                    correlation_site=correlation_site,
                                    two_time_anchor=two_time_anchor)
    return evolve_batch(h, taus, basis, spec,
                        correlation_site=correlation_site,
                        two_time_anchor=two_time_anchor, device=device)


def phase_grid_batch(h_over_J_values, T_J_values, spec: SweepSpec,
                     disorder_seed: int = 42):
    """Flatten a (h/J x T.J) grid into the batch (h_fields [P, L], taus
    [P], hs [P], Ts [P]) as host numpy, P = len(h) * len(T), h outer.

    The reference's per-point disorder exactly: np.random.seed(seed) then
    one MT19937 draw of a unit pattern, so every point's fields are
    h * J * pattern; tau = T.J / (2 J)."""
    np.random.seed(disorder_seed)
    base = np.random.uniform(-1.0, 1.0, spec.L)
    hs, Ts = np.meshgrid(np.asarray(h_over_J_values), np.asarray(T_J_values),
                         indexing="ij")
    hs, Ts = hs.ravel(), Ts.ravel()
    return hs[:, None] * spec.J * base[None, :], Ts / (2.0 * spec.J), hs, Ts


def ensemble_a2t(traces: dict, taus,
                 series_key: str = "staggered_magnetization",
                 device="cuda") -> np.ndarray:
    """A2T of every realization's ``traces[series_key]`` [R, n+1] (sampled
    every period 2 tau from t=0), for the whole batch in one device call
    (``ops.fft.batched_subharmonic_amplitude``).  Realizations whose trace
    is not finite come back NaN from the batch and are recomputed with the
    host recipe (``core.observables.extract_subharmonic_amplitude``), which
    drops the invalid samples.  Returns host numpy [R]."""
    series = torch.as_tensor(traces[series_key], device=device)
    R, n1 = series.shape
    taus_t = torch.as_tensor(taus, dtype=series.dtype, device=device)
    times = (torch.arange(n1, dtype=series.dtype, device=device)[None, :]
             * (2.0 * taus_t)[:, None])
    a2t = batched_subharmonic_amplitude(times, series, 2.0 * taus_t)
    a2t = a2t.cpu().numpy().copy()
    bad = np.flatnonzero(np.isnan(a2t))
    if bad.size:
        t_np, s_np = times.cpu().numpy(), series.cpu().numpy()
        tau_np = taus_t.cpu().numpy()
        for r in bad:
            a2t[r] = extract_subharmonic_amplitude(t_np[r], s_np[r],
                                                   2.0 * float(tau_np[r]))
    return a2t

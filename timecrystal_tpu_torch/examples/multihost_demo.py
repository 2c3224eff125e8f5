"""Multi-process ensemble demo: a torch.distributed group of ranks on this
machine evolving one disorder ensemble over the global batch mesh.  Port of
the JAX package's ``examples/multihost_demo.py``.

    python -m timecrystal_tpu_torch.examples.multihost_demo          # self-spawns 2 ranks
    python -m timecrystal_tpu_torch.examples.multihost_demo --rank N --port P --ranks K
                                                                     # one rank of K
    ... [--cpu] [--backend gloo|nccl]

On a real multi-host deployment every host runs the rank form with the
rendezvous host in place of localhost, and the program body is unchanged
(``parallel/multihost.py``).  The backend is named, never chosen: 'gloo'
(the default) for CPU ranks and for ranks that share one card, 'nccl' for
one GPU a rank.  Without ``--cpu`` every rank runs on a CUDA device (cuda:
rank % device count) and raises when there is none; ``--cpu`` runs the
ranks on the CPU in complex128.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..analysis.phase_diagram import _spec_dtype
from ..core.observables import extract_subharmonic_amplitude
from ..core.truncate import TruncParams
from ..parallel import multihost as mh
from ..parallel.sweep import SweepSpec

MODULE = "timecrystal_tpu_torch.examples.multihost_demo"
# the JAX script's ensemble: 16 realizations of L=12 at chi 32, 60 periods,
# theta = 0.97 pi, h = 0.3, tau = 1, fields from seed 7
DEMO = dict(L=12, chi=32, n_periods=60, n_realizations=16)
RANK_TIMEOUT = 600


def demo_ensemble(L: int = DEMO["L"], chi: int = DEMO["chi"],
                  n_periods: int = DEMO["n_periods"],
                  n_realizations: int = DEMO["n_realizations"], mesh=None,
                  device="cuda", dtype=torch.complex64) -> dict:
    """One disorder ensemble over every rank of the process group (one
    process without a group): ``disorder_ensemble_multihost`` with fields
    from a torch.Generator seeded 7 on every rank.  Every rank gets the
    full traces; returns {traces, a2t [R]}."""
    spec = SweepSpec(L=L, chi=chi, n_periods=n_periods,
                     theta=0.97 * float(np.pi),
                     tp=TruncParams(chi_max=chi, svd_min=1e-7),
                     dtype=_spec_dtype(dtype))
    traces = mh.disorder_ensemble_multihost(
        torch.Generator().manual_seed(7), n_realizations, spec,
        h_disorder=0.3, tau=1.0, mesh=mesh, device=device)
    times = 2.0 * np.arange(n_periods + 1)
    a2t = np.array([extract_subharmonic_amplitude(times, s, 2.0)
                    for s in traces["staggered_magnetization"]])
    return dict(traces=traces, a2t=a2t)


def rank_main(rank: int, ranks: int, port: int, backend: str = "gloo",
              device="cuda", dtype=torch.complex64, **size) -> dict:
    """One rank of ``ranks``: join the group at localhost:``port``, evolve
    the ensemble over the global mesh and leave the group.  Returns
    ``demo_ensemble``'s result (the same on every rank); ``size`` are
    ``demo_ensemble``'s sizes (the script's DEMO by default)."""
    mh.initialize(backend, f"tcp://localhost:{port}", world_size=ranks,
                  rank=rank, timeout_s=RANK_TIMEOUT)
    try:
        mesh = mh.global_mesh(device)
        if rank == 0:
            print(f"cluster up: {ranks} processes, "
                  f"{mesh.world * len(mesh.devices)} global devices "
                  f"({backend})", flush=True)
        return demo_ensemble(mesh=mesh, device=device, dtype=dtype, **size)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_args(args: argparse.Namespace) -> list:
    """The flags every spawned rank shares with this one."""
    return ["--backend", args.backend] + (["--cpu"] if args.cpu else [])


def spawn_cluster(args: argparse.Namespace) -> dict:
    """Start ranks 1..args.ranks-1 as ``python -m`` child processes with the
    device and backend of ``args`` (``parse_arguments``), run rank 0
    in this process, and wait for the children (killed after RANK_TIMEOUT
    s).  Returns rank 0's ``rank_main`` result; raises if a child failed."""
    ranks = args.ranks
    port = _free_port()
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                  if p]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", MODULE, "--rank", str(r), "--ranks", str(ranks),
         "--port", str(port)] + _rank_args(args), cwd=root, env=env)
        for r in range(1, ranks)]
    try:
        out = run_rank(0, ranks, port, args)
    finally:
        codes = []
        for p in procs:
            try:
                codes.append(p.wait(timeout=RANK_TIMEOUT))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                codes.append("timeout")
    if any(c != 0 for c in codes):
        raise RuntimeError(f"multihost_demo: ranks 1..{ranks - 1} exited {codes}")
    return out


def run_rank(rank: int, ranks: int, port: int, args: argparse.Namespace) -> dict:
    """``rank_main`` at the script's sizes with the device, type and
    backend of ``args``."""
    from ..main import run_device

    device, dtype = run_device(args.cpu)
    return rank_main(rank, ranks, port, backend=args.backend, device=device,
                     dtype=dtype)


def report(out: dict) -> None:
    """Rank 0's summary."""
    a2t = out["a2t"]
    sz = out["traces"]["sz_sites"]
    print(f"ensemble: {sz.shape[0]} realizations x {sz.shape[1] - 1} "
          f"periods, L={sz.shape[2]}")
    print(f"subharmonic A2T: mean {np.mean(a2t):.3f}  "
          f"min {np.min(a2t):.3f}  (DTC regime: ~1)")


def parse_arguments(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--backend", choices=mh.BACKENDS, default="gloo",
                    help="'gloo': CPU ranks, or ranks sharing one card; "
                         "'nccl': one GPU a rank")
    ap.add_argument("--cpu", action="store_true",
                    help="run the ranks on the CPU in complex128")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    from ..main import run_device

    args = parse_arguments(argv)
    run_device(args.cpu)                 # no CUDA device: stop before spawning
    if args.rank is None:
        report(spawn_cluster(args))
        return
    out = run_rank(args.rank, args.ranks, args.port, args)
    if args.rank == 0:
        report(out)


if __name__ == "__main__":
    main()

"""Scale-out of the port: the batch axis over a device mesh and over
``torch.distributed`` ranks, and one chain's sites over two ranks.

On the CPU every shard runs 'native' LAPACK, so sharded traces equal the
single-process port's bit for bit (trunc_err of the site-sharded chain to
rounding: its per-bond terms are summed in another order); against the
JAX package's sharded functions on the conftest's virtual devices,
complex128 against float64, to 1e-10.  The two ranks are real processes
joined by Gloo over localhost: this file run as a script is one rank
(``_rank_main``), and the test starts two with a timeout each.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from timecrystal_tpu_torch.core.mps import create_initial_state
from timecrystal_tpu_torch.core.truncate import TruncParams
from timecrystal_tpu_torch.dynamics.tebd import evolve_floquet_scan
from timecrystal_tpu_torch.models.kicked_ising import KickedIsingModel
from timecrystal_tpu_torch.parallel import sweep as tsw
from timecrystal_tpu_torch.parallel.site_shard import evolve_floquet_sharded

REPO = Path(__file__).resolve().parents[1]
L, CHI, N, R = 8, 8, 4, 3
THETA = 0.9 * np.pi
TOL = 1e-10
RANK_TIMEOUT = 120


def _batch():
    """(h_fields [R, L], taus [R], thetas [R], basis) of the batch legs."""
    rng = np.random.default_rng(11)
    return (rng.uniform(-0.3, 0.3, (R, L)), np.array([0.9, 1.0, 1.1]),
            THETA + np.array([0.0, 0.05, -0.05]), tsw._basis_indices(L, "neel"))


def _spec(n=N, chi=CHI):
    return tsw.SweepSpec(L=L, chi=chi, n_periods=n, theta=THETA,
                         tp=TruncParams(svd_min=1e-12), dtype="float64")


def _chain():
    m = KickedIsingModel(L, 1.0, 0.3, 1.0, disorder_seed=3, chi=CHI,
                         theta=THETA, device="cpu", dtype=torch.complex128)
    return m, create_initial_state(L, "neel", chi=CHI, device="cpu",
                                   dtype=torch.complex128)


STAGED = dict(chi_start=2, chunk_periods=2)


def _rank_main(rank: int, port: int, out: str) -> None:
    """One of two Gloo ranks: the multihost batch, the staged batch with
    per-rank checkpoints (2 periods, then resumed to 4), the refused grid
    checkpoint, and the site-sharded chain in both frames."""
    from timecrystal_tpu_torch.analysis import phase_diagram as tpd
    from timecrystal_tpu_torch.parallel import multihost as mh

    torch.set_num_threads(1)
    mh.initialize("gloo", f"tcp://localhost:{port}", world_size=2, rank=rank,
                  timeout_s=RANK_TIMEOUT)
    mesh = mh.global_mesh("cpu")
    h, taus, thetas, basis = _batch()
    res = {f"mh_{k}": v for k, v in mh.evolve_batch_multihost(
        h, taus, basis, _spec(), thetas=thetas, device="cpu").items()}
    ck = os.path.join(out, "staged")
    tsw.evolve_batch_auto(h, taus, basis, _spec(2), mesh=mesh,
                          checkpoint_dir=ck, device="cpu", **STAGED)
    staged, info = tsw.evolve_batch_auto(h, taus, basis, _spec(), mesh=mesh,
                                         checkpoint_dir=ck, device="cpu",
                                         **STAGED)
    res.update({f"st_{k}": v for k, v in staged.items()})
    res["st_chi"] = np.array(info["chi_pad_used"])
    try:
        tpd.sweep_phase_grid([0.1], [2.0], {}, checkpoint_dir=out,
                             device="cpu")
        res["grid_ck_refused"] = np.array(False)
    except ValueError:
        res["grid_ck_refused"] = np.array(True)
    m, psi0 = _chain()
    for frame in ("strict", "merged"):
        (B, lam), tr = evolve_floquet_sharded(psi0, m.gates, N,
                                              TruncParams(svd_min=1e-12),
                                              mesh=mesh, frame=frame)
        res.update({f"ss_{frame}_{k}": np.asarray(v) for k, v in tr.items()})
        res[f"ss_{frame}_B"], res[f"ss_{frame}_lam"] = B.numpy(), lam.numpy()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results, from two processes with a timeout each (a hung
    rank fails the test instead of stalling it)."""
    out = tmp_path_factory.mktemp("ranks")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port),
                               str(out)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(out / f"rank{r}.npz")) for r in (0, 1)], out


def _jax_batch_sharded(h, taus, thetas, basis, n_devices):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from timecrystal_tpu.core.truncate import TruncParams as JTruncParams
    from timecrystal_tpu.parallel import sweep as jsw

    spec = jsw.SweepSpec(L=L, chi=CHI, n_periods=N, theta=THETA,
                         tp=JTruncParams(svd_min=1e-12), dtype="float64")
    mesh = Mesh(np.asarray(jax.devices()[:n_devices]), ("batch",))
    return jsw.evolve_batch_sharded(jnp.asarray(h), jnp.asarray(taus), basis,
                                    spec, mesh, thetas=jnp.asarray(thetas))


def test_evolve_batch_sharded_four_device_cpu_mesh():
    """Three rows (one padded) over four CPU entries, with a kick angle per
    row: the unsharded evolve_batch's traces bit for bit, and the JAX
    package's evolve_batch_sharded on its eight virtual devices to 1e-10."""
    h, taus, thetas, basis = _batch()
    ref = tsw.evolve_batch(h, taus, basis, _spec(), thetas=thetas, device="cpu")
    out = tsw.evolve_batch_sharded(h, taus, basis, _spec(), thetas=thetas,
                                   mesh=tsw.BatchMesh(("cpu",) * 4))
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    jout = _jax_batch_sharded(h, taus, thetas, basis, 8)
    for k in jout:
        np.testing.assert_allclose(out[k], np.asarray(jout[k]), rtol=0,
                                   atol=TOL, err_msg=k)


def test_two_ranks_batch_multihost_and_staged_resume(two_ranks):
    """Two Gloo ranks: each returns the full batch of evolve_batch_multihost
    (the single-process evolve_batch bit for bit, the JAX package's
    2-device evolve_batch_sharded to 1e-10) and of the staged evolution
    resumed from per-rank checkpoints (rank_0000, rank_0001; the
    single-process evolve_batch_auto bit for bit, its schedule too); a grid
    checkpoint is refused in the multi-process run."""
    (r0, r1), out = two_ranks
    for k in r0:
        if not k.endswith(("_B", "_lam")):      # each rank's own block
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    h, taus, thetas, basis = _batch()
    ref = tsw.evolve_batch(h, taus, basis, _spec(), thetas=thetas, device="cpu")
    for k in ref:
        np.testing.assert_array_equal(r0[f"mh_{k}"], ref[k], err_msg=k)
    jout = _jax_batch_sharded(h, taus, thetas, basis, 2)
    for k in jout:
        np.testing.assert_allclose(r0[f"mh_{k}"], np.asarray(jout[k]), rtol=0,
                                   atol=TOL, err_msg=k)
    st, info = tsw.evolve_batch_auto(h, taus, basis, _spec(), device="cpu",
                                     **STAGED)
    for k in st:
        np.testing.assert_array_equal(r0[f"st_{k}"], st[k], err_msg=k)
    assert int(r0["st_chi"]) == info["chi_pad_used"] > STAGED["chi_start"]
    assert sorted(os.listdir(out / "staged")) == ["rank_0000", "rank_0001"]
    assert bool(r0["grid_ck_refused"])


def test_two_ranks_site_sharded_chain(two_ranks):
    """L=8 split 4 + 4 over two Gloo ranks, both frames: sz, the Loschmidt
    echo, the boundary error and each rank's block of the final state equal
    the single-process evolve_floquet_scan's bit for bit, trunc_err to
    1e-15 (summed in another order); the strict frame against the JAX
    package's evolve_floquet_sharded on two virtual devices to 1e-10."""
    (r0, r1), _ = two_ranks
    m, psi0 = _chain()
    tp = TruncParams(svd_min=1e-12)
    for frame in ("strict", "merged"):
        psi, tr = evolve_floquet_scan(psi0, m.gates, N, tp, frame=frame)
        for k in ("sz_sites", "loschmidt_echo", "trunc_err_boundary"):
            np.testing.assert_array_equal(r0[f"ss_{frame}_{k}"],
                                          tr[k].numpy(), err_msg=k)
        np.testing.assert_allclose(r0[f"ss_{frame}_trunc_err"],
                                   tr["trunc_err"].numpy(), rtol=0, atol=1e-15)
        for r, res in enumerate((r0, r1)):
            blk = slice(4 * r, 4 * r + 4)
            np.testing.assert_array_equal(res[f"ss_{frame}_B"], psi.B[blk])
            np.testing.assert_array_equal(res[f"ss_{frame}_lam"], psi.lam[blk])

    import jax.numpy as jnp

    from timecrystal_tpu.core.mps import create_initial_state as jstate
    from timecrystal_tpu.core.truncate import TruncParams as JTruncParams
    from timecrystal_tpu.models.kicked_ising import KickedIsingModel as JModel
    from timecrystal_tpu.parallel import site_shard as jss

    jm = JModel(L, 1.0, 0.3, 1.0, disorder_seed=3, chi=CHI, theta=THETA,
                dtype=jnp.float64)
    _, jtr = jss.evolve_floquet_sharded(
        jstate(L, "neel", chi=CHI, dtype=jnp.float64), jm.gates, N,
        JTruncParams(svd_min=1e-12), jss.site_mesh(2))
    for k in ("sz_sites", "loschmidt_echo", "trunc_err"):
        np.testing.assert_allclose(r0[f"ss_strict_{k}"], np.asarray(jtr[k]),
                                   rtol=0, atol=TOL, err_msg=k)


def test_site_shard_refusals_and_one_rank():
    """One rank is the single-process evolution (bit for bit); a periodic
    chain and a split into odd blocks are refused."""
    m, psi0 = _chain()
    tp = TruncParams(svd_min=1e-12)
    mesh = tsw.BatchMesh(("cpu",))
    (B, lam), tr = evolve_floquet_sharded(psi0, m.gates, 2, tp, mesh=mesh)
    psi, ref = evolve_floquet_scan(psi0, m.gates, 2, tp)
    assert torch.equal(B, psi.B) and torch.equal(lam, psi.lam[:-1])
    np.testing.assert_array_equal(tr["sz_sites"], ref["sz_sites"].numpy())
    mp = KickedIsingModel(L, 1.0, 0.3, 1.0, disorder_seed=3, chi=CHI,
                          bc="periodic", device="cpu", dtype=torch.complex128)
    with pytest.raises(NotImplementedError, match="periodic"):
        evolve_floquet_sharded(psi0, mp.gates, 1, tp, mesh=mesh)
    odd = create_initial_state(7, "neel", chi=4, device="cpu",
                               dtype=torch.complex128)
    m7 = KickedIsingModel(7, 1.0, 0.3, 1.0, disorder_seed=3, chi=4,
                          device="cpu", dtype=torch.complex128)
    with pytest.raises(ValueError, match="even-length"):
        evolve_floquet_sharded(odd, m7.gates, 1, tp, mesh=mesh)
    with pytest.raises(ValueError, match="frame"):
        evolve_floquet_sharded(psi0, m.gates, 1, tp, mesh=mesh, frame="x")


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])

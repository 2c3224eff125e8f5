"""The port's checkpoints, resumes, profiling hooks and Gram/eigh aliases.

``utils/checkpoint.py`` against the JAX package's npz layout; kill and
resume of every entry point that takes ``checkpoint_dir`` (a save is made
to raise mid-run, the next call resumes), bit-equal to the port's
uninterrupted run and within 1e-8 of the JAX package's (complex128 against
float64; the memory scans' noise is the JAX key stream replayed, and their
JAX runs are lifted from float32 to float64); ``utils/profiling.py`` on the
CPU.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timecrystal_tpu.analysis import memory as jmem
from timecrystal_tpu.analysis import phase_diagram as jpd
from timecrystal_tpu.core.mps import create_initial_state as jax_state
from timecrystal_tpu.core.truncate import TruncParams as JTruncParams
from timecrystal_tpu.dynamics.tebd import evolve_floquet_auto as jax_auto
from timecrystal_tpu.models.kicked_ising import KickedIsingModel as JModel
from timecrystal_tpu.parallel import sweep as jsw
from timecrystal_tpu.utils import checkpoint as jck
from timecrystal_tpu_torch.analysis import memory as tmem
from timecrystal_tpu_torch.analysis import phase_diagram as tpd
from timecrystal_tpu_torch.core.mps import MPS, create_initial_state
from timecrystal_tpu_torch.core.truncate import TruncParams
from timecrystal_tpu_torch.dynamics import tebd as ttebd
from timecrystal_tpu_torch.parallel import sweep as tsw
from timecrystal_tpu_torch.utils import checkpoint as tck
from timecrystal_tpu_torch.utils.profiling import (PhaseTimer, device_trace,
                                                   fence, timed_blocked)

C128 = torch.complex128
CPU = dict(device="cpu", dtype=C128)
TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs beside other worker processes on shared cores; torch's
    default intra-op thread pool would oversubscribe them and spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_equal(out, ref):
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def _assert_close(out, ref_jax, keys=None):
    for k in keys or ref_jax:
        np.testing.assert_allclose(out[k], np.asarray(ref_jax[k]), rtol=0,
                                   atol=TOL, err_msg=k)


def _kill_at(monkeypatch, module, name, n):
    """Make ``module.name`` raise KeyboardInterrupt on its n-th call (before
    it runs: the kill lands between two writes)."""
    real = getattr(module, name)
    calls = {"n": 0, "real": real}

    def killing(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == n:
            raise KeyboardInterrupt("simulated kill")
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, killing)
    return calls


def _interrupted(monkeypatch, module, name, n, run):
    """run() killed at the n-th call of module.name, then run() again."""
    calls = _kill_at(monkeypatch, module, name, n)
    with pytest.raises(KeyboardInterrupt):
        run()
    assert calls["n"] == n
    monkeypatch.setattr(module, name, calls["real"])
    return run()


# ---------------------------------------------------------------------------
# utils/checkpoint.py
# ---------------------------------------------------------------------------

def test_state_roundtrip_with_ensemble_axis(tmp_path):
    """An MPS with a leading ensemble axis and its metadata come back bit
    for bit, complex128 and complex64; the file is the npz the name says
    and no temporary file is left."""
    for dtype in (torch.complex128, torch.complex64):
        g = torch.Generator().manual_seed(1)
        B = torch.randn((3, 6, 4, 2, 4), generator=g, dtype=dtype)
        lam = torch.rand((3, 7, 4), generator=g, dtype=dtype.to_real())
        meta = {"p_done": 5, "escalations": [{"from": 4, "to": 8}]}
        path = str(tmp_path / f"state_{dtype}")
        tck.save_state(path, MPS(B=B, lam=lam), meta)
        assert tck.state_exists(path) and os.path.exists(path + ".npz")
        assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))
        psi, meta2 = tck.load_state(path, device="cpu")
        assert meta2 == meta and psi.B.dtype == dtype
        assert torch.equal(psi.B, B) and torch.equal(psi.lam, lam)
        psi64, _ = tck.load_state(path, device="cpu", dtype=torch.complex64)
        assert psi64.B.dtype == torch.complex64


def test_jax_written_npz_loads_to_the_same_tensors(tmp_path):
    """A state the JAX package saved with format='npz' (a float64 chain
    after two periods, a float32 product state) loads in the port to
    B_re + i B_im and lam exactly, with its metadata; asking the port for
    orbax raises."""
    for jdt, tdt in ((jnp.float64, torch.complex128),
                     (jnp.float32, torch.complex64)):
        psi = jax_state(6, "neel", chi=8, dtype=jdt)
        if jdt == jnp.float64:
            m = JModel(6, 1.0, 0.3, 1.0, disorder_seed=3, chi=8,
                       theta=0.9 * np.pi, dtype=jdt)
            for _ in range(2):
                psi = m.floquet_step(psi, JTruncParams(svd_min=1e-12))
        path = str(tmp_path / f"jax_{np.dtype(jdt).name}")
        jck.save_state(path, psi, {"period": 2}, format="npz")
        got, meta = tck.load_state(path, device="cpu")
        assert meta == {"period": 2} and got.B.dtype == tdt
        np.testing.assert_array_equal(got.B.real.numpy(), np.asarray(psi.B.re))
        np.testing.assert_array_equal(got.B.imag.numpy(), np.asarray(psi.B.im))
        np.testing.assert_array_equal(got.lam.numpy(), np.asarray(psi.lam))
    with pytest.raises(ValueError, match="npz"):
        tck.save_state(str(tmp_path / "x"), got, format="orbax")


def test_sweep_checkpointer_fingerprint_mismatch(tmp_path):
    d = str(tmp_path / "sweep")
    ck = tck.SweepCheckpointer(d, fingerprint="AAA")
    assert ck.completed_chunks() == set()
    ck.save_chunk(0, {"x": np.arange(3.0)})
    ck.save_chunk(2, {"x": np.arange(3.0) * 2}, extra={"grid": "h x T"})
    assert tck.SweepCheckpointer(d, fingerprint="AAA").completed_chunks() == {0, 2}
    np.testing.assert_array_equal(ck.load_chunk(2)["x"], np.arange(3.0) * 2)
    with pytest.raises(ValueError, match="different parameters"):
        tck.SweepCheckpointer(d, fingerprint="BBB").completed_chunks()


def test_sweep_checkpointer_survives_truncated_manifest(tmp_path):
    """The manifest is installed atomically: after every save it parses; a
    half-written temporary (a kill mid-write) is never read, and the next
    save replaces it."""
    ck = tck.SweepCheckpointer(str(tmp_path / "sweep"))
    for i in range(3):
        ck.save_chunk(i, {"x": np.arange(4.0)})
        with open(ck.manifest_path) as f:
            assert set(json.load(f)["chunks"]) == set(range(i + 1))
    with open(ck.manifest_path + ".tmp", "w") as f:
        f.write('{"chunks": [0, 1, 2, 3')            # truncated mid-write
    assert tck.SweepCheckpointer(ck.dir).completed_chunks() == {0, 1, 2}
    ck.save_chunk(3, {"x": np.arange(4.0)})
    assert tck.SweepCheckpointer(ck.dir).completed_chunks() == {0, 1, 2, 3}


# ---------------------------------------------------------------------------
# kill and resume
# ---------------------------------------------------------------------------

MK = dict(n_sites=8, J=1.0, h_disorder=0.3, tau=0.9, disorder_seed=42,
          theta=0.92 * np.pi)


def test_evolve_floquet_auto_kill_and_resume(tmp_path, monkeypatch):
    """Killed at the third state save (traces of chunk 3 already on disk),
    the resume re-runs from chunk 3 through the escalation (chi 4 -> 8 ->
    16) to the uninterrupted traces and schedule; a resume to fewer periods
    is the prefix; another seed refuses to resume."""
    kw = dict(chi_start=4, chi_limit=16, chunk_periods=2)
    tp = TruncParams(svd_min=1e-12)
    ref, _, ref_info, _ = ttebd.evolve_floquet_auto(dict(MK, **CPU), "neel",
                                                    10, tp, **kw)
    assert ref_info["chi_escalations"]
    ck = str(tmp_path / "auto")

    def run(n=10, seed=42):
        return ttebd.evolve_floquet_auto(
            dict(MK, disorder_seed=seed, **CPU), "neel", n, tp,
            checkpoint_dir=ck, **kw)

    out, _, info, _ = _interrupted(monkeypatch, tck, "save_state", 3, run)
    _assert_equal(out, ref)
    assert info["chi_escalations"] == ref_info["chi_escalations"]
    assert info["chi_pad_used"] == ref_info["chi_pad_used"]
    short = run(4)[0]
    _assert_equal(short, {k: v[:5] for k, v in ref.items()})
    with pytest.raises(ValueError, match="different parameters"):
        run(seed=7)
    jtr, _, jinfo, _ = jax_auto(dict(MK, dtype="float64"), "neel", 10,
                                JTruncParams(svd_min=1e-12), **kw)
    assert jinfo["chi_escalations"] == info["chi_escalations"]
    _assert_close(out, jtr)


def test_evolve_batch_auto_kill_and_resume(tmp_path, monkeypatch):
    """Killed at the third chunk's save: the resume gives the uninterrupted
    traces, schedule and re-run count bit for bit, and the JAX package's to
    1e-8."""
    rng = np.random.default_rng(5)
    h = rng.uniform(-0.3, 0.3, (2, 8))
    taus = np.array([0.9, 1.05])
    basis = tsw._basis_indices(8, "neel")
    kw = dict(L=8, chi=16, n_periods=10, theta=0.92 * np.pi, dtype="float64",
              frame="merged")
    spec = tsw.SweepSpec(tp=TruncParams(svd_min=1e-12), **kw)
    ref, ref_info = tsw.evolve_batch_auto(h, taus, basis, spec, chi_start=4,
                                          chunk_periods=2, device="cpu")

    def run():
        return tsw.evolve_batch_auto(h, taus, basis, spec, chi_start=4,
                                     chunk_periods=2, device="cpu",
                                     checkpoint_dir=str(tmp_path / "b"))

    out, info = _interrupted(monkeypatch, tck, "save_state", 3, run)
    _assert_equal(out, ref)
    for k in ("chi_escalations", "chi_pad_used", "n_rerun_periods"):
        assert info[k] == ref_info[k], k
    assert os.path.exists(str(tmp_path / "b" / "batch_auto_chunks" /
                              "chunk_00004.npz"))
    jtr, jinfo = jsw.evolve_batch_auto(
        jnp.asarray(h), jnp.asarray(taus), jnp.asarray(basis),
        jsw.SweepSpec(tp=JTruncParams(svd_min=1e-12), **kw), chi_start=4,
        chunk_periods=2)
    assert jinfo["chi_escalations"] == info["chi_escalations"]
    _assert_close(out, jtr)


PARAMS = {"J": 1.0, "SVD_MIN": 1e-12, "SVD_CUTOFF": 1e-7, "RANDOM_SEED": 42}


def test_sweep_phase_grid_kill_and_resume(tmp_path, monkeypatch):
    """Six points in chunks of two, killed in the second chunk's evolution:
    the resume evolves chunks 1 and 2 only, and the traces and scores are
    the one-program run's bit for bit and the JAX package's (its float32
    grid lifted to float64) to 1e-8."""
    hv, Tv = [0.0, 0.2, 0.4], [1.6, 2.0]
    small = dict(n_sites=6, n_periods=4)
    monkeypatch.setattr(tpd, "GRID_HARDCODED", dict(tpd.GRID_HARDCODED, **small))
    ref = tpd.sweep_phase_grid(hv, Tv, PARAMS, chi_pad=8, **CPU)
    ck = str(tmp_path / "grid")

    def run():
        return tpd.sweep_phase_grid(hv, Tv, PARAMS, chi_pad=8,
                                    checkpoint_dir=ck, chunk_size=2, **CPU)

    calls = _kill_at(monkeypatch, tpd, "evolve_batch", 2)
    with pytest.raises(KeyboardInterrupt):
        run()
    monkeypatch.setattr(tpd, "evolve_batch", calls["real"])
    counted = _kill_at(monkeypatch, tpd, "evolve_batch", 99)
    res = run()
    assert calls["n"] == 2 and counted["n"] == 2       # chunks 1 and 2
    assert tck.SweepCheckpointer(ck).completed_chunks() == {0, 1, 2}
    _assert_equal(res["traces"], ref["traces"])
    assert [r["A2T"] for r in res["records"]] == [r["A2T"] for r in ref["records"]]
    monkeypatch.setattr(jpd, "GRID_HARDCODED", dict(jpd.GRID_HARDCODED, **small))
    # the JAX grid is float32 by SweepSpec's default: lifted to float64
    monkeypatch.setattr(jpd, "SweepSpec",
                        lambda **kw: jsw.SweepSpec(dtype="float64", **kw))
    jres = jpd.sweep_phase_grid(hv, Tv, PARAMS, chi_pad=8)
    _assert_close(res["traces"], jres["traces"])


def _jax_memory(monkeypatch, fn, *args, **kwargs):
    """The JAX package's memory scan in float64 (it hard-codes float32)."""
    with monkeypatch.context() as m:
        m.setattr(jnp, "float32", jnp.float64)
        return fn(*args, **kwargs)


def _replayed_noise(n_rows, n_periods, L, seed):
    """The unit normals the JAX scans draw for rows split from
    PRNGKey(seed): per row, key, sub = split(key); normal(sub, (L,))."""
    @jax.jit
    def one(key):
        def step(k, _):
            k, sub = jax.random.split(k)
            return k, jax.random.normal(sub, (L,), jnp.float64)
        return jax.lax.scan(step, key, None, length=n_periods)[1]

    keys = jax.random.split(jax.random.PRNGKey(seed), n_rows)
    return np.array(jax.vmap(one)(keys))


MEM = dict(L=6, n_periods=4, chi=8, n_trajectories=3, chunk_size=2)


@pytest.mark.parametrize("scan", ["lifetime", "eps"])
def test_memory_scans_kill_and_resume(scan, tmp_path, monkeypatch):
    """Both memory scans in chunks of two rows, killed at the second chunk
    save (of the bit leg): the resume loads chunk 0 and gives the
    uninterrupted result bit for bit, and the JAX package's (same noise,
    float64) to 1e-8."""
    monkeypatch.setattr(tmem, "memory_noise", _replayed_noise)

    def run(ck=None):
        if scan == "lifetime":
            return tmem.scan_memory_lifetime([0.02, 0.08], eps=0.05,
                                             checkpoint_dir=ck, **MEM, **CPU)
        return tmem.scan_memory_vs_eps([0.0, 0.1], 0.05, checkpoint_dir=ck,
                                       **MEM, **CPU)

    ref = run()
    ck = str(tmp_path / scan)
    calls = _kill_at(monkeypatch, tck.SweepCheckpointer, "save_chunk", 2)
    with pytest.raises(KeyboardInterrupt):
        run(ck)
    monkeypatch.setattr(tck.SweepCheckpointer, "save_chunk", calls["real"])
    out = run(ck)
    arrays = {k: v for k, v in ref.items() if isinstance(v, np.ndarray)}
    _assert_equal({k: out[k] for k in arrays}, arrays)
    if scan == "lifetime":
        jres = _jax_memory(monkeypatch, jmem.scan_memory_lifetime, [0.02, 0.08],
                           eps=0.05, **MEM)
    else:
        jres = _jax_memory(monkeypatch, jmem.scan_memory_vs_eps, [0.0, 0.1],
                           0.05, **MEM)
    _assert_close(out, jres, [k for k in arrays if k not in ("tau_bit",)])


# ---------------------------------------------------------------------------
# Gram/eigh aliases and profiling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["gram_eigh", "gram_eigh_gs"])
def test_gram_eigh_aliases_match_jax(method):
    """csvd's Gram/eigh names are aliases of 'auto' ('native' on the CPU):
    U, S, Vh equal to 'native''s bit for bit, and S within
    tests/test_csvd.py's 1e-6 of the JAX package's csvd(method=...)."""
    from timecrystal_tpu.ops.cpx import C
    from timecrystal_tpu.ops.csvd import csvd as jcsvd
    from timecrystal_tpu_torch.ops.csvd import csvd

    rng = np.random.default_rng(0)
    A = rng.normal(size=(2, 12, 12)) + 1j * rng.normal(size=(2, 12, 12))
    out, nat = csvd(torch.as_tensor(A), method), csvd(torch.as_tensor(A), "native")
    for a, b in zip(out, nat):
        assert torch.equal(a, b)
    _, Sj, _ = jcsvd(C(jnp.asarray(A.real), jnp.asarray(A.imag)), method=method)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(Sj), rtol=0, atol=1e-6)


def test_phase_timer_and_timed_blocked_on_the_cpu(tmp_path):
    """Spans add up per name; fence and timed_blocked do nothing more than
    return on CPU tensors; device_trace writes a Chrome trace that names
    the ops run inside it."""
    with PhaseTimer() as t:
        with t.phase("a"):
            time.sleep(0.01)
        with t.phase("a"):
            time.sleep(0.01)
            t.fence(torch.ones(3))
        with t.phase("b"):
            pass
    rep = t.report()
    assert rep["a"] >= 0.02 and "b" in rep
    x = torch.ones((64, 64), dtype=torch.float64)
    out, secs = timed_blocked(lambda a: a @ a, x)
    assert secs >= 0.0 and torch.equal(out, x @ x)
    fence({"psi": create_initial_state(4, chi=2, **CPU), "n": 3})
    with device_trace(str(tmp_path)) as prof:
        (x @ x).sum()
    assert prof is not None
    text = (tmp_path / "trace.json").read_text()
    assert "aten::mm" in text
    with device_trace(None) as prof:
        assert prof is None

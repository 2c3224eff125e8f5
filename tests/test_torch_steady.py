"""The saturated steady state on the port's normal path (CPU).

``evolve_batch_auto``'s exit state (``info['state']``) continues a run at
the cap bit for bit; the ``'jacobi_core'`` continuation in complex128
matches the benchmark's plain reference (``portbench/reference/steady.py``,
LAPACK's exact top-chi); the projected SVD's stage times and counters
(``ops.jacobi_svd``: ``CORE_STAGES``, ``CORE_SVD_CALLS``) read zero
before any call and count on the CPU path; the stage clock's memory stays bounded.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference import steady as ref_steady
from timecrystal_tpu_torch.core.mps import product_state
from timecrystal_tpu_torch.core.truncate import TruncParams
from timecrystal_tpu_torch.dynamics.tebd import evolve_floquet_scan, to_host
from timecrystal_tpu_torch.models.kicked_ising import make_floquet_gates
from timecrystal_tpu_torch.ops import jacobi_svd as J
from timecrystal_tpu_torch.ops.csvd import csvd_topk
from timecrystal_tpu_torch.parallel import sweep as tsw
from timecrystal_tpu_torch.utils.profiling import StageClock

ROOT = Path(__file__).resolve().parents[1]
R, L, CHI, SETTLE, MORE, CHUNK = 2, 10, 16, 12, 4, 4
THETA, SVD_MIN = 0.9 * np.pi, 1e-7
METHOD = "jacobi_core"


def _fields():
    return np.random.default_rng(20261018).uniform(-0.3, 0.3, (R, L))


def _spec(n, dtype):
    return tsw.SweepSpec(L=L, chi=CHI, n_periods=n, theta=THETA,
                         tp=TruncParams(chi_max=0, svd_min=SVD_MIN),
                         dtype=dtype, frame="merged")


def _settled(n, dtype):
    basis = tsw._basis_indices(L, "neel")
    return tsw.evolve_batch_auto(_fields(), np.ones(R), basis, _spec(n, dtype),
                                 chi_start=8, chunk_periods=CHUNK,
                                 cap_svd_method=METHOD, device="cpu")


def _continue(state, n, dtype):
    """``n`` periods from ``state`` in chunks, with the arguments
    evolve_batch_auto passes at the cap (its docstring)."""
    cdtype = torch.complex64 if dtype == "float32" else torch.complex128
    rdtype = cdtype.to_real()
    spec = _spec(n, dtype)
    gates = make_floquet_gates(spec.J, torch.as_tensor(_fields(), dtype=rdtype),
                               torch.ones(R, dtype=rdtype), theta=spec.theta,
                               dtype=cdtype)
    psi0 = product_state(np.broadcast_to(tsw._basis_indices(L, "neel"), (R, L)),
                         chi=CHI, dtype=cdtype, device="cpu")
    tp = spec.tp._replace(svd_method=METHOD)
    chunks = []
    for _ in range(n // CHUNK):
        state, tr = evolve_floquet_scan(state, gates, CHUNK, tp, ref_state=psi0,
                                        frame="merged")
        chunks.append(to_host(tr))
    return state, {k: np.concatenate([c[k] for c in chunks], 1)
                   for k in ("sz_sites", "loschmidt_echo", "max_chi",
                             "trunc_err")}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_the_exit_state_continues_a_run_bit_for_bit(dtype):
    tr_a, info_a = _settled(SETTLE, dtype)
    tr_b, info_b = _settled(SETTLE + MORE, dtype)
    state = info_a["state"]
    assert info_a["chi_pad_used"] == CHI and info_a["chi_escalations"]
    assert info_b["chi_escalations"] == info_a["chi_escalations"]
    assert state.device == torch.device("cpu")
    assert state.B.shape == (R, L, CHI, 2, CHI)
    psi, tr = _continue(state, MORE, dtype)
    for k in tr:
        assert np.array_equal(tr[k], tr_b[k][:, SETTLE + 1:]), k
    assert torch.equal(psi.B, info_b["state"].B)
    assert torch.equal(psi.lam, info_b["state"].lam)
    # the shorter run's own traces are the longer run's first rows
    assert np.array_equal(tr_a["sz_sites"], tr_b["sz_sites"][:, :SETTLE + 1])


def test_a_sharded_run_gives_no_exit_state():
    _, info = tsw.evolve_batch_auto(
        _fields(), np.ones(R), tsw._basis_indices(L, "neel"), _spec(2, "float64"),
        chi_start=4, chunk_periods=2, mesh=tsw.BatchMesh(("cpu", "cpu")),
        device="cpu")
    assert info["state"] is None


def test_the_continuation_matches_the_plain_reference():
    """complex128 'jacobi_core' against LAPACK's exact top-16 from the same
    settled state, 4 merged periods.

    Tolerances: the projected SVD keeps a top-16 subspace that differs
    from the exact one by its projection leak, at most the weight w the
    exact truncation discards; two truncations of weight w each keep
    states within 2 sqrt(w) of the untruncated one, so sz and the echo
    (both of norm at most 1) may part by up to ~4 sqrt(w) summed over the
    truncating bond layers; 1e-9 on top covers complex128 rounding.  On
    the entry thetas the cores' sweeps run to complex128 convergence (tol
    1e-14), so the leak alone moves the top-16: each singular value by at
    most the first one dropped, sigma_17 (0.15 sigma_17 here), and the
    weight kept by at most the weight beyond 16 (5% of it here); 1e-12
    sigma_1 and 1e-12 ||theta||^2 on top for rounding."""
    _, info = _settled(SETTLE, "float64")
    state = info["state"]
    _, tr = _continue(state, MORE, "float64")
    ref = ref_steady.continue_merged(
        state.B, state.lam, _fields(), 1.0, THETA, tsw._basis_indices(L, "neel"),
        MORE, 1.0, dict(chi_cap=CHI, svd_min=SVD_MIN, trunc_cut=0.0),
        workers=2)
    w = float(np.sum(ref["trunc_err"]) + np.sum(ref["entry_err"]))
    tol = 4.0 * np.sqrt(w) * (2 * MORE + 2) + 1e-9
    assert w > 0, "the continuation must truncate"
    sz = np.max(np.abs(tr["sz_sites"] - ref["sz_sites"]))
    echo = np.max(np.abs(tr["loschmidt_echo"] - ref["loschmidt_echo"]))
    assert sz <= tol and echo <= tol, (sz, echo, tol)
    theta = ref_steady.entry_thetas(state.B, state.lam, _fields(), 1.0, 1.0)
    S, Vh, _ = csvd_topk(theta, CHI, method=METHOD)
    S_all = torch.linalg.svdvals(theta)
    S_ref = S_all[:, :CHI]
    assert torch.all((S - S_ref).abs().amax(-1)
                     <= S_all[:, CHI] + 1e-12 * S_all[:, 0])
    norm2 = (S_all ** 2).sum(-1)
    tail = (S_all[:, CHI:] ** 2).sum(-1)
    kept = ref_steady.kept_weight(theta, Vh.mH)
    assert torch.all(((S_ref ** 2).sum(-1) - kept).abs()
                     <= tail + 1e-12 * norm2)
    assert torch.max(tail / norm2) > 1e-12, "the thetas must have a tail"


def test_the_counters_read_zero_before_any_call():
    code = ("from timecrystal_tpu_torch.ops import jacobi_svd as J\n"
            "print(J.CORE_SVD_CALLS, sum(J.CORE_STAGES.seconds().values()),"
            " sorted(J.CORE_STAGES.seconds()) == sorted(J.CORE_STAGE_NAMES))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "0.0", "True"]


@pytest.mark.parametrize("method", ["jacobi_core", "jacobi_core_fast"])
def test_the_stages_and_counters_count_on_the_cpu(method):
    theta = torch.randn(6, 32, 32, dtype=torch.complex128,
                        generator=torch.Generator().manual_seed(3))
    calls, before = J.CORE_SVD_CALLS, J.CORE_STAGES.seconds()
    csvd_topk(theta, 16, method=method)
    after = J.CORE_STAGES.seconds()
    assert J.CORE_SVD_CALLS == calls + 1
    assert all(after[s] > before[s] for s in J.CORE_STAGE_NAMES)
    # other SVDs count nothing here
    csvd_topk(theta, 16, method="jacobi")
    assert J.CORE_SVD_CALLS == calls + 1
    assert J.CORE_STAGES.seconds() == after


class _Event:
    """A CUDA event's stand-in: done once ``done`` is set."""

    def __init__(self, t, done=True):
        self.t, self.done, self.waited = t, done, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited, self.done = True, True

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


def test_the_stage_clock_folds_completed_stages_and_stays_bounded(monkeypatch):
    clock = StageClock(("a", "b"))
    monkeypatch.setattr(StageClock, "MAX_PENDING", 3)
    e = [_Event(float(i), done=i < 3) for i in range(8)]
    for i in range(7):
        clock._pending.append(("a" if i % 2 == 0 else "b", e[i], e[i + 1]))
    clock._fold()                      # the stages ending in e1, e2
    assert len(clock._pending) == 5 and not e[3].waited
    assert clock._seconds == {"a": 1.0, "b": 1.0}
    clock._fold(len(clock._pending) - StageClock.MAX_PENDING)
    assert len(clock._pending) == 3 and e[3].waited and e[4].waited
    assert clock.seconds() == {"a": 4.0, "b": 3.0} and not clock._pending
    # a pass on the CPU adds the host clock's intervals at once
    with clock.run("cpu") as mark:
        mark("b")
        with pytest.raises(KeyError):
            mark("c")
    assert clock.seconds()["b"] >= 3.0 and not clock._pending


def test_the_stage_clock_loses_no_stage_across_threads():
    """Passes of a mesh's devices fold one clock from several threads: no
    stage is added twice or lost (10 threads, a short switch interval)."""
    import threading

    clock = StageClock(("a",))
    n_threads, n_stages = 10, 300

    def work():
        for i in range(n_stages):
            clock._pending.append(("a", _Event(0.0), _Event(1e-3)))
            clock._fold()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert clock.seconds()["a"] == pytest.approx(n_threads * n_stages * 1e-3)
    assert not clock._pending

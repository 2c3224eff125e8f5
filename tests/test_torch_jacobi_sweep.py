"""Kernel 1's two CUDA variants and its device exit, as far as the CPU reaches.

The kernels themselves run only on the card (chip_smoke.py holds them
against the twin there).  Here:
  * the fit rule and the dispatch of a CUDA-like (meta) tensor to the
    shared-memory or the cluster variant, at the rule's edges;
  * the device exit protocol -- a done flag, the previous launch's
    measures, max_sweeps launches -- modelled in torch around the twin
    sweep, against the host loop: the same X bit for bit and the same
    number of sweeps;
  * the arguments the wrapper hands the C entries (ctypes recorders), and
    the device counters the shared-memory entry adds into;
  * the premise of the shared-memory variant's skip: in the twin, a zero
    row and a column zero in every row stay zero through a sweep.
"""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from timecrystal_tpu_torch.ops import cuda_build
from timecrystal_tpu_torch.ops import jacobi_svd as J


# theta shape [B, n, n], dtype, the variant that takes it: the limits of the
# shared-memory fit rule n^2 itemsize + (n + 32) 8 <= 232448
SV_VARIANTS = {
    "c64_n168_limit": ((2, 168, 168), torch.complex64, "smem"),
    "c64_n170": ((2, 170, 170), torch.complex64, "cluster"),
    "c128_n120_limit": ((2, 120, 120), torch.complex128, "smem"),
    "c128_n122": ((2, 122, 122), torch.complex128, "cluster"),
    "c64_window_n144_batch320": ((320, 144, 144), torch.complex64, "smem"),
    "c64_leg_n512": ((20, 512, 512), torch.complex64, "cluster"),
    # the chi-staged ladder's rung above 256 and the exact chi=512 leg (20
    # even bonds of L=40), and the hires grid's one program (500 points x 8
    # even bonds at chi_pad 32)
    "c64_rung_n768": ((20, 768, 768), torch.complex64, "cluster"),
    "c64_exact_n1024": ((20, 1024, 1024), torch.complex64, "cluster"),
    "c64_hires_batch4000": ((4000, 64, 64), torch.complex64, "smem"),
}


@pytest.mark.parametrize("case", sorted(SV_VARIANTS))
def test_sv_fit_rule_and_dispatch(case, monkeypatch):
    """_sv_smem_fits at its edges (complex64 up to n = 168, complex128 up to
    n = 120), and jacobi_sv's dispatch of a CUDA-like (meta) tensor by it:
    the first launch reaches the wrapper with the variant the rule names,
    the loop's first measures (prev None) and never the twin."""
    shape, dtype, variant = SV_VARIANTS[case]
    B, n, _ = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert J._sv_smem_fits(n, n, itemsize) is (variant == "smem")
    assert J._sv_variant(B, n, n, itemsize) == variant

    class Reached(Exception):
        pass

    def launch(X, prev, measure, done, threshold, variant):
        raise Reached(variant, tuple(X.shape), prev)

    def boom(*args, **kwargs):
        raise AssertionError("fell back to the twin")

    monkeypatch.setattr(J, "_launch_sweep_cuda", launch)
    monkeypatch.setattr(J, "_jacobi_sweep_torch", boom)
    with pytest.raises(Reached) as info:
        J.jacobi_sv(torch.empty(shape, dtype=dtype, device="meta"))
    assert info.value.args == (variant, shape, None)


@pytest.mark.parametrize("n,m,fits", [(168, 16, True), (170, 16, False),
                                      (176, 8, False), (96, 300, True)])
def test_sv_fit_rule_limits_rows_by_threads(n, m, fits):
    """A short-row panel fits the shared memory long before its rows reach
    the kernel's 672 threads (8 lanes a pair): n = 168 is the last it takes,
    whatever m."""
    assert J._sv_smem_fits(n, m, 8) is fits
    assert J._sv_variant(2, n, m, 8) == ("smem" if fits else "cluster")


def test_meta_tensor_reaches_the_cuda_wrapper_and_counts_nothing():
    """Without the monkeypatch the wrapper itself raises on a tensor that is
    not on a CUDA device, before any launch is counted."""
    before = (J.KERNEL_LAUNCHES, J.SV_SMEM_LAUNCHES, J.SV_CLUSTER_LAUNCHES,
              J.SV_HOST_READS)
    for n in (8, 200):
        M = torch.empty((2, n, n), dtype=torch.complex64, device="meta")
        with pytest.raises(ValueError, match="^CUDA sweep needs a CUDA tensor"):
            J.jacobi_sv(M)
    assert (J.KERNEL_LAUNCHES, J.SV_SMEM_LAUNCHES, J.SV_CLUSTER_LAUNCHES,
            J.SV_HOST_READS) == before


def _model_launch(ran: list):
    """The kernel's launch, modelled in torch: the exit test of its first
    lines (sweep_is_skipped), then the twin's sweep.  ran[0] counts the
    sweeps run, ran[1] the launches."""
    def launch(X, prev, measure, done, threshold):
        ran[1] += 1
        if prev is not None and (bool(done) or
                                 float(prev.amax().to(torch.float32)) < threshold):
            done.fill_(1)
            return
        Xs, m = J._jacobi_sweep_torch(X)
        X.copy_(Xs)
        measure.copy_(m)
        ran[0] += 1
    return launch


def _host_loop(X, max_sweeps, threshold):
    count = [0]

    def sweep(X):
        count[0] += 1
        return J._jacobi_sweep_torch(X)

    return J._host_sweep_loop(X, max_sweeps, threshold, sweep), count[0]


def _rank1(rng, n):
    u = rng.normal(size=(n, 1)) + 1j * rng.normal(size=(n, 1))
    v = rng.normal(size=(1, n)) + 1j * rng.normal(size=(1, n))
    return u @ v / n


def _random(rng, n):
    return (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))) / np.sqrt(n)


def _unitary(rng, n):
    q, _ = np.linalg.qr(_random(rng, n))
    return q


# batch, max_sweeps, dtype: batches whose matrices converge at different
# sweeps (the batch max decides), one cut by the cap, one already
# orthogonal (the exit after one sweep), and a cap of one sweep
EXIT_CASES = {
    "mixed_batch_c128": (lambda rng: [_rank1(rng, 8), _random(rng, 8),
                                      _random(rng, 8)], 24, torch.complex128),
    "mixed_batch_c64": (lambda rng: [_rank1(rng, 12), _random(rng, 12),
                                     _unitary(rng, 12) * np.linspace(1, 2, 12)],
                        12, torch.complex64),
    "cap": (lambda rng: [_random(rng, 16) for _ in range(2)], 2, torch.complex128),
    "orthogonal_one_sweep": (lambda rng: [_unitary(rng, 8) for _ in range(3)], 24,
                             torch.complex128),
    "cap_one": (lambda rng: [_random(rng, 8)], 1, torch.complex64),
}


@pytest.mark.parametrize("case", sorted(EXIT_CASES))
def test_device_exit_protocol_matches_the_host_loop(case):
    """_device_sweep_loop with a model of the kernel's launch gives the host
    loop's X bit for bit and the same number of sweeps, enqueueing exactly
    max_sweeps launches; launches after the exit leave X alone."""
    make, max_sweeps, dtype = EXIT_CASES[case]
    rng = np.random.default_rng(4)
    X = torch.as_tensor(np.stack(make(rng))).to(dtype).conj().resolve_conj()
    tol = 1e-14 if dtype == torch.complex128 else 3e-8
    threshold = J._exit_threshold(tol)
    Xh, sweeps = _host_loop(X.clone(), max_sweeps, threshold)
    ran = [0, 0]
    Xd = J._device_sweep_loop(X.clone(), max_sweeps, threshold, _model_launch(ran))
    assert torch.equal(Xd, Xh)
    assert ran == [sweeps, max_sweeps]
    if case == "orthogonal_one_sweep":
        assert sweeps == 1
    if case.startswith("cap"):
        assert sweeps == max_sweeps
    if case.startswith("mixed"):
        # the matrices alone stop at different sweeps; the batch stops at the
        # last of them
        alone = [_host_loop(X[i:i + 1].clone(), max_sweeps, threshold)[1]
                 for i in range(X.shape[0])]
        assert len(set(alone)) > 1 and sweeps == max(alone), (alone, sweeps)


def test_jacobi_sv_device_loop_gives_the_twin_result():
    """jacobi_sv through _device_sweep_loop (the model launch) gives
    jacobi_sv_plain's S and V bit for bit."""
    rng = np.random.default_rng(6)
    theta = torch.as_tensor(np.stack([_rank1(rng, 8), _random(rng, 8)]))
    ran = [0, 0]

    def loop(X, max_sweeps, threshold):
        return J._device_sweep_loop(X, max_sweeps, threshold, _model_launch(ran))

    S, V = J._jacobi_sv(theta, None, None, 4, loop)
    Sp, Vp = J.jacobi_sv_plain(theta, polish=4)
    assert torch.equal(S, Sp) and torch.equal(V, Vp)
    assert ran[1] == 24 and 0 < ran[0] < 24


def _recording_library(monkeypatch, calls, rc=0, plan=(8, 30), add=None):
    """Replace the kernel library by ctypes-call recorders: the launch
    entries record their arguments and argtypes and return rc, the cluster
    plan writes ``plan``; with ``add`` = (live, scheduled) the
    shared-memory entries add it into the int64 [2] at their pair-step
    counter's address, as the kernel does."""
    def entry(name):
        def fn(*args):
            calls.append((name, args, fn.argtypes))
            if add is not None and name.startswith("smem"):
                counter = (ctypes.c_int64 * 2).from_address(args[7])
                counter[0] += add[0]
                counter[1] += add[1]
            return rc
        return fn

    def plan_fn(*args):
        calls.append(("plan", args[:3], None))
        args[3]._obj.value, args[4]._obj.value = plan
        return 0

    lib = types.SimpleNamespace(
        tct_jacobi_sweep_c64=entry("smem_c64"),
        tct_jacobi_sweep_c128=entry("smem_c128"),
        tct_jacobi_sweep_cluster_c64=entry("cluster_c64"),
        tct_jacobi_sweep_cluster_c128=entry("cluster_c128"),
        tct_jacobi_sweep_cluster_plan_c64=plan_fn,
        tct_jacobi_sweep_cluster_plan_c128=plan_fn)
    monkeypatch.setattr(cuda_build, "load_kernel_library", lambda name: (lib, None))
    monkeypatch.setattr(J, "_check_cuda_rows", lambda X, what="": None)
    monkeypatch.setattr(J, "_CLUSTER_PLANS", {})
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))


def _real_buffers(monkeypatch, allocated):
    """Give the arguments the recorders cannot tell apart on meta tensors
    (address 0) addresses of their own: both device counters become CPU
    tensors, and every int16 allocation (the shared-memory variant's pair
    list) a CPU tensor recorded in ``allocated``."""
    counters = (torch.zeros((), dtype=torch.int64),
                torch.zeros(2, dtype=torch.int64))
    monkeypatch.setattr(J, "sweep_counter", lambda device: counters[0])
    monkeypatch.setattr(J, "pair_step_counter", lambda device: counters[1])
    empty = torch.empty

    def spy(*shape, dtype=None, device=None, **kwargs):
        if dtype == torch.int16:
            allocated.append((tuple(*shape), device, empty(*shape, dtype=dtype)))
            return allocated[-1][2]
        return empty(*shape, dtype=dtype, device=device, **kwargs)
    monkeypatch.setattr(torch, "empty", spy)
    return counters


@pytest.mark.parametrize("shape,dtype,entry,extra", [
    ((3, 8, 8), torch.complex64, "smem_c64", ()),
    ((2, 120, 120), torch.complex128, "smem_c128", ()),
    ((2, 170, 170), torch.complex64, "cluster_c64", (8,)),
    ((2, 122, 122), torch.complex128, "cluster_c128", (8,)),
])
def test_launch_wrapper_hands_the_c_entry_its_arguments(shape, dtype, entry, extra,
                                                        monkeypatch):
    """jacobi_sv enqueues max_sweeps launches of one entry with (X, sched,
    prev, measure, done, sweeps[, pairs, pair_steps], B, n, m,
    threshold[, cluster size], stream): X and the schedule, prev null for
    the first launch only and the last launch's measures after it, a
    measure row of its own and the loop's one done flag, the device
    counters, the shared-memory variant's fresh int16 [B, n-1, n/2] pair
    list, the host loop's float32 threshold, the cluster size from the
    plan, the current stream, each with its ctypes type; every launch is
    counted."""
    calls, allocated = [], []
    _recording_library(monkeypatch, calls)
    sweeps, pair_steps = _real_buffers(monkeypatch, allocated)
    smem = entry.startswith("smem")
    before = (J.KERNEL_LAUNCHES, J.SV_SMEM_LAUNCHES, J.SV_CLUSTER_LAUNCHES)
    J.jacobi_sv(torch.empty(shape, dtype=dtype, device="meta"), max_sweeps=3)
    launches = [(args, types_) for name, args, types_ in calls if name != "plan"]
    assert [name for name, _, _ in calls if name != "plan"] == [entry] * 3
    B, n, m = shape
    tol = 3e-8 if dtype == torch.complex64 else 1e-14
    scratch = 2 if smem else 0
    assert [(s, str(d)) for s, d, _ in allocated] == (
        [((B, n - 1, n // 2), "meta")] * 3 if smem else [])
    sched = J._schedule_on(n, torch.device("meta"))
    for i, (args, types_) in enumerate(launches):
        assert len(args) == 11 + scratch + len(extra)
        assert types_ == ([ctypes.c_void_p] * (6 + scratch) + [ctypes.c_int] * 3
                          + [ctypes.c_float] + [ctypes.c_int] * len(extra)
                          + [ctypes.c_void_p])
        assert args[0] == 0 and args[1] == sched.data_ptr()     # meta tensors
        # the loop's measures [2, B] float64 on meta: row s at offset 8 B s
        assert args[2] == (None if i == 0 else (i - 1) % 2 * 8 * B)
        assert args[3] == i % 2 * 8 * B and args[4] == 0
        assert args[5] == sweeps.data_ptr()
        if smem:
            assert args[6] == allocated[i][2].data_ptr()
            assert args[7] == pair_steps.data_ptr()
        assert args[6 + scratch:9 + scratch] == (B, n, m)
        assert args[9 + scratch] == J._exit_threshold(tol) == np.float32(tol * tol)
        assert args[10 + scratch:-1] == extra
        assert args[-1] == 0                                   # the stream
    assert [c[:2] for c in calls if c[0] == "plan"] == (
        [("plan", (B, n, m))] if extra else [])
    smem = 3 if smem else 0
    assert (J.KERNEL_LAUNCHES, J.SV_SMEM_LAUNCHES, J.SV_CLUSTER_LAUNCHES) == (
        before[0] + 3, before[1] + smem, before[2] + 3 - smem)


def test_pair_step_counter_is_reset_and_read_like_the_sweep_counter(monkeypatch):
    """pair_step_counter(device) is one int64 [2] tensor per device, apart
    from sweep_counter's; the shared-memory entry adds (live, scheduled)
    into it on every launch (a mocked entry here), the host reads the
    totals, and zero_() resets it; the cluster entry adds nothing."""
    monkeypatch.setattr(J, "_PAIR_STEPS", {})
    counter = J.pair_step_counter("cpu")
    assert counter is J.pair_step_counter(torch.device("cpu"))
    assert counter is not J.sweep_counter("cpu")
    assert counter.dtype == torch.int64 and counter.shape == (2,)
    assert counter.tolist() == [0, 0]
    # the entries add where the wrapper points them: this CPU counter
    J._PAIR_STEPS["meta"] = counter
    calls = []
    _recording_library(monkeypatch, calls, add=(5, 84))
    J.jacobi_sv(torch.empty((3, 8, 8), dtype=torch.complex64, device="meta"),
                max_sweeps=4)
    assert counter.tolist() == [4 * 5, 4 * 84]
    counter.zero_()
    assert J.pair_step_counter("meta").tolist() == [0, 0]
    J.jacobi_sv(torch.empty((3, 8, 8), dtype=torch.complex64, device="meta"),
                max_sweeps=2)
    J.jacobi_sv(torch.empty((2, 170, 170), dtype=torch.complex64, device="meta"),
                max_sweeps=2)
    assert counter.tolist() == [2 * 5, 2 * 84]


# rows and columns zero in every row of X [n, m], as the padded MPS leaves
# them: the drive diagram's theta (48 of 96 rows live, columns q * 48 + c
# with c < 24) and one live row
ZERO_PATTERNS = {
    "drive_like": (16, 16, list(range(8)), [c for c in range(16) if c % 8 < 4]),
    "one_live_row": (8, 12, [3], list(range(12))),
    "scattered": (12, 10, [0, 2, 3, 7, 11], [1, 4, 5, 9]),
}


@pytest.mark.parametrize("case", sorted(ZERO_PATTERNS))
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_zero_rows_and_columns_stay_zero_through_a_sweep(case, dtype):
    """What makes the shared-memory variant's skip exact, in the twin (the
    kernel's arithmetic): a pair with a zero row rotates by the identity
    and a rotation mixes only like columns, so after a sweep the zero rows
    and the columns zero in every row are still exactly zero; one live row
    is left as it was, with measure 0."""
    n, m, rows, cols = ZERO_PATTERNS[case]
    rng = np.random.default_rng(9)
    X = torch.zeros((1, n, m), dtype=dtype)
    live = torch.as_tensor(rng.normal(size=(len(rows), len(cols)))
                           + 1j * rng.normal(size=(len(rows), len(cols)))).to(dtype)
    X[0, np.ix_(rows, cols)[0], np.ix_(rows, cols)[1]] = live
    Xs, measure = J._jacobi_sweep_torch(X)
    dead_rows = [r for r in range(n) if r not in rows]
    dead_cols = [c for c in range(m) if c not in cols]
    assert torch.all(Xs[0, dead_rows] == 0) and torch.all(Xs[0][:, dead_cols] == 0)
    if len(rows) == 1:
        assert torch.equal(Xs, X) and float(measure) == 0.0
    else:
        assert not torch.equal(Xs, X)     # the live rows did rotate


def test_refused_launch_raises_and_counts_nothing(monkeypatch):
    """A launch the card refuses (nonzero return) raises; nothing falls back
    and no launch is counted."""
    calls = []
    _recording_library(monkeypatch, calls, rc=1)
    monkeypatch.setattr(J, "_jacobi_sweep_torch", None)
    before = J.KERNEL_LAUNCHES
    for n in (8, 200):
        with pytest.raises(RuntimeError, match="kernel launch failed: CUDA error 1"):
            J.jacobi_sv(torch.empty((2, n, n), dtype=torch.complex64, device="meta"))
    assert J.KERNEL_LAUNCHES == before
    with pytest.raises(ValueError, match="does not take"):
        J._jacobi_sweep_cuda(torch.empty((1, 200, 200), dtype=torch.complex64,
                                         device="meta"), "smem")


def test_twin_at_1024_rows_matches_lapack():
    """The twin's sweep loop over 1024 rows (the exact chi=512 leg's row
    count, [1, 1024, 16] complex128: 1023 tournament steps a sweep) gives
    float64 LAPACK's singular values of the rows to 1e-10 x sigma_max."""
    rng = np.random.default_rng(5)
    A = rng.normal(size=(1024, 16)) + 1j * rng.normal(size=(1024, 16))
    A *= np.logspace(0, -6, 16)
    X = torch.as_tensor(A[None])
    S = J._cols_to_sv(J._orthogonalize_columns(X, 24, 1e-14, J._plain_sweep_loop),
                      0)[0][0].numpy()
    ref = np.linalg.svd(A, compute_uv=False)
    assert np.all(S[16:] == 0.0)
    np.testing.assert_allclose(S[:16], ref, rtol=0, atol=1e-10 * ref[0])

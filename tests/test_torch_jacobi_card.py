"""Kernel 1's shared-memory variant on the card, on the padded MPS's exact
zeros: held against the twin, the zero rows and chunks kept exactly zero,
and the device count of the pair-steps it ran.

Every test needs a CUDA card and skips without one.  On the card, without
the JAX package's ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_jacobi_card.py
"""

import numpy as np
import pytest
import torch

from timecrystal_tpu_torch.ops import jacobi_svd as J


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: kernel 1 runs on the card only")


def _live(pattern: str, B: int, n: int):
    """The live rows and columns of each of the B matrices X [n, n] =
    conj(theta) of a padded bond: a theta's columns are (q, c), q the
    physical index (n/2 columns each) and c the bond, and its rows the
    same; a bond of chi live values leaves rows 0 .. 2 chi - 1 and the
    columns q n/2 + c, c < chi, live."""
    half = n // 2
    out = []
    for b in range(B):
        if pattern == "drive":        # chi_pad 48 capped at 24, at n = 96
            chi = n // 4
        elif pattern == "window":     # each bond at its own chi, 1 .. n/2
            chi = 1 + (7 * b) % half
        elif pattern == "one_row":
            out.append(([5], list(range(n))))
            continue
        elif pattern == "columns":    # every row live, half the chunks zero
            out.append((list(range(n)), [q * half + c for q in range(2)
                                         for c in range(n // 4)]))
            continue
        else:                         # dense
            chi = half
        out.append((list(range(2 * chi)),
                    [q * half + c for q in range(2) for c in range(chi)]))
    return out


def _matrices(live, n: int, dtype, seed: int) -> torch.Tensor:
    """X [B, n, n] on the card: each live block U diag(s) V^H with a
    Schmidt-like spectrum from 1 down to 1e-7 (as chip_smoke's TEBD-like
    inputs), every other element an exact zero."""
    rng = np.random.default_rng(seed)
    X = np.zeros((len(live), n, n), np.complex128)
    for b, (rows, cols) in enumerate(live):
        r = min(len(rows), len(cols))
        s = 10.0 ** (-7.0 * np.sqrt(np.arange(r) / max(r - 1, 1)))
        U, _ = np.linalg.qr(rng.normal(size=(len(rows), r))
                            + 1j * rng.normal(size=(len(rows), r)))
        V, _ = np.linalg.qr(rng.normal(size=(len(cols), r))
                            + 1j * rng.normal(size=(len(cols), r)))
        X[b][np.ix_(rows, cols)] = (U * s) @ V.conj().T
    return torch.as_tensor(X).to(dtype).to("cuda")


def _expected_pair_steps(live, n: int) -> tuple:
    """(live, scheduled) pair-steps of one sweep: a tournament pairs every
    two rows once, so a matrix with l live rows runs C(l, 2) of its
    (n-1) n/2 pair-steps."""
    return (sum(len(r) * (len(r) - 1) // 2 for r, _ in live),
            len(live) * (n - 1) * (n // 2))


def _dead(X: torch.Tensor, live) -> bool:
    """Whether every row and column outside each matrix's live ones is an
    exact zero in X."""
    n = X.shape[1]
    for b, (rows, cols) in enumerate(live):
        keep = torch.zeros((n, n), dtype=torch.bool, device=X.device)
        keep[np.ix_(rows, cols)] = True
        if torch.any(X[b][~keep] != 0):
            return False
    return True


SHAPES = [(960, 96), (320, 64)]
PATTERNS = ["drive", "window", "one_row", "columns", "dense"]


@pytest.mark.card
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("B,n", SHAPES)
def test_one_sweep_on_padded_inputs_matches_the_twin(B, n, pattern):
    """One sweep of the shared-memory variant on complex64 X with the
    pattern's zeros, against the twin: the measure within 1e-6 relative,
    the rotation unitary (X^H X kept to 1e-5 of its largest entry), the
    zero rows and chunks exactly zero, one sweep counted and the pair-step
    counter advanced by (sum C(live rows, 2), B (n-1) n/2)."""
    _card()
    live = _live(pattern, B, n)
    X = _matrices(live, n, torch.complex64, seed=B + n)
    assert J._sv_variant(B, n, n, X.element_size()) == "smem"
    sweeps, pair_steps = J.sweep_counter(X.device), J.pair_step_counter(X.device)
    s0, p0 = int(sweeps), pair_steps.tolist()
    Xk, mk = J._jacobi_sweep_cuda(X.clone())
    torch.cuda.synchronize()
    Xt, mt = J._jacobi_sweep_torch(X.cpu())
    mk, Xk_cpu = mk.cpu(), Xk.cpu()
    rel = ((mk - mt).abs() / mt.clamp_min(1e-300)).max()
    assert float(rel) < 1e-6
    G0 = X.cpu().to(torch.complex128).mH @ X.cpu().to(torch.complex128)
    Gk = Xk_cpu.to(torch.complex128).mH @ Xk_cpu.to(torch.complex128)
    assert float((Gk - G0).abs().max() / G0.abs().max()) < 1e-5
    assert _dead(Xk, live)
    assert int(sweeps) - s0 == 1
    got = [a - b for a, b in zip(pair_steps.tolist(), p0)]
    assert tuple(got) == _expected_pair_steps(live, n)


@pytest.mark.card
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_sweep_loop_on_padded_inputs_matches_the_twin_loop(pattern, dtype):
    """jacobi_sv's device loop (the exit on the device) at [320, 64, 64]
    against the twin's host loop, both run to convergence (tol 3e-8 for
    complex64, 1e-14 for complex128, cap 24): S within 1e-5 (complex64) or
    1e-9 (complex128) of sigma_max, the zero rows and chunks exactly zero,
    and the pair-step counter at sweeps x (sum C(live rows, 2),
    B (n-1) n/2)."""
    _card()
    B, n = 320, 64
    live = _live(pattern, B, n)
    X = _matrices(live, n, dtype, seed=11)
    tol, bound = (3e-8, 1e-5) if dtype == torch.complex64 else (1e-14, 1e-9)
    sweeps, pair_steps = J.sweep_counter(X.device), J.pair_step_counter(X.device)
    s0, p0 = int(sweeps), pair_steps.tolist()
    Xk = J._orthogonalize_columns(X, 24, tol, J._sweep_loop)
    torch.cuda.synchronize()
    ran = int(sweeps) - s0
    Xt = J._orthogonalize_columns(X.cpu(), 24, tol, J._plain_sweep_loop)
    Sk = J._sigma_sort_floor(Xk.cpu())[0]
    St = J._sigma_sort_floor(Xt)[0]
    assert float((Sk - St).abs().max() / St.max()) < bound
    assert _dead(Xk, live)
    assert 1 <= ran <= 24
    got = tuple(a - b for a, b in zip(pair_steps.tolist(), p0))
    live_steps, scheduled = _expected_pair_steps(live, n)
    assert got == (ran * live_steps, ran * scheduled)

"""Nominal work of the kicked-Ising TEBD periods a run completed.

Counted from the run's own traces, never from the kernels' counters, so
the counts read the same whatever implements the SVD.  Per chain and
period: one singular-value decomposition of each bond's two-site matrix.
Bond b (1..L-1, b sites to its left) has the side n_b = 2 chi_b with
chi_b = min(max_chi of that period, 2^min(b, L-b)).

  * SVD operations: a textbook complex bidiagonalisation of an m x n
    matrix, 4 (4 m n^2 - 4 n^3 / 3) real operations, m = n here.
  * Contraction and gate: the pair B_l B_r, (2 chi x chi)(chi x 2 chi), and
    the dense 4 x 4 gate on the 4 chi^2 entries of theta, 8 real
    operations a complex multiply-add: 4 n^3 + 32 n^2.
  * SVD bytes: the complex64 matrix read once and its float32 singular
    values written once, 8 n^2 + 4 n.

The least time of one SVD on a card is the larger of its operations over
the float32 peak and its bytes over the memory rate (``peaks.json``).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def peaks(kind: str) -> dict | None:
    """The published peaks of the card ``kind`` (torch's device name), or
    None for a card the table does not hold."""
    return json.loads(PEAKS_FILE.read_text())["cards"].get(kind)


def bond_sides(L: int, max_chi) -> np.ndarray:
    """n_b [..., L-1] for the periods' max_chi [...]."""
    b = np.arange(1, L)
    full = 2.0 ** np.minimum(b, L - b)
    chi = np.minimum(np.asarray(max_chi, float)[..., None], full)
    return 2.0 * chi


def svd_ops(n):
    n = np.asarray(n, float)
    return 4.0 * (4.0 * n ** 3 - 4.0 * n ** 3 / 3.0)


def contraction_ops(n):
    n = np.asarray(n, float)
    return 4.0 * n ** 3 + 32.0 * n ** 2


def svd_bytes(n):
    n = np.asarray(n, float)
    return 8.0 * n ** 2 + 4.0 * n


def periods_work(L: int, max_chi, peak: dict | None = None) -> dict:
    """Totals over the periods whose max_chi [...] is given (one entry a
    chain and period): ``svds``, ``svd_ops``, ``ops`` (SVDs, contractions
    and gates), ``svd_bytes`` and, with ``peak``, ``svd_seconds``: the sum
    of each SVD's least time on that card."""
    n = bond_sides(L, max_chi)
    s_ops, s_bytes = svd_ops(n), svd_bytes(n)
    out = {"svds": float(n.size), "svd_ops": float(s_ops.sum()),
           "ops": float((s_ops + contraction_ops(n)).sum()),
           "svd_bytes": float(s_bytes.sum())}
    if peak is not None:
        out["svd_seconds"] = float(np.maximum(
            s_ops / peak["float32_flops"],
            s_bytes / peak["memory_bytes_per_s"]).sum())
    return out

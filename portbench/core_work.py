"""Least work of kernel 1's sweeps on the projected top-k SVD's k x k cores
(``ops.jacobi_svd.jacobi_core``), for ``k1_core_roofline_pct``.

A sweep of one-sided Jacobi over a k x k complex matrix rotates each of
its k (k - 1) / 2 pairs of rows once.  Least operations of a pair: the
inner product of the two rows, k complex multiply-adds (8 k real
operations), and the plane rotation of both rows by a real cosine and a
complex sine, 10 real operations an entry (20 k); the rows' norms follow
from the rotation without a pass over the rows.  Least bytes of a sweep:
the matrix read once and written once.  Every sweep has the same shape,
so the least time of many is the larger of their summed operations over
the float32 peak and their summed bytes over the memory rate.
"""

from __future__ import annotations


def sweep_ops(k: int) -> float:
    """Real operations of one sweep of one k x k complex matrix."""
    return 28.0 * k * k * (k - 1) / 2.0


def sweep_bytes(k: int, itemsize: int) -> float:
    """Bytes of one sweep of one k x k matrix of ``itemsize``-byte entries."""
    return 2.0 * k * k * itemsize


def sweeps_work(matrix_sweeps: float, k: int, itemsize: int) -> dict:
    """``ops`` and ``bytes`` of ``matrix_sweeps`` sweeps of one k x k matrix
    each."""
    return {"ops": matrix_sweeps * sweep_ops(k),
            "bytes": matrix_sweeps * sweep_bytes(k, itemsize)}

"""Each test worker runs one BLAS and one OpenMP thread.

Several workers share the cores, and OpenBLAS's and OpenMP's pools
busy-wait: a pool per core in every worker oversubscribes the machine many
times over.  The repository's root ``conftest.py`` holds them to
``OPENBLAS_NUM_THREADS`` and ``OMP_NUM_THREADS``; this test fails if a later
change (a plugin, a conftest that imports numpy or torch before the variables
are set, a setting moved after the workers start) lets a pool keep its
default size.

Run as a script, the file makes the same check in a fresh interpreter.
"""

import os
import subprocess
import sys

import pytest


def _check_pools():
    import numpy  # noqa: F401  (numpy's OpenBLAS)
    import scipy.linalg  # noqa: F401  (scipy's OpenBLAS, which jaxlib's LAPACK calls)
    import threadpoolctl
    import torch

    blas = int(os.environ["OPENBLAS_NUM_THREADS"])
    omp = int(os.environ["OMP_NUM_THREADS"])
    pools = threadpoolctl.threadpool_info()
    openblas = [p for p in pools if p["internal_api"] == "openblas"]
    openmp = [p for p in pools if p["user_api"] == "openmp"]
    assert openblas and openmp, pools
    assert [p["num_threads"] for p in openblas] == [blas] * len(openblas), openblas
    assert [p["num_threads"] for p in openmp] == [omp] * len(openmp), openmp
    assert torch.get_num_threads() == omp


def test_blas_openmp_and_torch_pools_hold_the_configured_counts():
    """Every OpenBLAS and OpenMP pool, and torch's own, holds the set count."""
    pytest.importorskip("threadpoolctl")
    if "PYTEST_XDIST_WORKER" in os.environ:
        _check_pools()
    else:
        # Without xdist, entry-point plugins (jaxtyping's) import numpy before
        # any conftest sets the counts: check a fresh interpreter started with
        # this environment, as xdist workers and child ranks are.
        subprocess.run([sys.executable, __file__], check=True, timeout=300)


if __name__ == "__main__":
    _check_pools()

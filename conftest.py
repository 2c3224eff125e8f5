"""Thread counts for every test run from this repository.

pytest loads this file before ``tests/conftest.py`` (and so before numpy,
scipy, jax or torch is imported there), and before it starts xdist workers.
"""

import os

# Several test worker processes share the cores, and the pools of numpy's and
# scipy's OpenBLAS and of torch's libgomp start one busy-waiting thread per
# core: hold each to one thread.  A pool reads its count when its library
# loads; xdist workers and child processes inherit the variables, and a caller
# may raise them from outside.
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")
os.environ.setdefault("OMP_NUM_THREADS", "1")

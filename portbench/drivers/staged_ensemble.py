"""Driver of the chi-staged disorder ensemble (``parallel.sweep.
evolve_batch_auto``): closed loop, one job at a time.

A job evolves ``realizations`` chains for ``periods`` periods from the Neel
state, each with fields uniform in [-h_max, h_max], through the chi ladder
(``chi_start``, ``growth``, ``chunk_periods``) up to the configuration's
cap.  The fields come from a pool of ``pool`` jobs that is the same for
every seed (the ladder's work depends on the fields); the run's seed
orders the pool, and the window cycles through it in that order.  Work:
``chain_periods``.  The check draws from the seed ``sample_jobs`` jobs of
the window and in each one chain of either half of the batch, evolves
their fields in the plain reference (complex128) and compares sz and the
Loschmidt echo at every period.  (max_chi is not compared: float32
Schmidt values at the noise floor, svd_min = 1e-7, fill the ladder's
padding, so the program reads ~50 above complex128 and the TF32 control
1-2: the number cannot tell the two apart.)
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import work
from portbench.reference import tebd as ref_tebd

POOL_SEED = 0x7C1A5   # the pool's fields are the same for every run seed


class Driver:
    def __init__(self, cell, seed_words, device):
        from timecrystal_tpu_torch.core.truncate import TruncParams
        from timecrystal_tpu_torch.parallel import sweep

        self.cfg, self.tr = cell.config, cell.traffic["params"]
        self.sample_jobs = int(cell.spec["check"]["sample_jobs"])
        self.seed, self.device, self.sweep = seed_words, device, sweep
        c = self.cfg
        self.L, self.R = int(c["n_sites"]), int(self.tr["realizations"])
        self.n = int(self.tr["periods"])
        self.spec = sweep.SweepSpec(
            L=self.L, chi=int(c["chi_max"]), n_periods=self.n, J=float(c["J"]),
            theta=float(c["theta_over_pi"]) * np.pi,
            tp=TruncParams(chi_max=0, svd_min=float(c["svd_min"]),
                           trunc_cut=float(c["trunc_cut"])),
            dtype="float32", frame=c["frame"])
        self.basis = np.arange(self.L) % 2                # Neel, site 0 up
        self.pool = int(self.tr["pool"])
        self.order = np.random.default_rng(seed_words).permutation(self.pool)
        self.jobs: dict = {}
        self.peak = None

    def fields(self, job: int) -> np.ndarray:
        """The fields [R, L] of window job ``job``: pool entry
        order[job % pool]."""
        k = int(self.order[int(job) % self.pool])
        rng = np.random.default_rng([POOL_SEED, k])
        h = float(self.cfg["h_max"])
        return rng.uniform(-h, h, (self.R, self.L))

    def _run(self, h):
        return self.sweep.evolve_batch_auto(
            h, np.full(len(h), float(self.cfg["tau"])), self.basis, self.spec,
            chi_start=int(self.tr["chi_start"]),
            chunk_periods=int(self.tr["chunk_periods"]),
            growth=float(self.tr["growth"]), device=self.device)

    def warmup(self) -> None:
        """The window's first job once: the ladder's shapes, the kernels'
        build and load."""
        self._run(self.fields(0))
        if self.device.type == "cuda":
            self.peak = work.peaks(torch.cuda.get_device_name(self.device))

    def job(self, i: int, spans) -> dict:
        h = self.fields(i)
        with spans.span("evolve_batch_auto"):
            traces, info = self._run(h)
        keep = {k: traces[k] for k in ("sz_sites", "loschmidt_echo")}
        self.jobs[i] = keep
        nominal = work.periods_work(self.L, traces["max_chi"][:, 1:], self.peak)
        ok = all(np.all(np.isfinite(v)) for v in keep.values())
        return {"chain_periods": self.R * self.n, "periods": self.R * self.n,
                "ladder_periods": self.n,
                "ladder_reruns": int(info["n_rerun_periods"]),
                "nominal_ops": nominal["ops"],
                "nominal_svd_s": nominal.get("svd_seconds", 0.0), "ok": ok}

    def sample(self, n_jobs: int) -> list:
        """(job, chain) pairs drawn from the seed: ``sample_jobs`` jobs of
        the ``n_jobs`` run, one chain from each half of each."""
        rng = np.random.default_rng(self.seed + [0x5A3B1E])
        half = self.R // 2
        out = []
        for j in rng.integers(0, n_jobs, self.sample_jobs):
            out += [(int(j), int(rng.integers(0, half))),
                    (int(j), int(rng.integers(half, self.R)))]
        return out

    def reference(self, items: list, precision: str = "complex128") -> dict:
        c = self.cfg
        h = np.stack([self.fields(j)[r] for j, r in items])
        return ref_tebd.evolve(
            h, float(c["tau"]), float(c["theta_over_pi"]) * np.pi, self.basis,
            self.n, float(c["J"]),
            dict(chi_cap=int(c["chi_max"]), svd_min=float(c["svd_min"]),
                 trunc_cut=float(c["trunc_cut"])),
            frame=c["frame"], precision=precision)

    def outputs(self, items: list) -> dict:
        return {k: np.stack([self.jobs[j][k][r] for j, r in items])
                for k in ("sz_sites", "loschmidt_echo")}

    def numbers(self, got: dict, ref: dict) -> dict:
        """The gaps compared: max over the sample of |d sz| and |d LE| at
        every period; NaN counts as infinitely far."""
        def gap(k):
            d = np.abs(np.asarray(got[k], float) - ref[k])
            return float(np.max(np.nan_to_num(d, nan=np.inf)))

        return {"sz": gap("sz_sites"), "echo": gap("loschmidt_echo")}

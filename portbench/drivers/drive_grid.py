"""Driver of the drive-strength diagram (``analysis.phase_diagram.
sweep_drive_grid``): closed loop, one whole grid at a time.

A job is the configuration's eps x h grid as one program (``chunk_size``
None), scoring included, with the project's disorder convention: one
MT19937 pattern from ``np.random.seed(RANDOM_SEED)`` scaled by h, and
RANDOM_SEED drawn anew for every job from the run's seed.  Work:
``grid_points``.  The check draws from the seed one job of the window and
compares three numbers:

  * ``sz`` and ``echo``: in two points of every eps row (one from either
    half of the h axis), evolved again by the plain reference
    (complex128), the widest gap in sz and in the Loschmidt echo over the
    periods before the reference first discards more than
    ``exact_trunc`` in a period (the reference stops a point there: after
    it, truncated dynamics takes float32 rounding as far from complex128
    as it takes TF32's);
  * ``score``: in every point of the job, the widest gap between the
    program's A2T and subharmonic weight and the frozen recipe
    (``reference.scoring``, float64) applied to the program's own
    staggered-magnetization trace, all 80 periods; a point whose
    verdict (every sample finite) differs reads infinitely far.

max_chi is not compared: in those rows the program's reads 11-12 above
complex128 and the TF32 control's 23.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import work
from portbench.reference import scoring, tebd as ref_tebd


class Driver:
    def __init__(self, cell, seed_words, device):
        from timecrystal_tpu_torch.analysis import phase_diagram

        self.pd = phase_diagram
        self.cfg, self.tr = cell.config, cell.traffic["params"]
        self.exact_trunc = float(cell.spec["check"]["exact_trunc"])
        self.seed, self.device = seed_words, device
        c = self.cfg
        self.eps = np.linspace(*c["eps_range"], int(c["n_eps"]))
        self.hs = np.linspace(*c["h_range"], int(c["n_h"]))
        self.L, self.n = int(c["n_sites"]), int(c["n_periods"])
        self.period = float(c["T_DRIVE"]) / float(c["J"])    # 2 tau
        self.times = np.arange(self.n + 1) * self.period
        self.jobs: dict = {}
        self.peak = None

    def random_seed(self, job: int) -> int:
        """The job's RANDOM_SEED, a 32-bit word from the run's seed."""
        ss = np.random.SeedSequence(self.seed + [int(job)])
        return int(ss.generate_state(1)[0])

    def params(self, job: int) -> dict:
        c = self.cfg
        return {"J": float(c["J"]), "T_DRIVE": float(c["T_DRIVE"]),
                "SVD_MIN": float(c["SVD_MIN"]),
                "SVD_CUTOFF": float(c["SVD_CUTOFF"]),
                "RANDOM_SEED": self.random_seed(job)}

    def _run(self, params, n_periods):
        return self.pd.sweep_drive_grid(
            self.eps, self.hs, params, chi_pad=int(self.cfg["chi_pad"]),
            n_sites=self.L, n_periods=n_periods, chunk_size=None,
            device=self.device)

    def warmup(self) -> None:
        """The whole grid for ``warmup_periods`` periods: every shape of a
        job's calls, the kernels' build and load, the scoring."""
        self._run(self.params(1 << 30), int(self.tr["warmup_periods"]))
        if self.device.type == "cuda":
            self.peak = work.peaks(torch.cuda.get_device_name(self.device))

    def job(self, i: int, spans) -> dict:
        with spans.span("sweep_drive_grid"):
            res = self._run(self.params(i), self.n)
        tr = res["traces"]
        keep = {k: tr[k] for k in ("sz_sites", "loschmidt_echo",
                                   "staggered_magnetization")}
        keep["A2T"] = np.asarray(res["A2T"], float).ravel()
        keep["weight"] = np.asarray(res["subharmonic_weight"], float).ravel()
        keep["success"] = np.array([r["success"] for r in res["records"]])
        self.jobs[i] = keep
        nominal = work.periods_work(self.L, tr["max_chi"][:, 1:], self.peak)
        P = len(keep["A2T"])
        ok = all(np.all(np.isfinite(keep[k])) for k in
                 ("sz_sites", "loschmidt_echo", "A2T", "weight"))
        return {"grid_points": P, "periods": self.n,
                "nominal_ops": nominal["ops"],
                "nominal_svd_s": nominal.get("svd_seconds", 0.0), "ok": ok}

    def sample(self, n_jobs: int) -> list:
        """(job, point) pairs drawn from the seed: one job of the ``n_jobs``
        run, and in it one point of either half of the h axis in every
        eps row (points in row-major eps x h order)."""
        rng = np.random.default_rng(self.seed + [0x5A3B1E])
        job = int(rng.integers(0, n_jobs))
        nh, half = len(self.hs), len(self.hs) // 2
        out = []
        for e in range(len(self.eps)):
            out += [(job, e * nh + int(rng.integers(0, half))),
                    (job, e * nh + int(rng.integers(half, nh)))]
        return out

    def reference(self, items: list, precision: str = "complex128",
                  whole: bool = False) -> dict:
        """The reference's traces of the points ``items``; a point stops
        after its first period that discards more than ``exact_trunc``
        unless ``whole``."""
        c = self.cfg
        J, tau = float(c["J"]), float(c["T_DRIVE"]) / (2.0 * float(c["J"]))
        pattern = {}
        for j, _ in items:
            if j not in pattern:
                np.random.seed(self.random_seed(j))
                pattern[j] = np.random.uniform(-1.0, 1.0, self.L)
        nh = len(self.hs)
        h = np.stack([self.hs[p % nh] * J * pattern[j] for j, p in items])
        thetas = np.array([np.pi * (1.0 - self.eps[p // nh]) for _, p in items])
        return ref_tebd.evolve(
            h, tau, thetas, np.arange(self.L) % 2, self.n, J,
            dict(chi_cap=min(int(c["chi_max"]), int(c["chi_pad"])),
                 svd_min=float(c["SVD_MIN"]), trunc_cut=float(c["SVD_CUTOFF"])),
            frame=c["frame"], precision=precision,
            until_trunc=None if whole else self.exact_trunc)

    def outputs(self, items: list) -> dict:
        """The program's sz and echo at ``items`` and its scores, with its
        staggered traces, at every point of the jobs sampled."""
        out = {k: np.stack([self.jobs[j][k][p] for j, p in items])
               for k in ("sz_sites", "loschmidt_echo")}
        jobs = sorted({j for j, _ in items})
        out["scores"] = {k: np.concatenate([self.jobs[j][k] for j in jobs])
                         for k in ("staggered_magnetization", "A2T", "weight",
                                   "success")}
        return out

    def control_outputs(self, items: list, precision: str = "tf32") -> dict:
        """The control in the program's place: the reference's traces in
        ``precision`` and its scores by the recipe in float32."""
        ref = self.reference(items, precision, whole=True)
        sc = scoring.score_points(self.times, ref["staggered_magnetization"],
                                  self.period, torch.float32)
        sc["staggered_magnetization"] = ref["staggered_magnetization"]
        return {"sz_sites": ref["sz_sites"],
                "loschmidt_echo": ref["loschmidt_echo"], "scores": sc}

    def exact_rows(self, ref: dict) -> np.ndarray:
        """[points, periods + 1]: the rows before the reference's first
        period that discards more than ``exact_trunc``."""
        err = ref["trunc_err"]
        return np.cumsum((err > self.exact_trunc) | np.isnan(err), axis=1) == 0

    def numbers(self, got: dict, ref: dict) -> dict:
        """The gaps compared (NaN counts as infinitely far): max |d sz| and
        |d LE| over the exact rows; the widest score gap from the recipe."""
        exact = self.exact_rows(ref)

        def gap(k):
            d = np.abs(np.asarray(got[k], float) - ref[k])
            return float(np.max(np.nan_to_num(d, nan=np.inf)[exact]))

        sc = got["scores"]
        mine = scoring.score_points(self.times, sc["staggered_magnetization"],
                                    self.period)
        d = np.maximum(np.abs(sc["A2T"] - mine["A2T"]),
                       np.abs(sc["weight"] - mine["weight"]))
        d = np.where(np.asarray(sc["success"]) == mine["success"],
                     np.nan_to_num(d, nan=np.inf), np.inf)
        return {"sz": gap("sz_sites"), "echo": gap("loschmidt_echo"),
                "score": float(np.max(d))}

    def diagnostics(self, got: dict, items: list) -> dict:
        """What the readings report beside the numbers, never compared:
        the exact rows of each sampled point, and the widest gap in A2T at
        the sampled points against the recipe on the reference's whole
        complex128 traces, over every point and over those the reference
        holds exactly for every period."""
        ref = self.reference(items, whole=True)
        rows = self.exact_rows(ref).sum(1)
        mine = scoring.score_points(self.times, ref["staggered_magnetization"],
                                    self.period)
        per_job = len(self.hs) * len(self.eps)
        jobs = sorted({j for j, _ in items})
        a2t = np.array([got["scores"]["A2T"][jobs.index(j) * per_job + p]
                        for j, p in items])
        d = np.abs(a2t - mine["A2T"])
        whole = rows == self.n + 1
        return {"rows_min": int(rows.min()), "rows_median": float(np.median(rows)),
                "rows_max": int(rows.max()), "points_whole": int(whole.sum()),
                "a2t_all": float(d.max()),
                "a2t_whole": float(d[whole].max()) if whole.any() else None}

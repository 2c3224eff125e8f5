"""Driver of the saturated steady state of the disorder ensemble: closed
loop, one job at a time, each job continuing the last.

Warm-up (set-up): the configuration's ``realizations`` chains, with the
fields of ``ensemble-window``'s pool entry ``fields.entry`` (the same for
every seed), go from the Neel state to period ``settle.periods`` through
``evolve_batch_auto`` (``settle``'s ladder, ``cap_svd_method`` at the cap),
and the run continues from its exit state, ``info['state']`` (a program
whose ``info`` has none fails with a KeyError after the settle).  The
settle's report goes to standard error: the period from which chi stood at the cap and the cap-th Schmidt
value of the middle bond at the settle's end.  A second driver of the same
configuration in one process (the control's seeds) starts from the first
one's settled state: the settle is deterministic and most of the set-up.

A job: ``chunks`` chunks of ``chunk_periods`` periods, each one
``evolve_floquet_scan`` at the cap on ``cap_svd_method`` from the last
chunk's exit state, with the arguments ``evolve_batch_auto`` passes at the
cap; each chunk's traces reach the host.  Work: ``chain_periods``.  Each
record also holds the change over the job of the projected SVD's call
count and stage times (``ops.jacobi_svd``: ``topk_calls``,
``topk_<stage>_s``; none where the program has none of them) and, on a
card, of kernel 1's sweep counter (``topk_core_sweeps``: at the cap every
kernel-1 sweep is a sweep of a projected SVD's core) with those sweeps'
least work (``k1_core_ops``, ``k1_core_bytes``, ``portbench/core_work.py``;
the even and odd bond layers alternate, so a call's mean batch is
R (L - 1) / 2 cores).

The check: the seed draws one job of the window, by a seeded reservoir
draw (job i is kept, in place of the job kept before, when the i-th number
of the seed's stream is below 1 / (i + 1): the kept job is uniform over
the window, whatever its length), and one chain from either half.  The
kept job's start state (every chain, on the card) and its first chunk's
traces are compared with the plain reference (``reference.steady``):
  * ``sz``, ``echo``: the max gap over the first chunk between the timed
    path's traces and the reference continued from the same start state in
    complex128 with LAPACK's top-chi SVD.  The truncation at the cap lets
    two sound runs part by up to ~4 sqrt(w) in sz (w the discarded weight),
    so these limits are loose;
  * at the timed shape, the first half-step's thetas [R * n_even, 2 chi,
    2 chi] of every chain from that state, built by the reference: the
    program's ``csvd_topk(theta, chi, cap_svd_method)`` on the device
    against LAPACK's exact top-chi in complex128: ``sigma`` = max over i of
    |d sigma_i| / sigma_1, ``sigma_head`` the same over the largest chi/8
    alone, ``kept_gap`` = (the optimal top-chi weight - ||theta V||^2) /
    ||theta||^2, each the max over the matrices.  The projected SVD does
    not resolve the singular values near the cut (its projection leak; up
    to ~1e-4 sigma_1 at chi = 256) in any precision, so ``sigma`` is loose;
    the head is where float32 and TF32 part (~1e-6 against ~3e-4 sigma_1:
    TF32's rounding moves sigma_1 itself).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from portbench import core_work, work
from portbench.control import _NoSpans
from portbench.drivers.staged_ensemble import POOL_SEED
from portbench.reference import steady as ref_steady

DRAW_TAG = 0x57EAD1     # the seed's stream of the check's draws
MAX_JOBS = 1 << 16      # jobs the reservoir draw can keep
TRACE_KEYS = ("sz_sites", "loschmidt_echo")
_SETTLED: dict = {}     # configuration -> (state, report), one per process


class Driver:
    def __init__(self, cell, seed_words, device):
        from timecrystal_tpu_torch.core.truncate import TruncParams

        c, t = cell.config, cell.traffic["params"]
        if device.type == "cuda" and device.index is None:
            # the program's device counters are kept per indexed device
            device = torch.device("cuda", torch.cuda.current_device())
        self.cfg, self.device, self.seed = c, device, seed_words
        self.L, self.R = int(c["n_sites"]), int(c["realizations"])
        self.chi, self.method = int(c["chi_max"]), str(c["cap_svd_method"])
        self.chunk, self.chunks = int(t["chunk_periods"]), int(t["chunks"])
        self.theta = float(c["theta_over_pi"]) * np.pi
        self.tp = TruncParams(chi_max=0, svd_min=float(c["svd_min"]),
                              trunc_cut=float(c["trunc_cut"]))
        self.cdtype = {"complex64": torch.complex64,
                       "complex128": torch.complex128}[c["precision"]]
        self.basis = np.arange(self.L) % 2                # Neel, site 0 up
        rng = np.random.default_rng([POOL_SEED, int(c["fields"]["entry"])])
        h = float(c["h_max"])
        self.h = rng.uniform(-h, h, (self.R, self.L))
        stream = np.random.default_rng(seed_words + [DRAW_TAG])
        self.draws = stream.random(MAX_JOBS)
        half = self.R // 2
        self.rows = (int(stream.integers(0, half)),
                     int(stream.integers(half, self.R)))
        self.psi = None
        self.done = 0                # jobs run
        self.kept = None             # (job, start MPS, first chunk's traces)
        self.report: dict = {}
        self.peak = None
        self._counts: dict = {}
        self._theta = None

    # -- the settle -------------------------------------------------------

    def _settle(self):
        from timecrystal_tpu_torch.parallel import sweep

        c, s = self.cfg, self.cfg["settle"]
        spec = sweep.SweepSpec(
            L=self.L, chi=self.chi, n_periods=int(s["periods"]),
            J=float(c["J"]), theta=self.theta, tp=self.tp,
            dtype="float32" if self.cdtype == torch.complex64 else "float64",
            frame=c["frame"])
        _, info = sweep.evolve_batch_auto(
            self.h, np.full(self.R, float(c["tau"])), self.basis, spec,
            chi_start=int(s["chi_start"]), chunk_periods=int(s["chunk_periods"]),
            growth=float(s["growth"]), cap_svd_method=self.method,
            device=self.device)
        psi = info["state"]
        if info["chi_pad_used"] < self.chi:
            raise RuntimeError(f"the settle ended at chi {info['chi_pad_used']}, "
                               f"below the cap {self.chi}")
        at_cap = [e["period"] for e in info["chi_escalations"]
                  if e["to"] >= self.chi]
        last = psi.lam[:, self.L // 2, self.chi - 1].double().cpu().numpy()
        report = {"cap_from_period": at_cap[0] if at_cap else 0,
                  "escalations": len(info["chi_escalations"]),
                  "rerun_periods": int(info["n_rerun_periods"]),
                  "sigma_cap_mid_min": float(last.min()),
                  "sigma_cap_mid_median": float(np.median(last)),
                  "sigma_cap_mid_max": float(last.max())}
        print(f"settle: chi {self.chi} from period {report['cap_from_period']} "
              f"of {s['periods']} ({report['escalations']} escalations, "
              f"{report['rerun_periods']} periods run again); "
              f"sigma_{self.chi} of the middle bond at period {s['periods']}: "
              f"min {report['sigma_cap_mid_min']!r} median "
              f"{report['sigma_cap_mid_median']!r} max "
              f"{report['sigma_cap_mid_max']!r} (svd_min {c['svd_min']!r})",
              file=sys.stderr)
        return psi, report

    def warmup(self) -> None:
        """The settle to the cap, which runs every shape of a job: the
        chunks at the cap are the jobs' calls."""
        from timecrystal_tpu_torch.core.mps import product_state
        from timecrystal_tpu_torch.models.kicked_ising import make_floquet_gates

        if self.psi is not None:
            return
        key = (str(self.device), json.dumps(self.cfg, sort_keys=True))
        if key not in _SETTLED:
            _SETTLED[key] = self._settle()
        # the jobs make new tensors and leave the settled state as it is
        self.psi, self.report = _SETTLED[key]
        rdtype = self.cdtype.to_real()
        self.gates = make_floquet_gates(
            float(self.cfg["J"]),
            torch.as_tensor(self.h, dtype=rdtype, device=self.device),
            torch.as_tensor(np.full(self.R, float(self.cfg["tau"])),
                            dtype=rdtype, device=self.device),
            theta=self.theta, dtype=self.cdtype)
        self.psi0 = product_state(np.broadcast_to(self.basis, (self.R, self.L)),
                                  chi=self.chi, dtype=self.cdtype,
                                  device=self.device)
        self.tp_cap = self.tp._replace(svd_method=self.method)
        if self.device.type == "cuda":
            self.peak = work.peaks(torch.cuda.get_device_name(self.device))
        self._counts = self._program_counts()

    # -- the jobs ---------------------------------------------------------

    def _program_counts(self) -> dict:
        """The projected SVD's call count and stage seconds and, on a card,
        kernel 1's sweep count now (one host read of the device counter);
        {} where the program has none of them."""
        from timecrystal_tpu_torch.ops import jacobi_svd

        out = {}
        calls = getattr(jacobi_svd, "CORE_SVD_CALLS", None)
        clock = getattr(jacobi_svd, "CORE_STAGES", None)
        if calls is not None:
            out["topk_calls"] = float(calls)
            if self.device.type == "cuda":
                out["topk_core_sweeps"] = float(
                    jacobi_svd.sweep_counter(self.device))
        if clock is not None:
            out.update({f"topk_{k}_s": v for k, v in clock.seconds().items()})
        return out

    def _keeps(self, i: int) -> bool:
        return i < MAX_JOBS and self.draws[i] < 1.0 / (i + 1)

    def job(self, i: int, spans) -> dict:
        self.warmup()
        while self.done < i:         # the control asks for a later job
            self._job(self.done, _NoSpans())
        return self._job(i, spans)

    def _job(self, i: int, spans) -> dict:
        from timecrystal_tpu_torch.core.mps import MPS
        from timecrystal_tpu_torch.dynamics import tebd

        keep = self._keeps(i)
        if keep:
            if self.kept is None:
                start = MPS(B=torch.empty_like(self.psi.B),
                            lam=torch.empty_like(self.psi.lam))
            else:
                start = self.kept[1]
            start.B.copy_(self.psi.B)
            start.lam.copy_(self.psi.lam)
        psi, first, max_chi, ok = self.psi, None, [], True
        for c in range(self.chunks):
            with spans.span("evolve_floquet_scan"):
                psi, tr = tebd.evolve_floquet_scan(
                    psi, self.gates, self.chunk, self.tp_cap,
                    ref_state=self.psi0, frame=self.cfg["frame"])
                tr = tebd.to_host(tr)
            first = tr if first is None else first
            max_chi.append(tr["max_chi"])
            ok = ok and all(np.all(np.isfinite(tr[k])) for k in TRACE_KEYS)
        self.psi = psi
        if keep:
            self.kept = (i, start, {k: first[k] for k in TRACE_KEYS})
            self._theta = None
        self.done = i + 1
        n = self.chunk * self.chunks
        nominal = work.periods_work(self.L, np.concatenate(max_chi, 1), self.peak)
        rec = {"chain_periods": self.R * n, "periods": self.R * n,
               "nominal_ops": nominal["ops"],
               "nominal_svd_s": nominal.get("svd_seconds", 0.0), "ok": bool(ok)}
        now = self._program_counts()
        rec.update({k: v - self._counts[k] for k, v in now.items()})
        self._counts = now
        if "topk_core_sweeps" in rec:
            cores = rec["topk_core_sweeps"] * self.R * (self.L - 1) / 2
            w = core_work.sweeps_work(cores, self.chi,
                                      self.psi.B.element_size())
            rec["k1_core_ops"], rec["k1_core_bytes"] = w["ops"], w["bytes"]
        return rec

    # -- the check --------------------------------------------------------

    def sample(self, n_jobs: int) -> list:
        """[(job, chain), (job, chain)]: the job the reservoir draw keeps
        after ``n_jobs`` jobs, one chain of either half."""
        j = max(i for i in range(max(min(int(n_jobs), MAX_JOBS), 1))
                if self._keeps(i))
        return [(j, self.rows[0]), (j, self.rows[1])]

    def _start(self, items):
        j = items[0][0]
        if self.kept is None or self.kept[0] != j:
            raise RuntimeError(f"job {j} was not kept")
        return self.kept[1]

    def thetas(self, items) -> torch.Tensor:
        """The sampled job's entry thetas of every chain, complex128 on the
        host (built once)."""
        if self._theta is None:
            st = self._start(items)
            self._theta = ref_steady.entry_thetas(
                st.B.cpu(), st.lam.cpu(), self.h, float(self.cfg["tau"]),
                float(self.cfg["J"]))
        return self._theta

    def outputs(self, items: list) -> dict:
        from timecrystal_tpu_torch.ops.csvd import csvd_topk

        self._start(items)
        rows = [r for _, r in items]
        got = {k: self.kept[2][k][rows] for k in TRACE_KEYS}
        theta = self.thetas(items).to(self.cdtype).to(self.device)
        S, Vh, _ = csvd_topk(theta, self.chi, method=self.method)
        got["S"] = S.double().cpu()
        got["V"] = Vh.mH.cpu()
        return got

    def reference(self, items: list, precision: str = "complex128") -> dict:
        c = self.cfg
        st = self._start(items)
        rows = [r for _, r in items]
        idx = torch.as_tensor(rows, device=st.B.device)
        out = ref_steady.continue_merged(
            st.B[idx].cpu(), st.lam[idx].cpu(), self.h[rows], float(c["tau"]),
            self.theta, self.basis, self.chunk, float(c["J"]),
            dict(chi_cap=self.chi, svd_min=float(c["svd_min"]),
                 trunc_cut=float(c["trunc_cut"])), precision=precision)
        out["S"], out["V"] = ref_steady.topk(self.thetas(items), self.chi,
                                             precision)
        return out

    def numbers(self, got: dict, ref: dict) -> dict:
        """The gaps compared; NaN counts as infinitely far."""
        def worst(d):
            d = np.asarray(d, float)
            return float(np.max(np.nan_to_num(d, nan=np.inf)))

        theta = self._theta
        S_ref = ref["S"]
        d_sigma = (got["S"] - S_ref).abs() / S_ref[:, :1]
        head = max(self.chi // 8, 1)
        norm2 = (theta.real ** 2 + theta.imag ** 2).sum((-2, -1))
        gap = ((S_ref ** 2).sum(-1) - ref_steady.kept_weight(theta, got["V"])) / norm2
        return {"sz": worst(np.abs(np.asarray(got["sz_sites"], float)
                                   - ref["sz_sites"])),
                "echo": worst(np.abs(np.asarray(got["loschmidt_echo"], float)
                                     - ref["loschmidt_echo"])),
                "sigma": worst(d_sigma.numpy()),
                "sigma_head": worst(d_sigma[:, :head].numpy()),
                "kept_gap": worst(gap.numpy())}

    def diagnostics(self, got: dict, items: list) -> dict:
        """The settle's report and the sampled job."""
        return dict(self.report, job=items[0][0])

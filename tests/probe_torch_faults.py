"""Measurements behind the settled faults of the port (PERF.md), on the
CPU, both packages on the same inputs.  Not a test: it prints.

    python tests/probe_torch_faults.py ns
    python tests/probe_torch_faults.py drift [--L 16] [--chi 48] [--cap 24]
        [--periods 16] [--points 0.2:0.8,0.2:0.4,0.171:0.6]
    python tests/probe_torch_faults.py memory [--periods 100]
        [--rows 2:0:0,2:0:1,2:0:2,2:0:3,5:0:0] [--skip-jax]
    python tests/probe_torch_faults.py lindblad

``ns``: iterations of 'jacobi_core''s adaptive NS polish (cap 12, exit 5e-6)
in both packages on the same complex64 V of [B, 512, 512] inputs, k = 256 (a
steep TEBD-like spectrum and the dense logspace(0, -7)), and of each
package's whole jacobi_core on a [1, 512, 512] input (the JAX package's
Pallas kernel in interpret mode).

``drift``: drive-grid points (eps:h pairs; the reference's seed-42 pattern,
T_DRIVE 2) through evolve_batch in float32 with 'jacobi' (the port's torch
twin, the JAX package's Pallas kernel in interpret mode) and with LAPACK,
each held against complex128 LAPACK: max |d sz| before truncation and per
point over all rows, and each float32 'jacobi' run's distance over the
port's complex64 LAPACK run's (the witness of chip_smoke.py's
[drive-diagram]).

``memory``: rows of the memory figure's eps scan at its defaults (eps
index : realization : trajectory of eps in (0, 0.02, 0.04, 0.06, 0.09,
0.12), gamma 0.02, 3 realizations x 12 trajectories, L=16, chi=48, tau=1,
seed 42, the scan's noise ``memory_noise(..., 0)``) through the stochastic
channel: the port in complex128 and complex64 with LAPACK, and the JAX
package in float32 with its Pallas kernel in interpret mode, fed the same
noise (its key stream replaced by a table of the port's draws).  Printed
as the drift command: each run's max |d sz| from complex128 before the
reference truncates and per row, and JAX over the complex64 LAPACK witness
(chip_smoke.py's MEMORY_JAX_OVER_WITNESS).

``lindblad``: chip_smoke.py's [lindblad] run (|+><+|^6 as a superket, chi
64, a transverse-field chain, gamma 0.08, 20 Strang steps of dt 0.05) in
the JAX package in float32 with LAPACK (its CPU 'auto') and with its Pallas
kernel (interpret mode, what the TPU runs), and in the port in complex64
and complex128 with LAPACK: the Schmidt values each keeps per bond at the
end (svd_min 1e-12) and its max |d <sz_i>| from complex128 over the steps.
"""

import argparse
import os
import sys
import time
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from timecrystal_tpu.core.truncate import TruncParams as JTruncParams  # noqa: E402
from timecrystal_tpu.ops.cpx import C  # noqa: E402
from timecrystal_tpu.ops.pallas import jacobi_svd as JJ  # noqa: E402
from timecrystal_tpu.parallel import sweep as jsw  # noqa: E402
from timecrystal_tpu_torch.core.truncate import TruncParams  # noqa: E402
from timecrystal_tpu_torch.ops import jacobi_svd as TJ  # noqa: E402
from timecrystal_tpu_torch.parallel import sweep as tsw  # noqa: E402

SPECTRA = {"steady": 10.0 ** (-4.44 * np.arange(512) / 256),
           "dense": np.logspace(0, -7, 512)}


def haar_panels(s, B, seed=11):
    """complex64 [B, n, n] = Q1 diag(s) Q2^H (RandomState Haar draws)."""
    rng = np.random.RandomState(seed)
    n = len(s)
    out = np.zeros((B, n, n), np.complex64)
    for i in range(B):
        q1, _ = np.linalg.qr(rng.randn(n, n) + 1j * rng.randn(n, n))
        q2, _ = np.linalg.qr(rng.randn(n, n) + 1j * rng.randn(n, n))
        out[i] = (q1 * s) @ q2.conj().T
    return out


def jax_polish_iterations(V, k, cap=12, tol=5e-6):
    count = [0]

    def loop(cond, body, carry):
        while bool(cond(carry)):
            carry = body(carry)
            count[0] += 1
        return carry

    with mock.patch.object(jax.lax, "while_loop", loop):
        JJ._ns_polish_adaptive(C(jnp.asarray(V.real), jnp.asarray(V.imag)),
                               k, cap, tol)
    return count[0]


def torch_polish_iterations(V, k, cap=12, tol=5e-6):
    reads = []
    orig = torch.Tensor.__float__

    def counting(t):
        reads.append(1)
        return orig(t)

    with mock.patch.object(torch.Tensor, "__float__", counting):
        TJ._ns_polish_adaptive(torch.as_tensor(V), k, cap, tol)
    return len(reads)


def defect(V, k):
    P = V.conj().swapaxes(-1, -2) @ V
    return float(np.abs(P - np.eye(k)).max())


def probe_ns():
    k = 256
    for name, s in SPECTRA.items():
        M = haar_panels(s, 4)
        _, V, _ = TJ.jacobi_core(torch.as_tensor(M), k, polish_iters=0)
        V = V.numpy()
        print(f"[ns] {name}, [4, 512, 512], the same V (defect "
              f"{defect(V, k):.3f}): port {torch_polish_iterations(V, k)}, "
              f"JAX {jax_polish_iterations(V, k)} iterations", flush=True)
        M = M[:1]
        _, Vj, _ = JJ.jacobi_core(C(jnp.asarray(M.real), jnp.asarray(M.imag)),
                                  k, polish_iters=0, interpret=True)
        Vj = np.asarray(Vj.re) + 1j * np.asarray(Vj.im)
        _, Vt, _ = TJ.jacobi_core(torch.as_tensor(M), k, polish_iters=0)
        Vt = Vt.numpy()
        print(f"[ns] {name}, [1, 512, 512], each package's own V (defect "
              f"{defect(Vt, k):.3f} / {defect(Vj, k):.3f}): port "
              f"{torch_polish_iterations(Vt, k)}, JAX "
              f"{jax_polish_iterations(Vj, k)} iterations", flush=True)


def probe_drift(L, chi, cap, n_periods, points):
    np.random.seed(42)
    base = np.random.uniform(-1.0, 1.0, L)
    eps = np.array([p[0] for p in points])
    h = np.array([p[1] for p in points])[:, None] * base[None, :]
    taus, thetas = np.ones(len(points)), np.pi * (1.0 - eps)
    basis = jsw._basis_indices(L, "neel")

    def port(dtype, method):
        spec = tsw.SweepSpec(L=L, chi=chi, n_periods=n_periods, dtype=dtype,
                             tp=TruncParams(chi_max=cap, svd_min=1e-12,
                                            trunc_cut=1e-7, svd_method=method))
        return tsw.evolve_batch(h, taus, basis, spec, thetas=thetas,
                                device="cpu")

    def jax_run(method):
        spec = jsw.SweepSpec(L=L, chi=chi, n_periods=n_periods, dtype="float32",
                             tp=JTruncParams(chi_max=cap, svd_min=1e-12,
                                             trunc_cut=1e-7, svd_method=method))
        out = jsw.evolve_batch(jnp.asarray(h), jnp.asarray(taus),
                               jnp.asarray(basis), spec,
                               thetas=jnp.asarray(thetas))
        return {k: np.asarray(v) for k, v in out.items()}

    ref = port("float64", "native")
    exact = np.cumsum(ref["trunc_err"] > 1e-8, axis=1) == 0
    print(f"[drift] L={L} chi_pad={chi} cap={cap} {n_periods} periods, points "
          f"(eps, h) {points}: rows before truncation {exact.sum(1).tolist()}",
          flush=True)
    runs = (("port complex64 'jacobi' (twin)", lambda: port("float32", "jacobi")),
            ("JAX float32 'jacobi' (interpret)", lambda: jax_run("jacobi")),
            ("port complex64 LAPACK", lambda: port("float32", "native")),
            ("JAX float32 LAPACK", lambda: jax_run("native")))
    per_point = {}
    for name, run in runs:
        t0 = time.perf_counter()
        d = np.abs(run()["sz_sites"] - ref["sz_sites"])
        per_point[name] = d.reshape(len(points), -1).max(1)
        print(f"[drift] {name}: max |d sz| before truncation "
              f"{d[exact].max():.2e}, all rows per point "
              f"{[f'{x:.2e}' for x in per_point[name]]} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
    witness = per_point["port complex64 LAPACK"]
    for name in list(per_point)[:2]:
        print(f"[drift] {name} over port complex64 LAPACK, per point: "
              f"{[f'{x:.3g}' for x in per_point[name] / witness]}", flush=True)


def probe_memory(n_periods, rows, skip_jax):
    from timecrystal_tpu.dynamics import open_system as jos
    from timecrystal_tpu.core.mps import create_initial_state as jax_state
    from timecrystal_tpu.models.kicked_ising import \
        make_floquet_gates as jax_gates
    from timecrystal_tpu_torch.analysis import memory as tmem
    from timecrystal_tpu_torch.core.mps import create_initial_state
    from timecrystal_tpu_torch.dynamics.open_system import \
        _evolve_stochastic_scan
    from timecrystal_tpu_torch.models.kicked_ising import make_floquet_gates

    eps_values = np.array([0.0, 0.02, 0.04, 0.06, 0.09, 0.12])
    L, chi, R, T, gamma, tau = 16, 48, 3, 12, 0.02, 1.0
    idx = np.array([(e * R + r) * T + t for e, r, t in rows])
    N = len(eps_values) * R * T
    noise = tmem.memory_noise(N, n_periods, L, 0)[idx]
    h = tmem.disorder_rows(L, 0.3, 1.0, 42, R, T, len(eps_values))[idx]
    thetas = np.repeat(np.pi * (1.0 - eps_values), R * T)[idx]
    gdt = gamma * 2.0 * tau

    def port(dtype, method):
        real = dtype.to_real()
        gates = make_floquet_gates(1.0, torch.as_tensor(h, dtype=real), tau,
                                   theta=torch.as_tensor(thetas, dtype=real),
                                   dtype=dtype)
        psi0 = create_initial_state(L, "neel", chi=chi, dtype=dtype,
                                    device="cpu")
        _, tr = _evolve_stochastic_scan(
            psi0, gates, noise, gdt, n_periods,
            TruncParams(chi_max=0, svd_min=1e-7, svd_method=method))
        return {k: v.numpy() for k, v in tr.items()}

    def jax_run(method):
        table = jnp.asarray(noise)

        def split(key, num=2):
            return jnp.stack([key + jnp.asarray([0, 1], key.dtype), key])

        def normal(key, shape=(), dtype=jnp.float32):
            return table[key[0], key[1]].astype(dtype)

        psi0 = jax_state(L, "neel", chi=chi, dtype=jnp.float32)
        tp = JTruncParams(chi_max=0, svd_min=1e-7, svd_method=method)

        def row(key, h_row, theta):
            gates = jax_gates(1.0, h_row, tau, theta=theta, dtype=jnp.float32)
            return jos._evolve_stochastic_scan(psi0, gates, key, gdt,
                                               n_periods, tp)[2]

        keys = jnp.stack([jnp.arange(len(idx), dtype=jnp.uint32),
                          jnp.zeros(len(idx), jnp.uint32)], 1)
        with mock.patch.object(jax.random, "split", split), \
                mock.patch.object(jax.random, "normal", normal):
            out = jax.vmap(row)(keys, jnp.asarray(h, jnp.float32),
                                jnp.asarray(thetas, jnp.float32))
        return {k: np.asarray(v) for k, v in out.items()}

    t0 = time.perf_counter()
    ref = port(torch.complex128, "native")
    exact = np.cumsum(ref["trunc_err"] > 1e-8, axis=1) == 0
    print(f"[memory] L={L} chi={chi} gamma={gamma} {n_periods} periods, rows "
          f"(eps, realization, trajectory) "
          f"{[(float(eps_values[e]), r, t) for e, r, t in rows]}: rows before "
          f"the complex128 reference truncates (> 1e-8 a period) "
          f"{exact.sum(1).tolist()}, its max trunc_err a row "
          f"{[f'{x:.2e}' for x in ref['trunc_err'].max(1)]}, max_chi "
          f"{ref['max_chi'].max(1).tolist()} ({time.perf_counter() - t0:.0f} s)",
          flush=True)
    runs = [("port complex64 LAPACK", lambda: port(torch.complex64, "native"))]
    if not skip_jax:
        runs.append(("JAX float32 'jacobi' (interpret)", lambda: jax_run("jacobi")))
    per_row = {}
    for name, run in runs:
        t0 = time.perf_counter()
        d = np.abs(run()["sz_sites"] - ref["sz_sites"])
        per_row[name] = d.reshape(len(idx), -1).max(1)
        print(f"[memory] {name}: max |d sz| before truncation "
              f"{d[exact].max():.2e}, all rows per row "
              f"{[f'{x:.2e}' for x in per_row[name]]} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
    witness = per_row["port complex64 LAPACK"]
    for name in list(per_row)[1:]:
        print(f"[memory] {name} over port complex64 LAPACK, per row: "
              f"{[f'{x:.3g}' for x in per_row[name] / witness]}", flush=True)


def probe_lindblad():
    from timecrystal_tpu.core.mps import MPS as JMPS
    from timecrystal_tpu.dynamics import open_system as jos
    from timecrystal_tpu.dynamics.tebd import spin_chain_model as jax_chain
    from timecrystal_tpu.ops.cpx import C as JC
    from timecrystal_tpu_torch.core.mps import MPS
    from timecrystal_tpu_torch.dynamics import open_system as tos
    from timecrystal_tpu_torch.dynamics.tebd import spin_chain_model

    L, chi, gamma, dt, n = 6, 64, 0.08, 0.05, 20
    kw = dict(Jz=1.0, hx=0.4, hz=0.2)
    sz = np.diag([1.0, -1.0]).astype(complex)

    def port(dtype):
        rho = tos.density_mps_from_product(np.zeros(L, np.int32), chi,
                                           dtype=dtype, device="cpu")
        B = rho.B.clone()
        B[:, 0, :, 0] = 0.5
        rhos, _, _ = tos.LindbladEvolution(spin_chain_model(L, **kw), gamma,
                                           max_chi=chi, dtype=dtype,
                                           device="cpu").evolve(
            MPS(B=B, lam=rho.lam), n * dt, dt)
        return ((rhos[-1].lam > 0).sum(-1).tolist(),
                np.array([tos.expectation_rho_one_site(r, sz).real
                          for r in rhos]))

    def jax_run(method):
        rho = jos.density_mps_from_product(np.zeros(L, np.int32), chi,
                                           jnp.float32)
        B_re = rho.B.re.at[:, 0, :, 0].set(0.5)
        tp = JTruncParams(chi_max=chi, svd_min=1e-12, renormalize=False,
                          svd_method=method)
        with mock.patch.object(jos, "TruncParams", lambda **k: tp):
            rhos, _, _ = jos.LindbladEvolution(
                jax_chain(L, **kw), gamma, max_chi=chi,
                dtype=jnp.float32).evolve(JMPS(B=JC(B_re, rho.B.im),
                                               lam=rho.lam), n * dt, dt)
        return ((np.asarray(rhos[-1].lam) > 0).sum(-1).tolist(),
                np.array([jos.expectation_rho_one_site(r, sz).real
                          for r in rhos]))

    _, ref = port(torch.complex128)
    for name, run in (("port complex128 LAPACK", lambda: port(torch.complex128)),
                      ("port complex64 LAPACK", lambda: port(torch.complex64)),
                      ("JAX float32 LAPACK", lambda: jax_run("native")),
                      ("JAX float32 'jacobi' (interpret)",
                       lambda: jax_run("jacobi"))):
        t0 = time.perf_counter()
        kept, z = run()
        print(f"[lindblad] {name}: Schmidt values kept per bond {kept}, max "
              f"|d <sz_i>| from complex128 {np.abs(z - ref).max():.2e} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("ns", "drift", "memory", "lindblad"))
    ap.add_argument("--L", type=int, default=16)
    ap.add_argument("--chi", type=int, default=48)
    ap.add_argument("--cap", type=int, default=24)
    ap.add_argument("--periods", type=int, default=16)
    ap.add_argument("--points", default="0.2:0.8,0.2:0.4,0.171:0.6")
    ap.add_argument("--rows", default="2:0:0,2:0:1,2:0:2,2:0:3,5:0:0")
    ap.add_argument("--skip-jax", action="store_true")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    if args.what == "ns":
        probe_ns()
    elif args.what == "lindblad":
        probe_lindblad()
    elif args.what == "memory":
        rows = [tuple(int(x) for x in r.split(":")) for r in args.rows.split(",")]
        probe_memory(args.periods, rows, args.skip_jax)
    else:
        points = [tuple(float(x) for x in p.split(":"))
                  for p in args.points.split(",")]
        probe_drift(args.L, args.chi, args.cap, args.periods, points)


if __name__ == "__main__":
    main()

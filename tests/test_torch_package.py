"""Packaging contract of the port: no JAX at run time, the kernel source
ships under csrc/, and the kernel builds for sm_90a into an ignored
directory."""

import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import timecrystal_tpu_torch
from timecrystal_tpu_torch import convert
from timecrystal_tpu_torch.analysis import figures, memory, phase_diagram
from timecrystal_tpu_torch.core import gates, mps, observables, truncate
from timecrystal_tpu_torch.dynamics import ground_state, open_system, tdvp, tebd
from timecrystal_tpu_torch.examples import multihost_demo, phase_diagram_hires, quickstart
from timecrystal_tpu_torch.models import kicked_ising, long_range
from timecrystal_tpu_torch.ops import cuda_build
from timecrystal_tpu_torch.parallel import multihost, site_shard, sweep
from timecrystal_tpu_torch.utils import checkpoint

ENTRY_POINTS = [
    mps.product_state, mps.create_initial_state, gates.gate_from_numpy,
    gates.pauli_c, gates.pi_pulse_gate, gates.x_rotation_gate,
    observables.staggered_signs, truncate.swap_gate, convert.complex_from_pair,
    convert.mps_from_numpy, convert.gates_from_numpy, convert.mpo_from_numpy,
    kicked_ising.KickedIsingModel, sweep.evolve_batch_auto, sweep.evolve_batch,
    sweep.disorder_ensemble, sweep.ensemble_a2t, tdvp.build_mpo,
    tdvp.spin_chain_mpo, tdvp.ising_fields_mpo, tdvp.TDVPEvolution,
    tdvp.TDVPEvolution.from_spin_chain, tdvp.TDVPFloquetEvolution,
    long_range.build_fsm_mpo, long_range.long_range_ising_mpo,
    long_range.LongRangeKickedIsing, long_range.scan_interaction_range,
    mps.haar_product_state, mps.from_dense_tensors,
    observables.dynamic_structure_factor, phase_diagram.calculate_phase_point,
    phase_diagram.sweep_phase_grid, phase_diagram.sweep_drive_grid,
    phase_diagram.generate_phase_diagram, phase_diagram.generate_drive_diagram,
    phase_diagram.generate_range_diagram, figures.simulate_perfect_dtc,
    figures.simulate_disordered_dtc, figures.simulate_dephasing_dtc,
    figures.simulate_multi_site_dtc, figures.generate_individual_figures,
    convert.noise_from_numpy, tebd.NearestNeighborModel.trotter_gates,
    tebd.NearestNeighborModel.bond_terms, ground_state.find_ground_state,
    open_system.LindbladEvolution, open_system.density_mps_from_product,
    open_system.vec_identity_mps, memory.memory_rows,
    memory.scan_memory_lifetime, memory.scan_memory_vs_eps,
    memory.generate_memory_figure, sweep.evolve_batch_sharded,
    sweep.default_mesh, multihost.evolve_batch_multihost,
    multihost.disorder_ensemble_multihost, multihost.global_mesh,
    site_shard.evolve_floquet_sharded, checkpoint.load_state,
    quickstart.single_chain, quickstart.ensemble, quickstart.correlator_map,
    quickstart.interaction_range, quickstart.memory_lifetime,
    phase_diagram_hires.hires_grid, multihost_demo.demo_ensemble,
    multihost_demo.rank_main,
]

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    """Importing every module of the port, in a fresh interpreter, pulls in
    neither jax nor the JAX package (it must run where JAX is absent); the
    walk reaches the checkpoint, profiling, multihost and site-shard
    modules and the three examples."""
    code = """
import importlib, pkgutil, sys
import timecrystal_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "timecrystal_tpu"))
print(len(names), bad)
assert len(names) >= 12, names
new = {"timecrystal_tpu_torch.utils.checkpoint",
       "timecrystal_tpu_torch.utils.profiling",
       "timecrystal_tpu_torch.parallel.multihost",
       "timecrystal_tpu_torch.parallel.site_shard",
       "timecrystal_tpu_torch.examples.quickstart",
       "timecrystal_tpu_torch.examples.phase_diagram_hires",
       "timecrystal_tpu_torch.examples.multihost_demo"}
assert new <= set(names), new - set(names)
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_and_smoke_name_no_jax_import():
    """No import statement anywhere in the port's modules or in
    chip_smoke.py -- at top level or inside a function, which the import
    check above cannot reach -- names jax or the JAX package."""
    import ast

    files = sorted((REPO / "timecrystal_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "timecrystal_tpu")]
    assert len(files) >= 13 and not bad, bad


def test_port_sets_full_precision_matmuls():
    import torch

    assert timecrystal_tpu_torch.__version__
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_kernel_source_ships_under_csrc():
    src = cuda_build.CSRC_DIR / "jacobi_sweep.cu"
    assert src.is_file()
    text = src.read_text()
    assert 'extern "C" int tct_jacobi_sweep_c64' in text
    assert 'extern "C" int tct_jacobi_sweep_c128' in text
    assert 'extern "C" int tct_jacobi_sweep_v_c64' in text
    assert 'extern "C" int tct_jacobi_sweep_v_c128' in text
    assert "cudaGetLastError" in text
    assert "csrc/*.cu" in (REPO / "pyproject.toml").read_text()


def test_build_command_targets_sm90a_into_an_ignored_directory():
    out = cuda_build.library_path("jacobi_sweep")
    cmd = cuda_build.nvcc_command(cuda_build.CSRC_DIR / "jacobi_sweep.cu", out)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and out.parent == cuda_build.BUILD_DIR
    rel = cuda_build.BUILD_DIR.relative_to(REPO).as_posix() + "/"
    ignored = [line.strip() for line in
               (REPO / ".gitignore").read_text().splitlines()]
    assert rel in ignored, (rel, ignored)
    # the library name tracks the source: an edited kernel is rebuilt
    assert out.name.startswith("jacobi_sweep-") and out.suffix == ".so"


@pytest.mark.parametrize("entry", ENTRY_POINTS, ids=lambda f: f.__qualname__)
def test_entry_points_default_to_the_card(entry):
    """Every entry point that builds state runs on the card unless the
    caller asks for the CPU: its ``device`` defaults to 'cuda'."""
    assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_default_device_never_falls_back_to_the_cpu():
    """Without a card a default call raises torch's own error; nothing probes
    for a GPU and quietly builds on the CPU."""
    if torch.cuda.is_available():
        psi = mps.create_initial_state(4)
        assert psi.device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError)):
        mps.create_initial_state(4)


def test_scaleout_meshes_default_to_the_card():
    """The meshes of the scale-out entry points are CUDA devices unless the
    caller names another; without a card they raise instead of falling
    back to the CPU, and mesh='auto' is no mesh."""
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in sweep.default_mesh().devices)
        assert multihost.global_mesh().devices[0].type == "cuda"
        return
    for make in (sweep.default_mesh, multihost.global_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert sweep.default_mesh("cpu").devices == (torch.device("cpu"),)
    assert multihost.global_mesh("cpu").world == 1
    # mesh='auto' shards only over several CUDA devices
    assert sweep.resolve_mesh("auto", "cpu") is None
    assert sweep.resolve_mesh("auto", "cuda") is None


def test_top_level_exports_the_ported_names():
    """The JAX package's top-level names that the port has are exported
    from the port's package too."""
    expected = {"MPS", "create_initial_state", "TruncParams", "CustomFloquet",
                "TEBDEvolution", "TDVPEvolution", "TDVPFloquetEvolution",
                "LindbladEvolution", "OpenSystemEvolution", "KickedIsingModel"}
    assert set(timecrystal_tpu_torch.__all__) == expected
    assert timecrystal_tpu_torch.CustomFloquet is sys.modules[
        "timecrystal_tpu_torch.dynamics.tebd"].CustomFloquet
    assert timecrystal_tpu_torch.MPS is mps.MPS
    assert timecrystal_tpu_torch.LindbladEvolution is open_system.LindbladEvolution
    from timecrystal_tpu_torch import dynamics
    assert {"TEBDEvolution", "NearestNeighborModel", "spin_chain_model",
            "find_ground_state", "imaginary_time_scan", "LindbladEvolution",
            "OpenSystemEvolution"} <= set(dynamics.__all__)

"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each kernel source ``csrc/<name>.cu`` exposes a plain C interface and is
compiled at first use, for Hopper (``sm_90a``), into ``_build/`` inside the
package (listed in ``.gitignore``).  The library name carries a hash of the
source and the flags, so an edited source is rebuilt and a stale library is
never loaded.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
                           "-Xcompiler", "-fPIC")


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float       # nvcc wall time; 0.0 when the library was cached
    log: str             # nvcc's output (ptxas register/spill report)
    command: tuple


_LOADED: dict = {}


def find_nvcc() -> str:
    """nvcc from PATH, else from $CUDA_HOME (default /usr/local/cuda)."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def nvcc_command(src: Path, out: Path, nvcc: str = "nvcc") -> list:
    """The nvcc command line that builds ``src`` into the shared library
    ``out``."""
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    """Content-addressed output path of kernel ``name`` under BUILD_DIR."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def load_kernel_library(name: str):
    """(ctypes.CDLL, BuildInfo) for ``csrc/<name>.cu``, building it first
    if no library for this exact source exists.  Raises RuntimeError with
    nvcc's output when the build fails."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC_DIR / f"{name}.cu"
    out = library_path(name)
    cmd = nvcc_command(src, out)
    if out.exists():
        info = BuildInfo(out, 0.0, "", tuple(cmd))
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = nvcc_command(src, tmp, find_nvcc())
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{src}:\n{log}")
        os.replace(tmp, out)     # atomic: concurrent builds never see half a file
        info = BuildInfo(out, seconds, log, tuple(cmd))
    lib = ctypes.CDLL(str(out))
    _LOADED[name] = (lib, info)
    return _LOADED[name]

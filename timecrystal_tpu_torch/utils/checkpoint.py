"""Checkpoint and resume for long evolutions and sweeps.

Port of ``timecrystal_tpu/utils/checkpoint.py``, npz only: the JAX package
prefers orbax when it is installed; here ``format='orbax'`` raises.  The
on-disk keys are the JAX package's (``B_re``, ``B_im``, ``lam`` and the
JSON metadata as bytes under ``__meta__``), so a state that
``timecrystal_tpu.utils.checkpoint.save_state(..., format='npz')`` wrote
loads here to the same tensors, leading ensemble axis included.

Every file is written to a temporary name and installed with
``os.replace``: a kill mid-write never leaves a truncated file behind.
Files are stored uncompressed (``np.savez``; np.load reads both forms): the
JAX package compresses, but a state of complex floats barely compresses,
and compression would cost host time after every chunk.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict

import numpy as np
import torch

from ..core.mps import MPS

_COMPLEX_OF = {np.dtype(np.float32): torch.complex64,
               np.dtype(np.float64): torch.complex128}


def fingerprint(*fields) -> str:
    """sha256 hex digest of ``repr(fields)``: what must match between a run
    and its resume."""
    return hashlib.sha256(repr(fields).encode()).hexdigest()


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _mps_to_arrays(psi: MPS) -> Dict[str, np.ndarray]:
    B = psi.B.detach().cpu().numpy()
    return {"B_re": np.ascontiguousarray(B.real),
            "B_im": np.ascontiguousarray(B.imag),
            "lam": psi.lam.detach().cpu().numpy()}


def _mps_from_arrays(d: Dict[str, np.ndarray], device, dtype) -> MPS:
    dtype = dtype or _COMPLEX_OF[np.dtype(d["B_re"].dtype)]
    real = dtype.to_real()
    B = torch.complex(torch.as_tensor(d["B_re"]).to(real),
                      torch.as_tensor(d["B_im"]).to(real))
    return MPS(B=B.to(device), lam=torch.as_tensor(d["lam"]).to(real).to(device))


def atomic_savez(path: str, **arrays) -> None:
    """np.savez through a temporary file and os.replace."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def save_state(path: str, psi: MPS, metadata: Dict[str, Any] | None = None,
               format: str = "npz") -> None:
    """Persist an MPS (any leading axes) and JSON-serializable metadata at
    ``path`` (``.npz`` appended unless present).  ``format`` 'npz' or
    'auto' (both npz); 'orbax' raises."""
    if format == "orbax":
        raise ValueError("the port writes npz checkpoints only; orbax is a "
                         "JAX package option")
    if format not in ("npz", "auto"):
        raise ValueError(f"unknown checkpoint format: {format!r}")
    meta = np.frombuffer(json.dumps(metadata or {}).encode(), np.uint8)
    atomic_savez(_npz_path(path), __meta__=meta, **_mps_to_arrays(psi))


def load_state(path: str, device="cuda", dtype=None):
    """(MPS on ``device``, metadata dict) from ``save_state``'s file or the
    JAX package's npz.  ``dtype`` None takes the complex type of the stored
    real parts (float32 -> complex64, float64 -> complex128)."""
    with np.load(_npz_path(path)) as z:
        meta = json.loads(bytes(z["__meta__"]).decode()) if "__meta__" in z else {}
        psi = _mps_from_arrays({k: z[k] for k in ("B_re", "B_im", "lam")},
                               torch.device(device), dtype)
    return psi, meta


def state_exists(path: str) -> bool:
    return os.path.exists(_npz_path(path))


class SweepCheckpointer:
    """Per-chunk results of a sweep plus a manifest, so an interrupted sweep
    resumes at its next chunk.

    ``fingerprint``: what must match between the run and its resume (grid,
    parameters, chunking).  A manifest written under another fingerprint
    makes ``completed_chunks`` raise instead of mixing misaligned chunks
    into the result."""

    def __init__(self, directory: str, fingerprint: str | None = None):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.manifest_path = os.path.join(directory, "manifest.json")
        self.fingerprint = fingerprint

    def _manifest(self) -> Dict:
        if not os.path.exists(self.manifest_path):
            return {}
        with open(self.manifest_path) as f:
            return json.load(f)

    def completed_chunks(self) -> set:
        man = self._manifest()
        ck_fp = man.get("fingerprint")
        if (self.fingerprint is not None and ck_fp is not None
                and ck_fp != self.fingerprint):
            raise ValueError(
                f"sweep checkpoint at {self.dir} was written by a run with "
                "different parameters (grid/params/chunking); refusing to "
                "resume -- delete it or point elsewhere")
        return set(man.get("chunks", []))

    def save_chunk(self, chunk_id: int, traces: Dict[str, np.ndarray],
                   extra: Dict | None = None) -> None:
        """The chunk's npz, then the manifest, each installed atomically."""
        atomic_savez(os.path.join(self.dir, f"chunk_{chunk_id:05d}.npz"),
                     **{k: np.asarray(v) for k, v in traces.items()})
        man = {"chunks": sorted(self.completed_chunks() | {chunk_id}),
               "extra": extra or {}}
        if self.fingerprint is not None:
            man["fingerprint"] = self.fingerprint
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(man, f)
        os.replace(tmp, self.manifest_path)

    def load_chunk(self, chunk_id: int) -> Dict[str, np.ndarray]:
        with np.load(os.path.join(self.dir, f"chunk_{chunk_id:05d}.npz")) as z:
            return {k: z[k] for k in z.files}

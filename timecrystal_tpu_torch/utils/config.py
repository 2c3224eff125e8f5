"""config.txt parsing: a copy of ``timecrystal_tpu/utils/config.py`` (pure
Python, kept here so the port never imports the JAX package).

Grammar: ``KEY = VALUE`` lines, ``#`` comments (full-line or trailing), auto-typing:
  - ints            J = 1
  - floats          TAU = 0.5  (also 1e-7 style)
  - bracket lists   H_VALUES = [0.1, 0.2, 0.3]  (ints if all integral)
  - bare lists      SAVE_FORMATS = png,pdf      (strings if not numeric)
  - strings         STATE_TYPE = neel
"""

from __future__ import annotations

import os
from typing import Dict, Optional


def _parse_scalar(value: str):
    if "." in value or "e" in value.lower():
        try:
            return float(value)
        except ValueError:
            return value
    try:
        return int(value)
    except ValueError:
        return value


def _parse_number_list(items: list[str]):
    floats = [float(x) for x in items]  # may raise ValueError
    if all(f.is_integer() for f in floats):
        return [int(f) for f in floats]
    return floats


def _parse_value(value: str):
    if value.startswith("[") and value.endswith("]"):
        inner = value[1:-1].strip()
        if not inner:
            return []
        try:
            return _parse_number_list([x.strip() for x in inner.split(",")])
        except ValueError:
            return [x.strip() for x in inner.split(",")]
    if "," in value and not any(c in value for c in "()[]"):
        items = [x.strip() for x in value.split(",")]
        try:
            return _parse_number_list(items)
        except ValueError:
            return items
    return _parse_scalar(value)


def read_parameters(filename: Optional[str] = None) -> Dict:
    """Parse a parameter file; auto-detects ./config.txt when no path given.

    Returns {} (with a warning) when no file is found, matching the
    reference's behavior (main.py:75-77).  An EXPLICITLY passed filename
    that does not exist raises instead of silently falling back to
    ./config.txt (a typo'd --config must not run hours of sweep with the
    wrong parameters).
    """
    if filename and not os.path.exists(filename):
        raise FileNotFoundError(
            f"parameters file not found: {filename!r} (refusing to fall "
            "back to ./config.txt for an explicitly requested path)")
    candidates = ([filename] if filename else []) + ["config.txt"]
    path = next((p for p in candidates if p and os.path.exists(p)), None)
    if path is None:
        print(f"Warning: No parameters file found. Tried: {candidates}")
        return {}
    print(f"Reading parameters from: {path}")

    params: Dict = {}
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            line = line.split("#", 1)[0].strip()
            if "=" not in line:
                continue
            key, _, value = line.partition("=")
            key, value = key.strip(), value.strip()
            if key:
                params[key] = _parse_value(value)
    return params

"""Internal path/file helpers (reference: ambersim/utils/_internal_utils.py:7-32).

Relative model paths resolve as the JAX package resolves them: against the
working directory, then against `ROOT`, the directory ``ambersim_tpu/`` of
this repository (the JAX package's own ``ROOT``). The MJCF, URDF and OBJ
files under ``ambersim_tpu/models/`` are data that the port reads by path;
it imports nothing of that package.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Union

ROOT = str(Path(__file__).resolve().parent.parent.parent / "ambersim_tpu")


def _check_filepath(filepath: Union[str, Path]) -> str:
    """Resolve a model path: absolute, cwd-relative, or `ROOT`-relative
    (reference semantics: _internal_utils.py:7-19)."""
    filepath = Path(filepath)
    candidates = [filepath, Path.cwd() / filepath, Path(ROOT) / filepath]
    for c in candidates:
        if c.exists() and c.is_file():
            return str(c.resolve())
    raise FileNotFoundError(f"could not resolve model file '{filepath}' (tried {[str(c) for c in candidates]})")


def _rmtree(path: Union[str, Path]) -> None:
    """Recursively delete a directory tree (reference: _internal_utils.py:22-32)."""
    shutil.rmtree(path, ignore_errors=True)

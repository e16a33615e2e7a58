"""Compile-on-demand build of the native C++ substrate.

The C++ sources are the JAX package's (`sapling_tpu/native/csrc/*.cpp`),
read by file path: importing `sapling_tpu` would import jax. The shared
library goes into the port's own build directory (`sapling_tpu_torch/_build`,
gitignored), keyed by a hash of the sources and flags, so nothing is ever
written next to the JAX package's sources.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(os.path.dirname(_PKG), "sapling_tpu", "native", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
_LOCK = threading.Lock()
_CACHE: dict[str, str] = {}

_CXX = os.environ.get("CXX", "g++")
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-march=native",
          "-funroll-loops"]


def _source_files() -> list[str]:
    if not os.path.isdir(CSRC):
        raise FileNotFoundError(
            f"native sources not found at {CSRC}: the port builds the C++ "
            "substrate from the repository's sapling_tpu/native/csrc")
    return sorted(
        os.path.join(CSRC, f)
        for f in os.listdir(CSRC)
        if f.endswith((".cpp", ".cc", ".h", ".hpp"))
    )


def _digest(paths: list[str]) -> str:
    h = hashlib.sha256()
    h.update(" ".join([_CXX] + _FLAGS).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def build_native(name: str = "libsapling_native") -> str:
    """Build (or reuse) the native shared library; returns its path."""
    with _LOCK:
        if name in _CACHE:
            return _CACHE[name]
        files = _source_files()
        srcs = [p for p in files if p.endswith((".cpp", ".cc"))]
        os.makedirs(BUILD_DIR, exist_ok=True)
        out = os.path.join(BUILD_DIR, f"{name}-{_digest(files)}.so")
        if not os.path.exists(out):
            tmp = out + f".tmp{os.getpid()}"
            cmd = [_CXX, *_FLAGS, "-o", tmp, *srcs]
            try:
                subprocess.run(cmd, check=True, capture_output=True, text=True)
            except subprocess.CalledProcessError as e:  # pragma: no cover
                raise RuntimeError(
                    f"native build failed:\n{' '.join(cmd)}\n{e.stderr}"
                ) from e
            os.replace(tmp, out)
        _CACHE[name] = out
        return out

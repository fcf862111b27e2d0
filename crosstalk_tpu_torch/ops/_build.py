"""Build and load the port's native libraries.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
with ``nvcc`` for ``sm_90a`` into a shared library under
``<checkout>/.cache/crosstalk_tpu_torch/kernels/``; each host-side
``native/<name>.cpp`` (the TIFF decoder) is compiled with ``g++`` into
``<checkout>/.cache/crosstalk_tpu_torch/native/`` (``.cache/`` is listed in
.gitignore). A library is named by a hash of its source and the flags,
written through a temporary file unique to the process and moved into place
atomically, and loaded with ``ctypes``. The host library is built with
``-march=native``, so its name also hashes the host CPU's instruction-set
flags: a checkout shared by hosts of different CPUs builds one library per
kind of CPU and never loads one that the CPU cannot run. Nothing here runs
at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
NATIVE_SRC = _PKG / "native"
BUILD_DIR = _PKG.parent / ".cache" / "crosstalk_tpu_torch" / "kernels"
NATIVE_BUILD_DIR = _PKG.parent / ".cache" / "crosstalk_tpu_torch" / "native"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# the JAX package's decoder flags (crosstalk_tpu/data/native_loader.py:52-60)
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
GXX_LIBS = ("-lpthread",)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the port's "
        "CUDA kernels are built from csrc/ at first use")


def _library_path(src: Path, out_dir: Path, key: str) -> Path:
    digest = hashlib.sha256(src.read_bytes() + key.encode()).hexdigest()[:16]
    return out_dir / f"lib{src.stem}_{digest}.so"


def _host_cpu() -> str:
    """The instruction-set flags ``-march=native`` compiles for (the first
    ``flags`` line of /proc/cpuinfo), or the machine type where that file
    does not exist."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.machine()


def _cached_build(out: Path, command: list) -> Path:
    """Compile to ``out`` with ``command`` (whose output file is the
    ``{tmp}`` item) unless ``out`` exists. Raises with the compiler's
    output when the compile fails."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [str(tmp) if a == "{tmp}" else a for a in command]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # no compiler on this host
        raise RuntimeError(f"{cmd[0]} could not run for {out.name}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"{os.path.basename(cmd[0])} failed for {out.name} ({proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders leave one library
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` with nvcc (see ``_cached_build``)."""
    src = CSRC / f"{name}.cu"
    out = _library_path(src, BUILD_DIR, " ".join(NVCC_FLAGS))
    return _cached_build(out, [nvcc_path(), *NVCC_FLAGS, "-o", "{tmp}", str(src)])


def native_library(name: str) -> Path:
    """Where the library of ``native/<name>.cpp`` for this host lives."""
    return _library_path(NATIVE_SRC / f"{name}.cpp", NATIVE_BUILD_DIR,
                         " ".join(GXX_FLAGS + GXX_LIBS) + "\n" + _host_cpu())


def build_native(name: str) -> Path:
    """Compile ``native/<name>.cpp`` with g++ (see ``_cached_build``)."""
    src = NATIVE_SRC / f"{name}.cpp"
    return _cached_build(native_library(name),
                         ["g++", *GXX_FLAGS, "-o", "{tmp}", str(src), *GXX_LIBS])


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed. Called on
    every kernel launch: after the first call it is one dict lookup (no
    hashing of the source)."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]


def load_native(name: str) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cpp``, built if needed."""
    key = f"native/{name}"
    if key not in _loaded:
        _loaded[key] = ctypes.CDLL(str(build_native(name)))
    return _loaded[key]

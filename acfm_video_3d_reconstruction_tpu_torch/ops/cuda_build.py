"""Build this package's CUDA sources with nvcc and load them with ctypes.

Each source under csrc/ has a plain C interface. It is compiled at first
use into `_build/` next to the package (one nvcc per source, started
together), keyed by a hash of the source, the csrc/*.cuh headers it may
include and the flags, and loaded with ctypes. A failed build raises;
nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# sm_90a (Hopper). --fmad=false: the rasterizer's selects compare values
# that one FMA contraction moves by an ULP (see csrc/raster_geometry.cuh).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: the package's CUDA kernels are built at first use "
        "and need the CUDA toolkit (nvcc on PATH or CUDA_HOME set)"
    )


def _target(name: str) -> Path:
    src = CSRC_DIR / name
    key = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        key.update(header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}_{key.hexdigest()[:16]}.so"


def build(names: list[str]) -> dict[str, str]:
    """Compile the named csrc/ sources, all nvcc processes at once.

    Returns {name: compiler log} for the sources built now (an up-to-date
    library is not rebuilt). Raises RuntimeError with nvcc's output on a
    failed build.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / name)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _loaded[name] = lib
        return lib

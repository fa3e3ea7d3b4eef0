"""Build and load the package's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface.  On first use it is compiled
with `nvcc` for `sm_90a` into a shared library under `build/kernels/` at the
root of the checkout (listed in `.gitignore`) and loaded with `ctypes`.  The
library's file name carries a hash of the source and flags, so an edited
source is rebuilt.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name -> loaded library; name -> {"seconds", "ptxas"} for libraries built by
# this process (a library found already built has no entry)
_LIBS: dict = {}
BUILD_LOG: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def load(name: str) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu, building it if needed."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib_path = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)
        BUILD_LOG[name] = {
            "seconds": time.perf_counter() - t0,
            "ptxas": [
                ln.strip() for ln in proc.stderr.splitlines()
                if "registers" in ln or "Compiling entry" in ln or "spill" in ln
            ],
        }
    lib = ctypes.CDLL(str(lib_path))
    _LIBS[name] = lib
    return lib

"""Build and load the package's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface.  On first use it is compiled
with `nvcc` for `sm_90a` into a shared library under `build/kernels/` at the
root of the checkout (listed in `.gitignore`) and loaded with `ctypes`.  The
library's file name carries a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source is rebuilt.  `build_all`
runs one `nvcc` per library, all at once.  Nothing here runs at import time.
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

# the libraries, one per csrc/<name>.cu; each includes the shared headers it
# needs (csrc/*.cuh)
LIBRARIES = ("attn_block", "inr_decode", "nerf_mlp", "flash")

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


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names) -> None:
    """Compile every library of `names` that is not built yet, one `nvcc`
    process each, all started together."""
    todo = [(n, _lib_path(n)) for n in names if n not in _LIBS]
    todo = [(n, p) for n, p in todo if not p.exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, lib_path in todo:
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, lib_path, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, lib_path, tmp, t0, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}\n{err}")
            continue
        os.replace(tmp, lib_path)
        BUILD_LOG[name] = {
            "seconds": time.perf_counter() - t0,
            "ptxas": [
                ln.strip() for ln in err.splitlines()
                if any(w in ln for w in ("registers", "Compiling entry", "spill", "wgmma",
                                         "setmaxnreg", "arning"))
            ],
        }
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu, building it if needed."""
    if name in _LIBS:
        return _LIBS[name]
    build_all([name])
    lib = ctypes.CDLL(str(_lib_path(name)))
    _LIBS[name] = lib
    return lib

"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each ``ops/csrc/<name>.cu`` exposes a plain C interface and is compiled into
its own shared library under ``build/kernels/`` at the repository root, then
loaded with ``ctypes``.  The library's file name carries a hash of the source,
the shared headers (``ops/csrc/*.cuh``) and the flags, so an edited source is
rebuilt and a built one is reused.  ``build_all`` runs one ``nvcc`` per
source, all at once.

There is no fallback: a missing ``nvcc`` or a failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "ops" / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"

# sm_90a: Hopper with its architecture-specific instructions.  -fmad=false
# keeps a*b+c as two roundings, as the plain PyTorch versions compute it; no
# fast-math flag (see the note in each source).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]

_LOADED: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    # PyTorch's own search: CUDA_HOME / CUDA_PATH, then the default install
    from torch.utils.cpp_extension import CUDA_HOME

    cand = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if CUDA_HOME and cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA kernels "
                       "are built from source and have no fallback")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``ops/csrc/<name>.cu`` unless its library is already built;
    returns the library path.  Records seconds and ptxas output in BUILD_LOG."""
    out = library_path(name)
    if out.exists():
        BUILD_LOG.setdefault(name, {"seconds": 0.0, "log": "cached", "path": str(out)})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)
    BUILD_LOG[name] = {"seconds": secs, "log": proc.stderr + proc.stdout,
                       "path": str(out)}
    return out


def build_all(names) -> list[Path]:
    """``build`` each source, one ``nvcc`` per source, started together."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(build, names))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``ops/csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib

"""Build and load the port's CUDA kernels.

``library()`` compiles every ``csrc/*.cu`` of the package with ``nvcc`` into
one shared library with a plain C interface and loads it with ``ctypes``.
It is called on first use from a CUDA tensor, never on import: the output
goes to ``build/torch_kernels/<hash of sources and flags>/`` at the root of
the checkout, so an unchanged tree reuses its build and an edited one
rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
LIB_NAME = "libwst_kernels.so"

# Route (b) of the port's kernel build: nvcc by hand for Hopper (sm_90a),
# no --use_fast_math (it flushes denormals and approximates sqrtf and
# division). -Xptxas -v reports registers and spills into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes of each C entry point (see the .cu files)
_ENTRY_POINTS = {
    "wst_sph_density": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "wst_sph_force": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                      _P],
}


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float   # nvcc wall time in this process; 0.0 if reused
    log: str         # nvcc's output (ptxas register/spill report)


_BUILT: Built | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def build() -> Built:
    """Compile (or reuse) and load the kernel library; cached per process."""
    global _BUILT
    if _BUILT is not None:
        return _BUILT
    out_dir = BUILD_ROOT / _digest()
    path = out_dir / LIB_NAME
    seconds, log = 0.0, ""
    if not path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(s) for s in sources()]]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        (out_dir / "nvcc.log").write_text(log)
        os.replace(tmp, path)   # atomic: no process loads a half-written file
    elif (out_dir / "nvcc.log").exists():
        log = (out_dir / "nvcc.log").read_text()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _BUILT = Built(lib, path, seconds, log)
    return _BUILT


def library() -> ctypes.CDLL:
    return build().lib

"""Build and load the port's CUDA kernels.

``build()`` compiles each ``csrc/<name>.cu`` of the package with its own
``nvcc``, all started together, into one shared library per source with a
plain C interface, and loads them with ``ctypes``. It runs on first use from
a CUDA tensor, never on import: the output goes to
``build/torch_kernels/<hash of sources and flags>/`` at the root of the
checkout, so an unchanged tree reuses its build and an edited one rebuilds.
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

# Route (b) of the port's kernel build: nvcc by hand for Hopper (sm_90a),
# no --use_fast_math (it flushes denormals and approximates sqrtf and
# division). -Xptxas -v reports registers and spills into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# source (csrc/<name>.cu) -> its C entry point and argtypes
_ENTRY_POINTS = {
    "sph_density": ("wst_sph_density",
                    [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     _P]),
    "sph_force": ("wst_sph_force",
                  [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   _P]),
    "bitonic_sort": ("wst_bitonic_sort", [_P, _P, _P, _P, _I, _I, _I, _P]),
}


class Built(NamedTuple):
    fns: dict        # entry point name -> ctypes function
    path: Path       # the build directory
    seconds: float   # wall time of the parallel nvcc runs; 0.0 if reused
    log: str         # nvcc's output (ptxas register/spill report)


_BUILT: Built | None = None


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


def _compile(out_dir: Path, names: list[str]) -> float:
    """One nvcc per source, all running at once; returns their wall time.
    Each library is renamed into place only once its nvcc succeeded."""
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for name in names:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        with open(out_dir / f"{name}.nvcc.log", "w") as log:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT)
        jobs.append((name, tmp, proc))
    failed = []
    for name, tmp, proc in jobs:
        if proc.wait() != 0:
            failed.append(name)
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")
    if failed:
        logs = "\n".join((out_dir / f"{n}.nvcc.log").read_text()
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return time.perf_counter() - t0


def build() -> Built:
    """Compile (or reuse) and load the kernel libraries; cached per
    process."""
    global _BUILT
    if _BUILT is not None:
        return _BUILT
    found = sorted(p.stem for p in CSRC.glob("*.cu"))
    if found != sorted(_ENTRY_POINTS):
        raise RuntimeError(f"csrc/*.cu {found} do not match the entry "
                           f"points {sorted(_ENTRY_POINTS)}")
    out_dir = BUILD_ROOT / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    missing = [n for n in _ENTRY_POINTS
               if not (out_dir / f"lib{n}.so").exists()]
    seconds = _compile(out_dir, missing) if missing else 0.0
    fns = {}
    for name, (entry, argtypes) in _ENTRY_POINTS.items():
        fn = getattr(ctypes.CDLL(str(out_dir / f"lib{name}.so")), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[entry] = fn
    log = "".join((out_dir / f"{n}.nvcc.log").read_text()
                  for n in _ENTRY_POINTS
                  if (out_dir / f"{n}.nvcc.log").exists())
    _BUILT = Built(fns, out_dir, seconds, log)
    return _BUILT


def entry(name: str):
    """The ctypes function of C entry point ``name`` (building first)."""
    return build().fns[name]

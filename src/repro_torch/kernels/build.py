"""Builds the hand-written CUDA kernels and loads them with ctypes.

Each source under ``csrc/`` becomes one shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` into ``build/`` at the root of
the checkout, at first use.  The library's file name carries a hash of its
source and of the shared headers (``csrc/*.cuh``), so an edited source or
header is rebuilt and an unchanged one is reused.  Nothing here runs at import
time: this module is imported on machines without a CUDA toolkit, where only
the kernels' plain versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: the name carries a hash of the source
    and of every header under ``csrc/``, so that editing a header it includes
    rebuilds it too."""
    digest = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build(*names: str) -> dict[str, str]:
    """Compile ``csrc/<name>.cu`` for each name whose library is not built yet,
    one nvcc per source, all started together.  Returns nvcc's ptxas report
    (registers, shared memory, spills) by name, empty where nothing was
    compiled; raises if a compile fails, after stopping the others."""
    reports = dict.fromkeys(names, "")
    jobs = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists() or name in jobs:
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, out)
        for name, (proc, tmp, out) in jobs.items():
            reports[name] = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{reports[name]}")
            os.replace(tmp, out)  # atomic: a reader never sees a half-written library
    finally:
        for proc, _, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]

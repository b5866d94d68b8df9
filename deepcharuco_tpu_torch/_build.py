"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface, under
``build/kernels/`` at the repository root, and loaded with ``ctypes``. The
library's file name carries a hash of the sources (the ``.cu`` and every
``.cuh`` beside it) and of the flags, so an edit rebuilds and an unchanged
tree reuses the last build. A failed compile raises with nvcc's output.
Nothing here runs at import time. Each nvcc process started adds one to
the counter ``build.nvcc_compiles`` (``profiling``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

from deepcharuco_tpu_torch import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
KERNELS = ("decode", "fused_head_decode", "conv_epilogue", "pnp")

_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    profiling.count("build.nvcc_compiles")
    return out, (proc, tmp)


def _finish(name: str, out: Path, job) -> None:
    if job is None:
        return
    proc, tmp = job
    log, _ = proc.communicate()
    build_log[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build(names: Iterable[str] = KERNELS) -> float:
    """Compile every named kernel that is not built yet, one nvcc process
    per source, all started together. Returns the wall seconds taken."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in names}
    errors = []
    for name, (out, job) in jobs.items():
        try:
            _finish(name, out, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed
    (together with every other kernel of ``KERNELS`` not built yet, so that
    a first run waits for one round of nvcc processes, not one per kernel)."""
    lib = _libs.get(name)
    if lib is None:
        build(KERNELS if name in KERNELS else [name])
        lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib


def error_string(lib: ctypes.CDLL, status: int) -> str:
    """The name of a ``cudaError_t`` returned by one of ``lib``'s entry points."""
    fn = lib.dc_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return f"CUDA error {status}: {fn(status).decode()}"

"""ctypes binding of the repository's native synthesis core
(``deepcharuco_tpu.data.native``): ``native/dcsynth.cpp``'s procedural
backgrounds, fused paste + photometric stack and box blur.

The source is compiled at first use with ``g++ -O3 -mfma -shared -fPIC``
into a library under ``build/native/`` at the repository root whose name
carries a hash of the source and the flags. ``-mfma`` lets GCC fuse
``a·b + c`` exactly where the JAX package's ``-march=native`` build does, so
both draw the same samples bit for bit (without it about 3 background pixels
in a million differ by a level); it needs a CPU with FMA (x86 since 2013). Nothing is written into ``native/``, and
the committed ``native/libdcsynth.so`` (built with ``-march=native`` for
another CPU) is never loaded. There is no quiet fallback: a library that
cannot be built raises with g++'s output. The numpy route
(``use_native=False`` in the callers) draws a different sample stream, so
switching routes is the caller's explicit choice.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent.parent.parent
SRC = ROOT / "native" / "dcsynth.cpp"
BUILD_DIR = ROOT / "build" / "native"
FLAGS = ["-O3", "-mfma", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def lib_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libdcsynth-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"cannot build {SRC} with g++: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The native library, built on first use; raises ``RuntimeError`` with
    g++'s output when it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            out = lib_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            lib.dc_procedural_bg.argtypes = [ctypes.c_uint64, ctypes.c_int, ctypes.c_int, _u8p]
            lib.dc_procedural_bg.restype = None
            lib.dc_composite_photometric.argtypes = [
                ctypes.c_uint64, ctypes.c_int, ctypes.c_int, _u8p, _u8p, _u8p, ctypes.c_int]
            lib.dc_composite_photometric.restype = None
            lib.dc_box_blur.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p, _u8p]
            lib.dc_box_blur.restype = None
            _lib = lib
        return _lib


def procedural_bg(seed: int, h: int, w: int) -> np.ndarray:
    """(h, w, 3) uint8 procedural background of ``seed``."""
    out = np.empty((h, w, 3), np.uint8)
    load().dc_procedural_bg(seed & (2 ** 64 - 1), h, w, out)
    return out


def composite_photometric(seed: int, board: np.ndarray, mask: np.ndarray,
                          bg: np.ndarray, is_negative: bool = False,
                          blur_radius: int = 0) -> np.ndarray:
    """Board pasted on a copy of ``bg`` through ``mask``, the photometric
    stack, then a box blur of ``blur_radius`` (none at 0)."""
    lib = load()
    h, w = bg.shape[:2]
    if board.shape != bg.shape or mask.shape != bg.shape[:2] or bg.shape[2:] != (3,):
        raise ValueError(f"board {board.shape}, mask {mask.shape}, bg {bg.shape}: "
                         "expected (H, W, 3), (H, W), (H, W, 3)")
    out = np.ascontiguousarray(bg, np.uint8).copy()
    lib.dc_composite_photometric(seed & (2 ** 64 - 1), h, w,
                                 np.ascontiguousarray(board, np.uint8),
                                 np.ascontiguousarray(mask, np.uint8), out, int(is_negative))
    if blur_radius > 0:
        box_blur(out, blur_radius)
    return out


def box_blur(img: np.ndarray, radius: int) -> np.ndarray:
    """In-place separable box blur of an (H, W, 3) uint8 C-contiguous image."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3 \
            or not img.flags["C_CONTIGUOUS"]:
        raise ValueError("box_blur takes a C-contiguous (H, W, 3) uint8 image")
    h, w = img.shape[:2]
    load().dc_box_blur(h, w, radius, img, np.empty_like(img))
    return img

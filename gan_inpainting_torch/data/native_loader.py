"""ctypes bindings for the repo's native JPEG loader (``native/loader.cpp``):
libjpeg decode, center crop and an area-filter resize to the target
square, a batch decoded by a pool of C++ threads.

The shared library is built from that source at first use with ``g++ -O2
-shared -fPIC … -ljpeg`` into ``gan_inpainting_torch/_build/`` (rebuilt
when the source is newer), written under a temporary name and renamed, so
processes that build at once never load a half-written file.
:func:`available` is False when g++ or libjpeg is missing; data/loader.py
then decodes with PIL. This is host decode only: no device and no kernel.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
_SRC = _REPO_ROOT / "native" / "loader.cpp"
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
_LIB = _BUILD_DIR / "libinpaint_loader.so"

_lock = threading.Lock()
_lib = None
_build_failed = False


def _build() -> bool:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O2", "-shared", "-fPIC", str(_SRC), "-ljpeg",
           "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, _LIB)
    return True


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if not _LIB.exists() or _SRC.stat().st_mtime > _LIB.stat().st_mtime:
            if not _build():
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError:
            _build_failed = True
            return None
        lib.inpaint_load_batch.restype = ctypes.c_int
        lib.inpaint_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads here."""
    return _load() is not None


def load_batch(paths: list[str], size: int,
               num_threads: int | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """Decode JPEGs → (batch uint8 (N, size, size, 3), ok bool (N,)); a
    file that fails to decode leaves its slot zero and ``ok`` False."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable (build failed)")
    n = len(paths)
    out = np.zeros((n, size, size, 3), np.uint8)
    ok = np.zeros((n,), np.uint8)
    if num_threads is None:
        num_threads = min(8, max(1, os.cpu_count() or 1))
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.inpaint_load_batch(
        c_paths, n, size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        num_threads)
    return out, ok.astype(bool)

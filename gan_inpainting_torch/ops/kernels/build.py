"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``gan_inpainting_torch/_build/`` (listed in .gitignore). The file name
carries a hash of the source, the nvcc flags and the toolkit, so an edited
source is rebuilt and an unchanged one is loaded as is. :func:`build_all`
starts one nvcc per source, all at once.

Nothing here runs at import: the CPU tests import every module on a box
with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("contextual_attention", "contextual_attention_bwd", "fold")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def _target(name: str, nvcc: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    common = (CSRC / "common.cuh").read_bytes()
    key = hashlib.sha256(src + common + " ".join(NVCC_FLAGS).encode()
                         + nvcc.encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def _start(name: str, nvcc: str, out: Path) -> subprocess.Popen:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_all(names=SOURCES) -> float:
    """Compile every source not yet built, in parallel; load all of them.
    Returns the wall seconds spent. Raises if any nvcc fails."""
    t0 = time.perf_counter()
    with _lock:
        todo = [n for n in names if n not in _libs]
        if not todo:
            return 0.0
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        targets = {n: _target(n, nvcc) for n in todo}
        procs = {n: _start(n, nvcc, t) for n, t in targets.items()
                 if not t.exists()}
        failed = []
        for n, proc in procs.items():
            log, _ = proc.communicate()
            build_log[n] = log
            tmp = targets[n].with_suffix(f".{os.getpid()}.tmp")
            if proc.returncode != 0:
                failed.append(f"--- nvcc {n}.cu (rc {proc.returncode}):\n"
                              f"{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, targets[n])
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
        for n, t in targets.items():
            _libs[n] = ctypes.CDLL(str(t))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _libs:
        build_all((name,))
    return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch in ``lib``."""
    if err != 0:
        lib.gi_error_string.restype = ctypes.c_char_p
        lib.gi_error_string.argtypes = [ctypes.c_int]
        msg = lib.gi_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

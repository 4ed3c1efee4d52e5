"""Build and load the hand-written CUDA kernels (kernels/csrc/*.cu).

The sources compile with nvcc into one shared library with a plain C
interface, loaded with ctypes — no PyTorch headers, so a build takes
seconds. The library is built at first use into kernels/_build/ (listed in
.gitignore), named by a hash of the sources and flags, so a changed source
rebuilds and an unchanged one loads the cached file. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

SRC_DIR = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argtypes (pointers, then ints, then the stream)
SIGNATURES = {
    "lista3d_ana_threshold": [_P] * 5 + [_I] * 19 + [_P],
    "lista3d_syn_residual": [_P] * 5 + [_I] * 12 + [_P],
}


def nvcc_path() -> str:
    """The nvcc to build with: $CUDA_HOME/bin/nvcc, /usr/local/cuda's, or
    the one on PATH. Raises RuntimeError when there is none."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of "
        "cdlnet_tpu_torch build only where the CUDA toolkit is installed"
    )


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"cdlnet_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the sources unless the library for them exists. Returns
    (library path, seconds spent compiling — 0.0 for a cached library).
    The ptxas report (registers, shared memory, spills) is kept beside the
    library as <name>.log."""
    so = library_path()
    if so.exists():
        return so, 0.0
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _sources())],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)  # atomic: a concurrent build never loads half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with argtypes and
    restype declared for every entry point."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib

"""Build and load the hand-written CUDA kernels (kernels/csrc/*.cu).

Each source compiles with its own nvcc, all started together, and the
objects link into one shared library with a plain C interface, loaded with
ctypes — no PyTorch headers, so a build takes seconds. The library is built
at first use into kernels/_build/ (listed in .gitignore), named by a hash of
the sources, headers and flags, so a changed file rebuilds and an unchanged
one loads the cached library. Nothing here runs at import time. With
CDLNET_LOG_COMPILES set (utils.setup_debug), each build logs every nvcc
call: its source, its seconds and its result.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SRC_DIR = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# entry point -> argtypes (pointers, then ints and floats, then the stream)
SIGNATURES = {
    "lista3d_ana_threshold": [_P] * 6 + [_I] * 19 + [_P],
    "lista3d_syn_residual": [_P] * 6 + [_I] * 12 + [_P],
    "lista3d_syn_adjoint": [_P] * 7 + [_I] * 20 + [_F, _P],
    "lista3d_syn_adjoint_parts": [_I] * 9,
    "lista3d_wgrad": [_P] * 5 + [_I] * 15 + [_F, _P],
    "lista3d_wgrad_grid": [_I] * 6 + [_P],
    "lista2d_syn_adjoint": [_P] * 7 + [_I] * 15 + [_F, _P],
    "lista2d_syn_adjoint_parts": [_I] * 7,
    "lista2d_syn_adjoint_csr_parts": [_I] * 2,
    "lista2d_ana_threshold": [_P] * 6 + [_I] * 14 + [_P],
    "lista2d_syn_residual": [_P] * 6 + [_I] * 9 + [_P],
    "lista2d_launch_grid": [_I] * 8 + [_P],
    "lista2d_ana_csr": [_P] * 9 + [_I] * 14 + [_P],
    "lista2d_ana_csrf2": [_P] * 11 + [_I] * 14 + [_P],
    "lista2d_syn_adjoint_csr": [_P] * 13 + [_I] * 15 + [_F, _P],
    "lista2d_syn_adjoint_csrf2": [_P] * 17 + [_I] * 15 + [_F, _P],
}


_log = logging.getLogger(__name__)


def _nvcc(args, label) -> tuple[int, str]:
    """Run nvcc with args; (returncode, its output). Logged under
    CDLNET_LOG_COMPILES."""
    t0 = time.perf_counter()
    proc = subprocess.run(args, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if os.environ.get("CDLNET_LOG_COMPILES"):
        _log.warning("nvcc %s: %.2f s, %s", label, time.perf_counter() - t0,
                     "ok" if proc.returncode == 0 else f"failed (exit {proc.returncode})")
    return proc.returncode, proc.stdout


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
    """Where the library for the current sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.glob("*.cu*")):
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
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = _sources()
        objs = [os.path.join(tmp, src.stem + ".o") for src in srcs]
        with ThreadPoolExecutor(len(srcs)) as pool:  # every nvcc started together
            runs = list(pool.map(lambda src, obj: _nvcc(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)], src.name), srcs, objs))
        logs = [log for _, log in runs]
        failed = [(rc, log) for rc, log in runs if rc]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"({rc})\n{log}" for rc, log in failed))
        lib = os.path.join(tmp, so.name)
        rc, log = _nvcc([nvcc, "-shared", "-o", lib, *objs], f"link {so.name}")
        if rc != 0:
            raise RuntimeError(f"nvcc link failed ({rc}):\n{log}")
        so.with_suffix(".log").write_text("".join(logs))
        os.replace(lib, so)  # atomic: a concurrent build never loads half a file
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

"""Build and load the port's CUDA kernels.

The sources under ``gpusph_tpu_torch/csrc/`` have a plain C interface.  At
first use they are compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library under ``gpusph_tpu_torch/_build/``, keyed by a hash of the
sources and flags, and loaded with ``ctypes``.  A build failure raises; there
is no fallback.  ``nvcc -Xptxas -v`` output (registers, shared memory,
spills per kernel) is kept beside the library.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("forces.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(cuda_home) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return nvcc


def _build_key() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"gpusph_kernels-{_build_key()}.so"


def build() -> Path:
    """Compile the sources into the keyed library unless it exists."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(str(CSRC_DIR / s) for s in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def ptxas_report() -> str:
    """The ``-Xptxas -v`` lines of the current build (registers, shared
    memory, spill stores/loads per kernel)."""
    log = library_path().with_suffix(".log")
    if not log.exists():
        return ""
    return "\n".join(ln for ln in log.read_text().splitlines()
                     if "ptxas" in ln or "spill" in ln)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, with every C
    function's argument and result types declared.  Raises if the forces
    kernel's parameter layout differs from the wrapper's."""
    from .ops.forces_kernel import N_FLOAT_PARAMS, N_INT_PARAMS

    lib = ctypes.CDLL(str(build()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gpusph_forces_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, vp]
    lib.gpusph_forces_launch.restype = ci
    lib.gpusph_forces_abi.argtypes = [ctypes.POINTER(ci), ctypes.POINTER(ci)]
    lib.gpusph_forces_abi.restype = ci
    lib.gpusph_error_string.argtypes = [ci]
    lib.gpusph_error_string.restype = ctypes.c_char_p
    n_int, n_float = ci(), ci()
    lib.gpusph_forces_abi(ctypes.byref(n_int), ctypes.byref(n_float))
    if (n_int.value, n_float.value) != (N_INT_PARAMS, N_FLOAT_PARAMS):
        raise RuntimeError(
            f"forces kernel parameter layout mismatch: the library takes "
            f"{n_int.value} ints + {n_float.value} floats, the wrapper passes "
            f"{N_INT_PARAMS} + {N_FLOAT_PARAMS}")
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.gpusph_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


__all__ = ["build", "load_library", "library_path", "ptxas_report", "check"]

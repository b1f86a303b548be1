"""Build and load the CUDA C++ kernels of the port.

Each ``csrc/<name>.cu`` file has a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``build/tnax_torch/`` at the
root of the checkout (listed in ``.gitignore``), under a name that
carries a hash of the source and of the shared headers ``csrc/*.cuh``,
and loaded with ``ctypes``. Pointers and the CUDA stream go in as
``c_void_p``; every entry point returns ``cudaGetLastError()``, which
:func:`check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tnax_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# ptxas resource reports of the kernels built by this process, by name
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return nvcc


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` (once per source version) and load it."""
    src = CSRC / f"{name}.cu"
    text = src.read_bytes() + b"".join(h.read_bytes()
                                       for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"lib{name}_{digest[:12]}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
        os.replace(tmp, lib)
        build_logs[name] = proc.stderr
    dll = ctypes.CDLL(str(lib))
    dll.tnax_cuda_error_string.argtypes = [ctypes.c_int]
    dll.tnax_cuda_error_string.restype = ctypes.c_char_p
    return dll


@functools.lru_cache(maxsize=None)
def fn(name: str, symbol: str, argtypes: tuple, restype=ctypes.c_int):
    """The entry point ``symbol`` of ``csrc/<name>.cu`` with its
    ``argtypes`` and ``restype`` (by default the CUDA error code), bound
    once, when first asked for."""
    f = getattr(load(name), symbol)
    f.argtypes = list(argtypes)
    f.restype = restype
    return f


def check(dll: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = dll.tnax_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def raw_stream(device) -> int:
    """The current CUDA stream of ``device`` as an integer handle, without
    building a Stream object (a few microseconds less per launch)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device.index)

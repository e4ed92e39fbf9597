"""Build and load the engine's hand-written CUDA kernels.

Each kernel family is one `csrc/<name>.cu` with a plain `extern "C"`
launcher. At first use it is compiled with `nvcc -arch=sm_90a` into
`rayforce_tpu_torch/_build/lib<name>.so` (rebuilt when the source is
newer than the library, under a file lock so that two processes never
build at once) and loaded with ctypes. Nothing here runs at import:
machines without `nvcc` import this module freely and never call it.
A failed build raises `DeviceError` with nvcc's stderr, and so does a
library that does not load.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import time

from .device import DeviceError

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

_libs: dict = {}
build_seconds: dict = {}     # name -> seconds spent in nvcc this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise DeviceError("nvcc not found (set CUDA_HOME or put nvcc on "
                      "PATH); the CUDA kernels are built from source")


def _build(name: str, src: str, lib: str) -> None:
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-O3", "-std=c++17",
           "-gencode=arch=compute_90a,code=sm_90a",
           "-shared", "-Xcompiler", "-fPIC", "-o", tmp, src]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise DeviceError(f"nvcc failed building {name} "
                          f"(rc {r.returncode}):\n{r.stderr}")
    os.replace(tmp, lib)
    build_seconds[name] = time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src = os.path.join(CSRC, f"{name}.cu")
    path = os.path.join(BUILD_DIR, f"lib{name}.so")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if not os.path.exists(path) or \
                    os.path.getmtime(path) < os.path.getmtime(src):
                _build(name, src, path)
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise DeviceError(f"cannot load {path}: {e}") from e
    _libs[name] = lib
    return lib

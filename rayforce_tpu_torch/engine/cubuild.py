"""Build and load the engine's hand-written CUDA kernels.

Each kernel family is one `csrc/<name>.cu` with a plain `extern "C"`
launcher. At first use it is compiled with `nvcc -arch=sm_90a` into
`rayforce_tpu_torch/_build/lib<name>.so` (rebuilt when the source is
newer than the library, under a file lock so that two processes never
build at once) and loaded with ctypes. `build` starts one nvcc for each
library it is given, all at once. Nothing here runs at import:
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


def _paths(name: str):
    return (os.path.join(CSRC, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def build(names) -> None:
    """Build every library of `names` that is missing or older than its
    source, one nvcc each, all started together."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    locks, jobs = [], []
    try:
        for name in names:
            lk = open(os.path.join(BUILD_DIR, f"{name}.lock"), "w")
            fcntl.flock(lk, fcntl.LOCK_EX)
            locks.append(lk)
            src, lib = _paths(name)
            if os.path.exists(lib) and \
                    os.path.getmtime(lib) >= os.path.getmtime(src):
                continue
            tmp = f"{lib}.{os.getpid()}.tmp"
            cmd = [_nvcc(), "-O3", "-std=c++17",
                   "-gencode=arch=compute_90a,code=sm_90a",
                   "-shared", "-Xcompiler", "-fPIC", "-o", tmp, src]
            jobs.append((name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True), tmp, lib, time.perf_counter()))
        for name, proc, tmp, lib, t0 in jobs:
            _out, err = proc.communicate()
            if proc.returncode != 0:
                raise DeviceError(f"nvcc failed building {name} "
                                  f"(rc {proc.returncode}):\n{err}")
            os.replace(tmp, lib)
            build_seconds[name] = time.perf_counter() - t0
    finally:
        for _name, proc, *_rest in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for lk in locks:
            fcntl.flock(lk, fcntl.LOCK_UN)
            lk.close()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    path = _paths(name)[1]
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise DeviceError(f"cannot load {path}: {e}") from e
    _libs[name] = lib
    return lib

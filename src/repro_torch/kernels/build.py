"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C function (pointers, ints and the
CUDA stream; it returns the launch's ``cudaError_t``), so it compiles
with ``nvcc`` alone in seconds, without PyTorch's headers.  ``build``
compiles every stale source for ``sm_90a`` into ``_build/lib<name>.so``
(listed in ``.gitignore``), one ``nvcc`` process per source, all started
together; ``library`` builds at first use and loads the result with
``ctypes``.  Nothing here runs at import, so the CPU tests import the
kernel modules on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("kv_gather", "kv_scatter", "flash_attention", "paged_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(d.stat().st_mtime for d in deps)


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile every stale source among ``names`` in parallel.  The
    compiler's output, register and shared-memory report included
    (``-Xptxas -v``), goes to ``_build/<name>.log``."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    procs = []
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, _lib_path(name))
        else:
            failed.append(name)
    if failed:
        logs = "\n".join((BUILD_DIR / f"{n}.log").read_text()[-4000:]
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")


@functools.cache
def library(name: str) -> ctypes.CDLL:
    build((name,))
    return ctypes.CDLL(str(_lib_path(name)))


def check(rc: int, kernel: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with "
                           f"cudaError_t {rc}")


# the attention kernels' dtype codes (see the extern "C" entry points)
ATTN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require_cuda(kernel: str, *tensors: torch.Tensor) -> None:
    """All of ``tensors`` on one CUDA device, or raise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{kernel}: tensors must share one CUDA "
                             f"device, got {[x.device for x in tensors]}")

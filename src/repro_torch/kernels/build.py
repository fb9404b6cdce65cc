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
SOURCES = ("kv_gather", "kv_scatter", "flash_attention", "paged_attention",
           "grouped_gemm", "mla_decode", "ssd_scan", "ssm_step",
           "flash_attention_bwd", "grouped_gemm_bwd", "ssd_scan_bwd")
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


# the kernels' dtype codes: attention, the absorbed MLA decode and the
# grouped GEMM (see the extern "C" entry points)
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


# why the decode kernels have no backward, as their guards say
DECODE_ONLY = ("a decode kernel is never trained: training runs the "
               "full-sequence forward")


def require_no_grad(kernel: str, later: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when autograd would need ``kernel``'s
    gradient: grad mode on and any of ``tensors`` requiring grad.  The
    kernel has no backward, and ``later`` says why (the decode kernels:
    training runs the full-sequence forward); on both devices, so the CPU
    trains exactly what the card can.  Serving never trips it: its
    tensors do not require grad."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise NotImplementedError(f"{kernel} has no backward yet: {later}")


def require_aligned(kernel: str, ptrs: dict, strides: dict, itemsize: int,
                    align: int = 16) -> None:
    """Raise unless every data pointer in ``ptrs`` (name -> int) is
    ``align``-byte aligned and every element stride in ``strides`` (name
    -> tuple of ints) is a whole number of ``align`` bytes: the kernels'
    16-byte loads (``cp.async``, ``uint4``) start at each row's first
    element.  A pure function of the numbers, so it is tested without a
    card."""
    per = max(1, align // itemsize)
    for name, p in ptrs.items():
        if p % align:
            raise ValueError(f"{kernel}: {name} starts at {p:#x}, not "
                             f"{align}-byte aligned")
    for name, st in strides.items():
        bad = [x for x in st if x % per]
        if bad:
            raise ValueError(f"{kernel}: {name} strides {tuple(st)} are not "
                             f"multiples of {per} elements ({align} bytes)")


def split_plan(n_keys: int, n_tiles: int, target_blocks: int, *,
               unit: int) -> tuple:
    """How a split-K kernel cuts ``n_keys`` key positions: (n_split,
    chunk), split s taking keys [s * chunk, (s + 1) * chunk).  Enough
    splits that ``n_tiles * n_split`` reaches ``target_blocks`` where the
    keys allow, ``chunk`` a multiple of ``unit``, and no split wholly past
    the keys:
    ``(n_split - 1) * chunk < n_keys <= n_split * chunk``.  Shapes only,
    so the host never reads the device's lengths."""
    if n_keys <= 0:
        return 1, unit
    want = max(1, -(-target_blocks // max(n_tiles, 1)))
    chunk = -(-n_keys // want)
    chunk = -(-chunk // unit) * unit
    return -(-n_keys // chunk), chunk


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_scratch(n_split: int, n_rows: int, dh: int,
                  device: torch.device) -> tuple:
    """(pm, pl, pacc) f32 scratch for ``n_split`` partials of ``n_rows``
    rows, carved from one allocation; null pointers for one split."""
    if n_split == 1:
        return None, None, None
    n = n_split * n_rows
    buf = torch.empty(n * (dh + 2), dtype=torch.float32, device=device)
    return buf[:n], buf[n:2 * n], buf[2 * n:]

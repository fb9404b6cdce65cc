"""Grouped GEMM — the MoE experts' matmuls.

``y[r] = x[r] @ w[e(r)]``: x (M, K) holds the routed token copies sorted
by expert, ``group_sizes`` (E,) int32 says how many rows each expert
owns, in order, and w (E, K, N) holds the experts' weights; y (M, N) is
in x's dtype, accumulated in f32; rows past the groups are 0.  The
counterpart of ``jax.lax.ragged_dot`` in the reference's ``moe_ragged``
(``repro/models/moe.py:64-67``).  On CUDA tensors this launches
``csrc/grouped_gemm.cu`` (bf16 on the tensor cores, f32 scalar); the
group sizes stay on the device, so a call makes no host sync.  On CPU
tensors it computes the plain version, one matmul per group.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref


@functools.cache
def _fn():
    fn = build.library("grouped_gemm").grouped_gemm
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 +
                   [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def grouped_gemm(x: torch.Tensor, w: torch.Tensor,
                 group_sizes: torch.Tensor) -> torch.Tensor:
    """x (M, K); w (E, K, N); group_sizes (E,) int32 -> y (M, N)."""
    m, k = x.shape
    e, k_w, n = w.shape
    if k_w != k or group_sizes.shape != (e,):
        raise ValueError(f"grouped_gemm: shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)} group_sizes "
                         f"{tuple(group_sizes.shape)}")
    if x.device.type == "cpu":
        return ref.grouped_gemm_ref(x, w, group_sizes)
    build.require_cuda("grouped_gemm", x, w, group_sizes)
    if x.dtype not in build.ATTN_DTYPES or w.dtype != x.dtype \
            or group_sizes.dtype != torch.int32:
        raise ValueError(f"grouped_gemm: dtypes {x.dtype} {w.dtype} "
                         f"{group_sizes.dtype}; need float32 or bfloat16 "
                         f"and int32 sizes")
    if not (x.is_contiguous() and w.is_contiguous()
            and group_sizes.is_contiguous()):
        raise ValueError("grouped_gemm: x, w and group_sizes must be "
                         "contiguous")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    if x.dtype == torch.bfloat16:
        if k % 8 or n % 8:
            raise ValueError(f"grouped_gemm: bf16 needs K and N multiples "
                             f"of 8, got {k}, {n}")
        build.require_aligned(
            "grouped_gemm", {"x": x.data_ptr(), "w": w.data_ptr(),
                             "y": y.data_ptr()}, {}, x.element_size())
    rc = _fn()(build.ATTN_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(),
               y.data_ptr(), group_sizes.data_ptr(), e, m, k, n,
               build.stream_of(x))
    build.check(rc, "grouped_gemm")
    grouped_gemm.launches += 1
    return y


grouped_gemm.launches = 0

"""The Mamba2 recurrent step — one decode token per sequence, in place.

``h ← h·exp(dt·A) + (dt·x) ⊗ B`` and ``y = h·C + D·x`` for each sequence
and SSD head: the recurrence of the reference's ``ssm_decode_step``
(``repro/models/ssm.py:138``, jnp there).  h (b, H, P, N) f32 is
updated in place; x (b, H, P) and B, C (b, N) in bf16 or f32; dt (b, H)
f32 after softplus; A (= -exp(A_log)) and D (H,); returns y (b, H, P)
f32.  On CUDA tensors this launches ``csrc/ssm_step.cu`` (one block per
head and sequence, each state element read and written once); on CPU
tensors it computes the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref


@functools.cache
def _fn():
    fn = build.library("ssm_step").ssm_step
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8 +
                   [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2 +
                   [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ssm_step(h: torch.Tensor, x: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             D: torch.Tensor) -> torch.Tensor:
    """h (b,H,P,N) f32, in place; x (b,H,P); B, C (b,N); dt (b,H) f32; A,
    D (H,).  Returns y (b,H,P) f32."""
    b, H, P, N = h.shape
    if x.shape != (b, H, P) or B.shape != (b, N) or C.shape != (b, N) \
            or dt.shape != (b, H) or A.shape != (H,) or D.shape != (H,):
        raise ValueError(f"ssm_step: shapes h {tuple(h.shape)} x "
                         f"{tuple(x.shape)} B {tuple(B.shape)} C "
                         f"{tuple(C.shape)} dt {tuple(dt.shape)} A "
                         f"{tuple(A.shape)} D {tuple(D.shape)}")
    if h.device.type == "cpu":
        return ref.ssm_step_ref(h, x, B, C, dt, A, D)
    build.require_cuda("ssm_step", h, x, B, C, dt, A, D)
    if h.dtype != torch.float32 or dt.dtype != torch.float32 or \
            x.dtype not in build.ATTN_DTYPES or B.dtype != x.dtype or \
            C.dtype != x.dtype:
        raise ValueError(f"ssm_step: dtypes h {h.dtype} dt {dt.dtype} x "
                         f"{x.dtype} B {B.dtype} C {C.dtype}; need f32 h "
                         f"and dt, and x, B, C all float32 or bfloat16")
    if N % 4 or N > 1024:
        raise ValueError(f"ssm_step: N {N} must be a multiple of 4, at "
                         f"most 1024")
    if not (h.is_contiguous() and dt.is_contiguous()) or \
            x.stride()[1:] != (P, 1) or B.stride(1) != 1 or \
            C.stride(1) != 1 or B.stride(0) != C.stride(0):
        raise ValueError("ssm_step: h and dt contiguous, x's (H, P) "
                         "contiguous, B and C rows contiguous with one "
                         "stride")
    build.require_aligned("ssm_step", {"h": h.data_ptr()}, {}, 4)
    y = torch.empty((b, H, P), dtype=torch.float32, device=h.device)
    if b == 0:
        return y
    A, D = A.float().contiguous(), D.float().contiguous()
    rc = _fn()(build.ATTN_DTYPES[x.dtype], h.data_ptr(), x.data_ptr(),
               B.data_ptr(), C.data_ptr(), dt.data_ptr(), A.data_ptr(),
               D.data_ptr(), y.data_ptr(), b, H, P, N, x.stride(0),
               B.stride(0), build.stream_of(h))
    build.check(rc, "ssm_step")
    ssm_step.launches += 1
    return y


ssm_step.launches = 0

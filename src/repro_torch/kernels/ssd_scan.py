"""The chunked SSD scan of Mamba2 — prefill and append over a sequence.

Within each chunk of ``L`` rows the quadratic term ``C_i·B_j ·
exp(cs_i - cs_j) · dt_j`` (j <= i) applied to x, across chunks the
carried state h (H, P, N) f32, plus ``D·x``: the chunk loop of the
reference's ``ssd_scan`` (``repro/models/ssm.py:59``, a ``lax.scan`` at
:116 of ``chunk_body`` :94-114, jnp there).  x (b, s, H, P), B and C (b,
s, N) in bf16 or f32; dt (b, s, H) f32 after softplus; A (= -exp(A_log))
and D (H,); h0 (b, H, P, N) f32 or None (zeros); ``chunk`` the config's
chunk size, of which a sequence shorter than it uses ``s`` (``L =
min(chunk, s)``, as the reference).  Returns (y (b, s, H, P) f32,
h_final (b, H, P, N) f32); with ``out_state`` the final state is written
there (it may be h0 itself: the engines carry state in place).  On CUDA
tensors one call launches the three kernels of ``csrc/ssd_scan.cu`` (P
64, N 128 or 64: mamba2-1.3b's and zamba2-2.7b's): C·Bᵀ once per chunk
beside the chunks' own
states, then the state passing over the chunks in order, then the
chunks' outputs (split TF32 on the tensor cores for bf16 inputs, f32
FMAs for f32 ones); their scratch (C·Bᵀ, the cumulative sums and the
chunk states, 33.5 MB of states at 4000 tokens) comes from PyTorch's
caching allocator.  On CPU tensors it computes the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, ref

HEAD_DIM, STATES = 64, (64, 128)   # the widths the kernel is built for
MAX_CHUNK = 256
TILE = 64                          # rows of the kernels' tiles


@functools.cache
def _fn():
    fn = build.library("ssd_scan").ssd_chunk_scan
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 12 +
                   [ctypes.c_int] * 4 + [ctypes.c_longlong] * 4 +
                   [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ssd_chunk_scan(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                   dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                   h0: Optional[torch.Tensor], chunk: int,
                   out_state: Optional[torch.Tensor] = None):
    """x (b,s,H,P); B, C (b,s,N); dt (b,s,H) f32; A, D (H,); h0
    (b,H,P,N) f32 or None.  Returns (y (b,s,H,P) f32, h_final)."""
    b, s, H, P = x.shape
    N = B.shape[-1]
    if B.shape != (b, s, N) or C.shape != (b, s, N) or \
            dt.shape != (b, s, H) or A.shape != (H,) or D.shape != (H,) \
            or (h0 is not None and h0.shape != (b, H, P, N)) or \
            (out_state is not None and out_state.shape != (b, H, P, N)) \
            or chunk < 1:
        raise ValueError(f"ssd_chunk_scan: shapes x {tuple(x.shape)} B "
                         f"{tuple(B.shape)} C {tuple(C.shape)} dt "
                         f"{tuple(dt.shape)} A {tuple(A.shape)} D "
                         f"{tuple(D.shape)} h0 "
                         f"{None if h0 is None else tuple(h0.shape)} chunk "
                         f"{chunk}")
    build.require_no_grad("ssd_chunk_scan", build.SSM_TRAINING, x, B, C, dt, A, D, h0)
    if x.device.type == "cpu":
        y, h = ref.ssd_chunk_scan_ref(x, B, C, dt, A, D, h0, chunk)
        if out_state is None:
            return y, h
        return y, out_state.copy_(h)
    states = [t for t in (h0, out_state) if t is not None]
    build.require_cuda("ssd_chunk_scan", x, B, C, dt, A, D, *states)
    if x.dtype not in build.ATTN_DTYPES or B.dtype != x.dtype or \
            C.dtype != x.dtype or dt.dtype != torch.float32 or \
            any(t.dtype != torch.float32 for t in states):
        raise ValueError(f"ssd_chunk_scan: dtypes x {x.dtype} B {B.dtype} "
                         f"C {C.dtype} dt {dt.dtype} states "
                         f"{[t.dtype for t in states]}; need x, B, C all "
                         f"float32 or bfloat16, f32 dt and states")
    if P != HEAD_DIM or N not in STATES or chunk > MAX_CHUNK:
        raise ValueError(f"ssd_chunk_scan: built for P {HEAD_DIM}, N in "
                         f"{STATES} and chunks up to {MAX_CHUNK}, got "
                         f"{(P, N)}, chunk {chunk}")
    if x.stride()[2:] != (P, 1) or B.stride(2) != 1 or C.stride(2) != 1 \
            or B.stride()[:2] != C.stride()[:2] or not dt.is_contiguous() \
            or not all(t.is_contiguous() for t in states):
        raise ValueError("ssd_chunk_scan: x's (H, P) contiguous, B and C "
                         "rows contiguous with one stride, dt and the "
                         "states contiguous")
    # x, B and C are read four elements at a time (16 bytes of f32, 8 of
    # bf16)
    build.require_aligned(
        "ssd_chunk_scan", {"x": x.data_ptr(), "B": B.data_ptr(),
                           "C": C.data_ptr()},
        {"x": x.stride()[:2], "B": B.stride()[:2]}, x.element_size(),
        align=4 * x.element_size())
    y = torch.empty((b, s, H, P), dtype=torch.float32, device=x.device)
    h_out = out_state if out_state is not None else torch.empty(
        (b, H, P, N), dtype=torch.float32, device=x.device)
    if b == 0:
        return y, h_out
    if s == 0:
        return y, (h_out.zero_() if h0 is None else h_out.copy_(h0))
    build.require_aligned("ssd_chunk_scan",
                          {"y": y.data_ptr(), "h_out": h_out.data_ptr()},
                          {}, 4)
    A, D = A.float().contiguous(), D.float().contiguous()
    L = min(chunk, s)
    nc, lt = -(-s // L), -(-L // TILE) * TILE
    f32 = dict(dtype=torch.float32, device=x.device)
    cb = torch.empty((b, nc, lt, lt), **f32)
    cs = torch.empty((b, nc, H, lt), **f32)
    chunk_states = torch.empty((b, nc, H, P, N), **f32)
    rc = _fn()(build.ATTN_DTYPES[x.dtype], N, x.data_ptr(), B.data_ptr(),
               C.data_ptr(), dt.data_ptr(), A.data_ptr(), D.data_ptr(),
               None if h0 is None else h0.data_ptr(), y.data_ptr(),
               h_out.data_ptr(), cb.data_ptr(), cs.data_ptr(),
               chunk_states.data_ptr(), b, s, H, L, x.stride(0),
               x.stride(1), B.stride(0), B.stride(1), build.stream_of(x))
    build.check(rc, "ssd_chunk_scan")
    ssd_chunk_scan.launches += 1
    return y, h_out


ssd_chunk_scan.launches = 0

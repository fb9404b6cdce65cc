"""The Mamba2 decode step — the token's causal conv, then the recurrence,
one launch per layer, in place.

For each sequence, the token's depthwise conv with SiLU over x, B and C
against the carried tails (the reference's ``_causal_conv`` at s = 1,
``repro/models/ssm.py:31``), then for each SSD head ``h ← h·exp(dt·A) +
(dt·x) ⊗ B`` and ``y = h·C + D·x`` on the conv's outputs: the recurrence
of ``ssm_decode_step`` (``repro/models/ssm.py:138``), jnp there.  h (b,
H, P, N) f32 is updated in place; x (b, H, P) and B, C (b, N) are the
token's pre-conv projections, in bf16 or f32; w_x (cw, H·P), w_B, w_C
(cw, N) the conv weights and tail_x (b, cw - 1, H·P), tail_B, tail_C (b,
cw - 1, N) the tails, all of x's dtype, all three updated in place; dt
(b, H) f32 after softplus; A (= -exp(A_log)) and D (H,).  Returns y (b,
H, P) f32.  On CUDA tensors this launches ``csrc/ssm_step.cu``: one block
per head and sequence streams the head's state (bound by its bytes, read
once and written once), every thread's copies of it issued before the
conv; every head's block reads the old B and C tails, and the sequence's
last block to arrive writes their new rows, counted on per-sequence
arrival counters that this module owns (one int32 per sequence, device
and stream, each on its own 128-byte line, zeroed once; each launch
leaves them 0).  On CPU tensors it computes the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
# the longest conv the kernel takes: the prefill conv's, so a model's
# prefill and decode accept the same widths
from repro_torch.kernels.causal_conv import MAX_CW


ARRIVAL_STRIDE = 32            # int32s between two sequences' counters
# the kernel's per-sequence arrival counters, by (device, stream)
_ARRIVALS: dict = {}


@functools.cache
def _fn():
    fn = build.library("ssm_step").ssm_step
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 15 +
                   [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2 +
                   [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _arrivals(device: torch.device, stream: int, b: int) -> torch.Tensor:
    """Arrival counters for ``b`` sequences' launches on ``stream``, one
    128-byte line each (``ARRIVAL_STRIDE`` int32s apart), all 0: zeroed
    when allocated (grown only when a call has more sequences than ever
    before), never reset from the host; every launch leaves the counters
    it used at 0.  Two streams never share counters, so two launches in
    flight at once never count into one."""
    have = _ARRIVALS.get((device, stream))
    if have is None or have.numel() < b * ARRIVAL_STRIDE:
        have = torch.zeros(max(b, 64) * ARRIVAL_STRIDE, dtype=torch.int32,
                           device=device)
        _ARRIVALS[(device, stream)] = have
    return have


def ssm_step(h: torch.Tensor, x: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, w_x: torch.Tensor, w_B: torch.Tensor,
             w_C: torch.Tensor, tail_x: torch.Tensor, tail_B: torch.Tensor,
             tail_C: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             D: torch.Tensor):
    """h (b,H,P,N) f32, in place; x (b,H,P); B, C (b,N); w_x (cw,H·P);
    w_B, w_C (cw,N); tail_x (b,cw-1,H·P), tail_B, tail_C (b,cw-1,N), all
    in place; dt (b,H) f32; A, D (H,).  Returns y (b,H,P) f32."""
    b, H, P, N = h.shape
    cw = w_x.shape[0]
    if x.shape != (b, H, P) or B.shape != (b, N) or C.shape != (b, N) \
            or w_x.shape != (cw, H * P) or w_B.shape != (cw, N) or \
            w_C.shape != (cw, N) or tail_x.shape != (b, cw - 1, H * P) \
            or tail_B.shape != (b, cw - 1, N) or \
            tail_C.shape != (b, cw - 1, N) or dt.shape != (b, H) or \
            A.shape != (H,) or D.shape != (H,) or cw < 2:
        raise ValueError(
            f"ssm_step: shapes h {tuple(h.shape)} x {tuple(x.shape)} B "
            f"{tuple(B.shape)} C {tuple(C.shape)} w_x {tuple(w_x.shape)} "
            f"w_B {tuple(w_B.shape)} w_C {tuple(w_C.shape)} tail_x "
            f"{tuple(tail_x.shape)} tail_B {tuple(tail_B.shape)} tail_C "
            f"{tuple(tail_C.shape)} dt {tuple(dt.shape)} A "
            f"{tuple(A.shape)} D {tuple(D.shape)}")
    act = (x, B, C, w_x, w_B, w_C, tail_x, tail_B, tail_C)
    if h.dtype != torch.float32 or dt.dtype != torch.float32 or \
            x.dtype not in build.ATTN_DTYPES or \
            any(t.dtype != x.dtype for t in act):
        raise ValueError(f"ssm_step: dtypes h {h.dtype} dt {dt.dtype}, "
                         f"x, B, C, weights and tails "
                         f"{[t.dtype for t in act]}; need f32 h and dt, "
                         f"and the rest all float32 or all bfloat16")
    build.require_no_grad("ssm_step", build.DECODE_ONLY, h, *act, dt, A, D)
    if h.device.type == "cpu":
        return ref.ssm_conv_step_ref(h, x, B, C, w_x, w_B, w_C, tail_x,
                                     tail_B, tail_C, dt, A, D)
    build.require_cuda("ssm_step", h, *act, dt, A, D)
    if N % 4 or N > 1024 or P > 1024 or cw > MAX_CW:
        raise ValueError(f"ssm_step: N {N} must be a multiple of 4, at "
                         f"most 1024; P {P} at most 1024; cw {cw} at most "
                         f"{MAX_CW}")
    if not all(t.is_contiguous() for t in (h, dt, w_x, w_B, w_C, tail_x,
                                           tail_B, tail_C)) or \
            x.stride()[1:] != (P, 1) or B.stride(1) != 1 or \
            C.stride(1) != 1 or B.stride(0) != C.stride(0):
        raise ValueError("ssm_step: h, dt, the weights and the tails "
                         "contiguous, x's (H, P) contiguous, B and C rows "
                         "contiguous with one stride")
    build.require_aligned("ssm_step", {"h": h.data_ptr()}, {}, 4)
    y = torch.empty((b, H, P), dtype=torch.float32, device=h.device)
    if b == 0:
        return y
    A, D = A.float().contiguous(), D.float().contiguous()
    stream = build.stream_of(h)
    arrivals = _arrivals(h.device, stream.value, b)
    rc = _fn()(build.ATTN_DTYPES[x.dtype], h.data_ptr(),
               *(t.data_ptr() for t in act), arrivals.data_ptr(),
               dt.data_ptr(), A.data_ptr(), D.data_ptr(), y.data_ptr(), b,
               H, P, N, cw, x.stride(0), B.stride(0), stream)
    build.check(rc, "ssm_step")
    ssm_step.launches += 1
    return y


ssm_step.launches = 0

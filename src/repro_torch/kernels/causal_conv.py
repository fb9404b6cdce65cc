"""Mamba2's depthwise causal conv with SiLU, carrying its tail — Triton.

``out[t] = silu(sum_i xp[t + i] · w[i])`` over ``xp = tail ‖ x`` along
the sequence, channel by channel, and the new tail (the last ``cw - 1``
rows of xp): the reference's ``_causal_conv`` (``repro/models/ssm.py:31``,
jnp there), run over x, B and C concatenated into one channel axis so a
layer makes one launch (4096 + 128 + 128 = 4352 channels for
mamba2-1.3b).  x (b, s, c), w (cw, c) and tail (b, cw - 1, c) of one
dtype, bf16 or f32, contiguous; returns (out (b, s, c), new_tail (b, cw
- 1, c)) in that dtype.  The prefill path (s up to the append) runs it,
one launch per layer per append.

The kernel is Triton: a stencil of ``cw`` multiply-adds per element and
an elementwise SiLU, no tensor-core work and no reuse across threads
beyond the ``cw - 1``-row halo, which Triton's blocked loads serve as
well as CUDA would.  Bound: bytes (each element read once and written
once, ~12 flops).  A program walks a run of ``RUN`` rows of one strip of
``BLOCK_C`` channels (one warp, 16 bytes a thread in bf16), ``ROWS``
rows a step loaded together a step ahead, and keeps the last ``cw - 1``
rows in registers, so each input row is read once (the ``cw - 1`` rows before a
run come from the tail or from x, once a run); ``RUN`` is cut so that
the grid holds about ``TARGET_PROGRAMS`` programs.  It accumulates in f32
and rounds once; the plain version keeps the reference's bf16 order
(each product and partial sum rounded), so in bf16 the two agree within
a rounding step.  The kernel takes ``cw`` up to 4 (mamba2's is 4).  On
CPU tensors the wrapper computes the plain version.  Triton is imported,
and the kernel compiled, at the first launch: the CPU has no ``triton``.
The decode's conv rides in the recurrent step's launch (``ssm_step``);
this wrapper still takes s = 1.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build, ref

BLOCK_C = 256              # channels of a strip: one warp, 16 B a thread
ROWS = 4                   # rows loaded together in a step of a run
TARGET_PROGRAMS = 2048     # programs (one warp each) the runs aim at
MAX_CW = 4                 # taps the kernel holds (w0..w3); ssm_step's too
tl = None                  # triton.language, bound at the first launch


def _conv_kernel(x_ptr, w_ptr, tail_ptr, out_ptr, new_tail_ptr, S, C, RUN,
                 CW: tl.constexpr, TAIL_ROWS: tl.constexpr,
                 BLOCK_C: tl.constexpr):
    b = tl.program_id(0)
    run = tl.program_id(1)
    cols = tl.program_id(2) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    r0 = run * RUN
    r_end = tl.minimum(r0 + RUN, S)
    # wk multiplies row r - k: w[CW - 1 - k], zero past the conv's width
    w0 = tl.load(w_ptr + (CW - 1) * C + cols, mask=cmask,
                 other=0.0).to(tl.float32)
    w1 = tl.load(w_ptr + (CW - 2) * C + cols, mask=cmask,
                 other=0.0).to(tl.float32)
    w2 = tl.zeros((BLOCK_C,), dtype=tl.float32)
    if CW >= 3:
        w2 = tl.load(w_ptr + (CW - 3) * C + cols, mask=cmask,
                     other=0.0).to(tl.float32)
    w3 = tl.zeros((BLOCK_C,), dtype=tl.float32)
    if CW >= 4:
        w3 = tl.load(w_ptr + (CW - 4) * C + cols, mask=cmask,
                     other=0.0).to(tl.float32)
    # the three rows before the run: from x, or from the tail before row 0
    # (rows before the tail are zeros, and their weights are zero)
    src = r0 - 3
    p3 = tl.load(x_ptr + (b * S + src) * C + cols,
                 mask=cmask & (src >= 0), other=0.0).to(tl.float32) + \
        tl.load(tail_ptr + (b * (CW - 1) + src + CW - 1) * C + cols,
                mask=cmask & (src < 0) & (src + CW - 1 >= 0),
                other=0.0).to(tl.float32)
    src = r0 - 2
    p2 = tl.load(x_ptr + (b * S + src) * C + cols,
                 mask=cmask & (src >= 0), other=0.0).to(tl.float32) + \
        tl.load(tail_ptr + (b * (CW - 1) + src + CW - 1) * C + cols,
                mask=cmask & (src < 0) & (src + CW - 1 >= 0),
                other=0.0).to(tl.float32)
    src = r0 - 1
    p1 = tl.load(x_ptr + (b * S + src) * C + cols,
                 mask=cmask & (src >= 0), other=0.0).to(tl.float32) + \
        tl.load(tail_ptr + (b * (CW - 1) + src + CW - 1) * C + cols,
                mask=cmask & (src < 0) & (src + CW - 1 >= 0),
                other=0.0).to(tl.float32)
    ty = out_ptr.dtype.element_ty
    # ROWS (4) rows a step, the next step's rows loaded before this step's
    # are computed and stored, so two steps' loads are in flight
    row = (b * S + r0) * C + cols
    x0 = tl.load(x_ptr + row, mask=cmask & (r0 < r_end),
                 other=0.0).to(tl.float32)
    x1 = tl.load(x_ptr + row + C, mask=cmask & (r0 + 1 < r_end),
                 other=0.0).to(tl.float32)
    x2 = tl.load(x_ptr + row + 2 * C, mask=cmask & (r0 + 2 < r_end),
                 other=0.0).to(tl.float32)
    x3 = tl.load(x_ptr + row + 3 * C, mask=cmask & (r0 + 3 < r_end),
                 other=0.0).to(tl.float32)
    for r in range(r0, r_end, 4):
        row = (b * S + r) * C + cols
        n0 = tl.load(x_ptr + row + 4 * C, mask=cmask & (r + 4 < r_end),
                     other=0.0).to(tl.float32)
        n1 = tl.load(x_ptr + row + 5 * C, mask=cmask & (r + 5 < r_end),
                     other=0.0).to(tl.float32)
        n2 = tl.load(x_ptr + row + 6 * C, mask=cmask & (r + 6 < r_end),
                     other=0.0).to(tl.float32)
        n3 = tl.load(x_ptr + row + 7 * C, mask=cmask & (r + 7 < r_end),
                     other=0.0).to(tl.float32)
        # oldest row first, as the reference sums the taps
        o0 = p3 * w3 + p2 * w2 + p1 * w1 + x0 * w0
        o1 = p2 * w3 + p1 * w2 + x0 * w1 + x1 * w0
        o2 = p1 * w3 + x0 * w2 + x1 * w1 + x2 * w0
        o3 = x0 * w3 + x1 * w2 + x2 * w1 + x3 * w0
        tl.store(out_ptr + row, (o0 * tl.sigmoid(o0)).to(ty),
                 mask=cmask & (r < r_end))
        tl.store(out_ptr + row + C, (o1 * tl.sigmoid(o1)).to(ty),
                 mask=cmask & (r + 1 < r_end))
        tl.store(out_ptr + row + 2 * C, (o2 * tl.sigmoid(o2)).to(ty),
                 mask=cmask & (r + 2 < r_end))
        tl.store(out_ptr + row + 3 * C, (o3 * tl.sigmoid(o3)).to(ty),
                 mask=cmask & (r + 3 < r_end))
        p3 = x1
        p2 = x2
        p1 = x3
        x0 = n0
        x1 = n1
        x2 = n2
        x3 = n3
    if run == 0:
        # the new tail: rows S - (CW - 1) + q of tail ‖ x
        q = tl.arange(0, TAIL_ROWS)
        t_src = S - (CW - 1) + q
        qmask = q < CW - 1
        t_x = tl.load(x_ptr + (b * S + t_src)[:, None] * C + cols[None, :],
                      mask=(qmask & (t_src >= 0))[:, None] & cmask[None, :],
                      other=0.0)
        t_t = tl.load(tail_ptr + (b * (CW - 1) + t_src + (CW - 1))[:, None]
                      * C + cols[None, :],
                      mask=(qmask & (t_src < 0))[:, None] & cmask[None, :],
                      other=0.0)
        tl.store(new_tail_ptr + (b * (CW - 1) + q)[:, None] * C +
                 cols[None, :], t_x + t_t,
                 mask=qmask[:, None] & cmask[None, :])


def run_length(b: int, s: int, c: int) -> int:
    """Rows of one program's run: a multiple of ``ROWS``, cut so that the
    grid (b, ceil(s / run), ceil(c / BLOCK_C)) holds about
    ``TARGET_PROGRAMS`` programs where the rows allow."""
    strips = -(-c // BLOCK_C)
    runs = max(1, min(-(-TARGET_PROGRAMS // max(1, b * strips)),
                      -(-s // ROWS)))
    return -(-(-(-s // runs)) // ROWS) * ROWS


@functools.cache
def _kernel():
    global tl
    import triton
    import triton.language
    tl = triton.language
    return triton.jit(_conv_kernel)


def causal_conv(x: torch.Tensor, w: torch.Tensor, tail: torch.Tensor):
    """x (b,s,c); w (cw,c); tail (b,cw-1,c) -> (out (b,s,c), new_tail)."""
    b, s, c = x.shape
    cw = w.shape[0]
    if w.shape != (cw, c) or tail.shape != (b, cw - 1, c) or cw < 2:
        raise ValueError(f"causal_conv: shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)} tail {tuple(tail.shape)}")
    build.require_no_grad("causal_conv", build.SSM_TRAINING, x, w, tail)
    if x.device.type == "cpu":
        return ref.causal_conv_ref(x, w, tail)
    if x.device.type != "cuda" or w.device != x.device or \
            tail.device != x.device:
        raise ValueError(f"causal_conv: tensors must share one CUDA device, "
                         f"got {[t.device for t in (x, w, tail)]}")
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            w.dtype != x.dtype or tail.dtype != x.dtype:
        raise ValueError(f"causal_conv: dtypes {x.dtype} {w.dtype} "
                         f"{tail.dtype}; need one of float32, bfloat16")
    if not (x.is_contiguous() and w.is_contiguous()
            and tail.is_contiguous()):
        raise ValueError("causal_conv: x, w and tail must be contiguous")
    if x.numel() >= 2 ** 31:
        raise ValueError("causal_conv: the kernel's offsets are 32-bit")
    if cw > MAX_CW:
        raise ValueError(f"causal_conv: the kernel takes cw up to {MAX_CW}, "
                         f"got {cw}")
    out = torch.empty_like(x)
    new_tail = torch.empty_like(tail)
    if b == 0 or s == 0:
        return out, new_tail.copy_(tail)
    run = run_length(b, s, c)
    grid = (b, -(-s // run), -(-c // BLOCK_C))
    _kernel()[grid](x, w, tail, out, new_tail, s, c, run, CW=cw,
                    TAIL_ROWS=max(2, 1 << (cw - 2).bit_length()),
                    BLOCK_C=BLOCK_C, num_warps=1)
    causal_conv.launches += 1
    return out, new_tail


causal_conv.launches = 0

"""Mamba2's depthwise causal conv with SiLU, carrying its tail — Triton.

``out[t] = silu(sum_i xp[t + i] · w[i])`` over ``xp = tail ‖ x`` along
the sequence, channel by channel, and the new tail (the last ``cw - 1``
rows of xp): the reference's ``_causal_conv`` (``repro/models/ssm.py:31``,
jnp there), run over x, B and C concatenated into one channel axis so a
layer makes one launch (4096 + 128 + 128 = 4352 channels for
mamba2-1.3b).  x (b, s, c), w (cw, c) and tail (b, cw - 1, c) of one
dtype, bf16 or f32, contiguous; returns (out (b, s, c), new_tail (b, cw
- 1, c)) in that dtype.  The prefill path (s up to the append) and the
decode path (s = 1) both run it.

The kernel is Triton: a stencil of ``cw`` multiply-adds per element and
an elementwise SiLU, no tensor-core work and no reuse across threads
beyond the ``cw - 1``-row halo, which blocked loads express as well as
CUDA would.  A program takes ``BLOCK_S`` rows by ``BLOCK_C`` channels,
loads the ``cw`` shifted row blocks (from the tail where a row falls
before the sequence), accumulates in f32 and rounds once; the plain
version keeps the reference's bf16 order (each product and partial sum
rounded), so in bf16 the two agree within a rounding step.  Bound:
bytes (each element read once and written once, ~10 flops).  On CPU
tensors the wrapper computes the plain version.  Triton is imported, and
the kernel compiled, at the first launch: the CPU has no ``triton``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ref

BLOCK_S, BLOCK_C = 32, 128
tl = None                  # triton.language, bound at the first launch


def _conv_kernel(x_ptr, w_ptr, tail_ptr, out_ptr, new_tail_ptr, S, C,
                 CW: tl.constexpr, TAIL_ROWS: tl.constexpr,
                 BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
    b = tl.program_id(0)
    ps = tl.program_id(1)
    cols = tl.program_id(2) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    rows = ps * BLOCK_S + tl.arange(0, BLOCK_S)
    rmask = rows < S
    acc = tl.zeros((BLOCK_S, BLOCK_C), dtype=tl.float32)
    for i in tl.static_range(CW):
        src = rows + i - (CW - 1)              # row of x; below 0: the tail
        in_x = rmask & (src >= 0)
        in_t = rmask & (src < 0)
        xv = tl.load(x_ptr + (b * S + src)[:, None] * C + cols[None, :],
                     mask=in_x[:, None] & cmask[None, :], other=0.0)
        tv = tl.load(tail_ptr + (b * (CW - 1) + src + (CW - 1))[:, None] * C
                     + cols[None, :], mask=in_t[:, None] & cmask[None, :],
                     other=0.0)
        wv = tl.load(w_ptr + i * C + cols, mask=cmask, other=0.0)
        acc += (xv.to(tl.float32) + tv.to(tl.float32)) * \
            wv.to(tl.float32)[None, :]
    y = acc * tl.sigmoid(acc)
    tl.store(out_ptr + (b * S + rows)[:, None] * C + cols[None, :],
             y.to(out_ptr.dtype.element_ty),
             mask=rmask[:, None] & cmask[None, :])
    if ps == 0:
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
    out = torch.empty_like(x)
    new_tail = torch.empty_like(tail)
    if b == 0 or s == 0:
        return out, new_tail.copy_(tail)
    grid = (b, -(-s // BLOCK_S), -(-c // BLOCK_C))
    _kernel()[grid](x, w, tail, out, new_tail, s, c, CW=cw,
                    TAIL_ROWS=max(2, 1 << (cw - 2).bit_length()),
                    BLOCK_S=BLOCK_S, BLOCK_C=BLOCK_C, num_warps=4)
    causal_conv.launches += 1
    return out, new_tail


causal_conv.launches = 0

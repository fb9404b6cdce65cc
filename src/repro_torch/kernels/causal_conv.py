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

Training differentiates it (:class:`_CausalConv`): the backward,
:func:`causal_conv_bwd`, is Triton too, over the forward's grid of runs
and strips, ``ROWS`` rows a step with the next step's loads in flight as
the forward does.  A program recomputes each row's ``pre`` as the
forward sums it, ``dpre = dout σ(pre) (1 + pre (1 - σ(pre)))``, and
writes ``dx[r] = Σ_k dpre[r + k] w[cw - 1 - k]`` (plus the new tail's
cotangent on the rows the tail copied) once the three rows after r are
known, recomputing the first three rows of the next run; the first run
writes the old tail's gradient.  dw's per-program partials (f32) are
summed in program order by a second kernel spread over strips of
``DW_BLOCK`` columns and the taps, so the gradient is bit-reproducible
without atomics.  Bound: bytes, as the forward's.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build, ref

BLOCK_C = 256              # channels of a strip: one warp, 16 B a thread
ROWS = 4                   # rows loaded together in a step of a run
TARGET_PROGRAMS = 2048     # programs (one warp each) the runs aim at
MAX_CW = 4                 # taps the kernel holds (w0..w3); ssm_step's too
DW_BLOCK = 64              # columns of a program of dw's reduction
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


def _conv_bwd_kernel(x_ptr, w_ptr, tail_ptr, dout_ptr, dnt_ptr, dx_ptr,
                     dtail_ptr, dwp_ptr, S, C, RUN, RUNS, CW: tl.constexpr,
                     HAS_DNT: tl.constexpr, BLOCK_C: tl.constexpr):
    """dx, dtail and the per-program partials of dw for rows [r0, r0 +
    RUN) of one strip, ``ROWS`` (4) rows a step with the next step's x
    and dout loaded before this step's arithmetic: row t's ``pre``
    recomputed as the forward sums it, ``dpre = dout σ(pre) (1 + pre (1 -
    σ(pre)))``, the last three rows' x and dpre carried in registers;
    ``dx[r] = Σ_k dpre[r + k] wk`` once dpre[r + 3] is known (rows before
    the run's first are finished by the run before, whose last rows this
    one recomputes), plus the new tail's cotangent on the rows it copied;
    the first run writes dtail."""
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
    # dpre of rows t - 3, t - 2, t - 1 (rows before the run: 0)
    q3 = tl.zeros((BLOCK_C,), dtype=tl.float32)
    q2 = tl.zeros((BLOCK_C,), dtype=tl.float32)
    q1 = tl.zeros((BLOCK_C,), dtype=tl.float32)
    a0 = tl.zeros((BLOCK_C,), dtype=tl.float32)
    a1 = tl.zeros((BLOCK_C,), dtype=tl.float32)
    a2 = tl.zeros((BLOCK_C,), dtype=tl.float32)
    a3 = tl.zeros((BLOCK_C,), dtype=tl.float32)
    ty = dx_ptr.dtype.element_ty
    # this step's rows t .. t + 3 (zeros past the sequence)
    row = (b * S + r0) * C + cols
    x0 = tl.load(x_ptr + row, mask=cmask & (r0 < S), other=0.0).to(tl.float32)
    x1 = tl.load(x_ptr + row + C, mask=cmask & (r0 + 1 < S),
                 other=0.0).to(tl.float32)
    x2 = tl.load(x_ptr + row + 2 * C, mask=cmask & (r0 + 2 < S),
                 other=0.0).to(tl.float32)
    x3 = tl.load(x_ptr + row + 3 * C, mask=cmask & (r0 + 3 < S),
                 other=0.0).to(tl.float32)
    g0 = tl.load(dout_ptr + row, mask=cmask & (r0 < S),
                 other=0.0).to(tl.float32)
    g1 = tl.load(dout_ptr + row + C, mask=cmask & (r0 + 1 < S),
                 other=0.0).to(tl.float32)
    g2 = tl.load(dout_ptr + row + 2 * C, mask=cmask & (r0 + 2 < S),
                 other=0.0).to(tl.float32)
    g3 = tl.load(dout_ptr + row + 3 * C, mask=cmask & (r0 + 3 < S),
                 other=0.0).to(tl.float32)
    for t in range(r0, r_end + 3, 4):
        # the next step's rows, in flight during this step's arithmetic
        row = (b * S + t) * C + cols
        n0 = tl.load(x_ptr + row + 4 * C, mask=cmask & (t + 4 < S),
                     other=0.0).to(tl.float32)
        n1 = tl.load(x_ptr + row + 5 * C, mask=cmask & (t + 5 < S),
                     other=0.0).to(tl.float32)
        n2 = tl.load(x_ptr + row + 6 * C, mask=cmask & (t + 6 < S),
                     other=0.0).to(tl.float32)
        n3 = tl.load(x_ptr + row + 7 * C, mask=cmask & (t + 7 < S),
                     other=0.0).to(tl.float32)
        m0 = tl.load(dout_ptr + row + 4 * C, mask=cmask & (t + 4 < S),
                     other=0.0).to(tl.float32)
        m1 = tl.load(dout_ptr + row + 5 * C, mask=cmask & (t + 5 < S),
                     other=0.0).to(tl.float32)
        m2 = tl.load(dout_ptr + row + 6 * C, mask=cmask & (t + 6 < S),
                     other=0.0).to(tl.float32)
        m3 = tl.load(dout_ptr + row + 7 * C, mask=cmask & (t + 7 < S),
                     other=0.0).to(tl.float32)
        # oldest row first, as the forward sums the taps
        e0 = p3 * w3 + p2 * w2 + p1 * w1 + x0 * w0
        e1 = p2 * w3 + p1 * w2 + x0 * w1 + x1 * w0
        e2 = p1 * w3 + x0 * w2 + x1 * w1 + x2 * w0
        e3 = x0 * w3 + x1 * w2 + x2 * w1 + x3 * w0
        s0 = tl.sigmoid(e0)
        s1 = tl.sigmoid(e1)
        s2 = tl.sigmoid(e2)
        s3 = tl.sigmoid(e3)
        d0 = g0 * s0 * (1.0 + e0 * (1.0 - s0))
        d1 = g1 * s1 * (1.0 + e1 * (1.0 - s1))
        d2 = g2 * s2 * (1.0 + e2 * (1.0 - s2))
        d3 = g3 * s3 * (1.0 + e3 * (1.0 - s3))
        # dw's partials over this run's own rows, row by row in order
        o0 = (t < r_end).to(tl.float32)
        o1 = (t + 1 < r_end).to(tl.float32)
        o2 = (t + 2 < r_end).to(tl.float32)
        o3 = (t + 3 < r_end).to(tl.float32)
        a0 += o0 * d0 * x0
        a1 += o0 * d0 * p1
        a2 += o0 * d0 * p2
        a3 += o0 * d0 * p3
        a0 += o1 * d1 * x1
        a1 += o1 * d1 * x0
        a2 += o1 * d1 * p1
        a3 += o1 * d1 * p2
        a0 += o2 * d2 * x2
        a1 += o2 * d2 * x1
        a2 += o2 * d2 * x0
        a3 += o2 * d2 * p1
        a0 += o3 * d3 * x3
        a1 += o3 * d3 * x2
        a2 += o3 * d3 * x1
        a3 += o3 * d3 * x0
        # rows t - 3 .. t are complete: each its x, or a tail row
        # (x-row -CW+1..-1)
        f0 = q3 * w0 + q2 * w1 + q1 * w2 + d0 * w3
        f1 = q2 * w0 + q1 * w1 + d0 * w2 + d1 * w3
        f2 = q1 * w0 + d0 * w1 + d1 * w2 + d2 * w3
        f3 = d0 * w0 + d1 * w1 + d2 * w2 + d3 * w3
        r = t - 3
        if HAS_DNT:
            # tail ‖ x row r + CW - 1 is row r + CW - 1 - S of the new tail
            m = r + CW - 1 - S
            f0 += tl.load(dnt_ptr + (b * (CW - 1) + m) * C + cols,
                          mask=cmask & (m >= 0) & (m < CW - 1),
                          other=0.0).to(tl.float32)
            f1 += tl.load(dnt_ptr + (b * (CW - 1) + m + 1) * C + cols,
                          mask=cmask & (m + 1 >= 0) & (m + 1 < CW - 1),
                          other=0.0).to(tl.float32)
            f2 += tl.load(dnt_ptr + (b * (CW - 1) + m + 2) * C + cols,
                          mask=cmask & (m + 2 >= 0) & (m + 2 < CW - 1),
                          other=0.0).to(tl.float32)
            f3 += tl.load(dnt_ptr + (b * (CW - 1) + m + 3) * C + cols,
                          mask=cmask & (m + 3 >= 0) & (m + 3 < CW - 1),
                          other=0.0).to(tl.float32)
        out = (b * S + r) * C + cols
        tl.store(dx_ptr + out, f0.to(ty),
                 mask=cmask & (r >= r0) & (r < r_end))
        tl.store(dx_ptr + out + C, f1.to(ty),
                 mask=cmask & (r + 1 >= r0) & (r + 1 < r_end))
        tl.store(dx_ptr + out + 2 * C, f2.to(ty),
                 mask=cmask & (r + 2 >= r0) & (r + 2 < r_end))
        tl.store(dx_ptr + out + 3 * C, f3.to(ty),
                 mask=cmask & (r + 3 >= r0) & (r + 3 < r_end))
        tail = (b * (CW - 1) + r + CW - 1) * C + cols
        first = run == 0
        tl.store(dtail_ptr + tail, f0.to(ty), mask=cmask & first & (r < 0) &
                 (r + CW - 1 >= 0))
        tl.store(dtail_ptr + tail + C, f1.to(ty), mask=cmask & first &
                 (r + 1 < 0) & (r + CW >= 0))
        tl.store(dtail_ptr + tail + 2 * C, f2.to(ty), mask=cmask & first &
                 (r + 2 < 0) & (r + CW + 1 >= 0))
        p3 = x1
        p2 = x2
        p1 = x3
        q3 = d1
        q2 = d2
        q1 = d3
        x0 = n0
        x1 = n1
        x2 = n2
        x3 = n3
        g0 = m0
        g1 = m1
        g2 = m2
        g3 = m3
    part = dwp_ptr + ((b * RUNS + run) * 4) * C + cols
    tl.store(part, a0, mask=cmask)
    tl.store(part + C, a1, mask=cmask)
    tl.store(part + 2 * C, a2, mask=cmask)
    tl.store(part + 3 * C, a3, mask=cmask)


def _conv_bwd_dw_kernel(dwp_ptr, dw_ptr, NPART, C, CW: tl.constexpr,
                        BLOCK: tl.constexpr):
    """dw[CW - 1 - k] for tap k (program_id(1)) over ``BLOCK`` columns
    (program_id(0)): the programs' partials summed in program order, the
    loads of sixteen partials issued together (a missing partial adds
    0.0), rounded once to dw's dtype."""
    k = tl.program_id(1)
    cols = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    cmask = cols < C
    acc = tl.zeros((BLOCK,), dtype=tl.float32)
    for p0 in range(0, NPART, 16):
        src = dwp_ptr + (p0 * 4 + k) * C + cols
        v0 = tl.load(src, mask=cmask, other=0.0)
        v1 = tl.load(src + 4 * C,
                      mask=cmask & (p0 + 1 < NPART), other=0.0)
        v2 = tl.load(src + 8 * C,
                      mask=cmask & (p0 + 2 < NPART), other=0.0)
        v3 = tl.load(src + 12 * C,
                      mask=cmask & (p0 + 3 < NPART), other=0.0)
        v4 = tl.load(src + 16 * C,
                      mask=cmask & (p0 + 4 < NPART), other=0.0)
        v5 = tl.load(src + 20 * C,
                      mask=cmask & (p0 + 5 < NPART), other=0.0)
        v6 = tl.load(src + 24 * C,
                      mask=cmask & (p0 + 6 < NPART), other=0.0)
        v7 = tl.load(src + 28 * C,
                      mask=cmask & (p0 + 7 < NPART), other=0.0)
        v8 = tl.load(src + 32 * C,
                      mask=cmask & (p0 + 8 < NPART), other=0.0)
        v9 = tl.load(src + 36 * C,
                      mask=cmask & (p0 + 9 < NPART), other=0.0)
        v10 = tl.load(src + 40 * C,
                      mask=cmask & (p0 + 10 < NPART), other=0.0)
        v11 = tl.load(src + 44 * C,
                      mask=cmask & (p0 + 11 < NPART), other=0.0)
        v12 = tl.load(src + 48 * C,
                      mask=cmask & (p0 + 12 < NPART), other=0.0)
        v13 = tl.load(src + 52 * C,
                      mask=cmask & (p0 + 13 < NPART), other=0.0)
        v14 = tl.load(src + 56 * C,
                      mask=cmask & (p0 + 14 < NPART), other=0.0)
        v15 = tl.load(src + 60 * C,
                      mask=cmask & (p0 + 15 < NPART), other=0.0)
        acc += v0
        acc += v1
        acc += v2
        acc += v3
        acc += v4
        acc += v5
        acc += v6
        acc += v7
        acc += v8
        acc += v9
        acc += v10
        acc += v11
        acc += v12
        acc += v13
        acc += v14
        acc += v15
    tl.store(dw_ptr + (CW - 1 - k) * C + cols,
             acc.to(dw_ptr.dtype.element_ty), mask=cmask)


def run_length(b: int, s: int, c: int) -> int:
    """Rows of one program's run: a multiple of ``ROWS``, cut so that the
    grid (b, ceil(s / run), ceil(c / BLOCK_C)) holds about
    ``TARGET_PROGRAMS`` programs where the rows allow."""
    strips = -(-c // BLOCK_C)
    runs = max(1, min(-(-TARGET_PROGRAMS // max(1, b * strips)),
                      -(-s // ROWS)))
    return -(-(-(-s // runs)) // ROWS) * ROWS


@functools.cache
def _kernels():
    """The three kernels, jitted at the first launch: (forward, backward,
    the backward's dw reduction)."""
    global tl
    import triton
    import triton.language
    tl = triton.language
    return tuple(triton.jit(k) for k in (_conv_kernel, _conv_bwd_kernel,
                                         _conv_bwd_dw_kernel))


def _check(kernel, x, w, tail):
    b, s, c = x.shape
    cw = w.shape[0]
    if w.shape != (cw, c) or tail.shape != (b, cw - 1, c) or cw < 2:
        raise ValueError(f"{kernel}: shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)} tail {tuple(tail.shape)}")
    return b, s, c, cw


def _check_cuda(kernel, *tensors):
    x = tensors[0]
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in tensors):
        raise ValueError(f"{kernel}: tensors must share one CUDA device, "
                         f"got {[t.device for t in tensors]}")
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            any(t.dtype != x.dtype for t in tensors):
        raise ValueError(f"{kernel}: dtypes {[t.dtype for t in tensors]}; "
                         f"need one of float32, bfloat16")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{kernel}: x, w and tail must be contiguous")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{kernel}: the kernel's offsets are 32-bit")
    if tensors[1].shape[0] > MAX_CW:
        raise ValueError(f"{kernel}: the kernel takes cw up to {MAX_CW}, "
                         f"got {tensors[1].shape[0]}")


def causal_conv(x: torch.Tensor, w: torch.Tensor, tail: torch.Tensor):
    """x (b,s,c); w (cw,c); tail (b,cw-1,c) -> (out (b,s,c), new_tail).
    Under grad (grad mode on, an input requiring grad) it goes through
    :class:`_CausalConv`, whose backward is :func:`causal_conv_bwd`."""
    _check("causal_conv", x, w, tail)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, w, tail)):
        return _CausalConv.apply(x, w, tail)
    return _forward(x, w, tail)


class _CausalConv(torch.autograd.Function):
    """The conv with :func:`causal_conv_bwd` as its backward; x, w and the
    tail are saved for it (under remat the recomputed forward saves them
    again)."""

    @staticmethod
    def forward(ctx, x, w, tail):
        ctx.save_for_backward(x, w, tail)
        return _forward(x, w, tail)

    @staticmethod
    def backward(ctx, dout, dnew_tail):
        x, w, tail = ctx.saved_tensors
        return causal_conv_bwd(x, w, tail, dout, dnew_tail)


def _forward(x, w, tail):
    """The forward alone: the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    b, s, c, cw = _check("causal_conv", x, w, tail)
    if x.device.type == "cpu":
        return ref.causal_conv_ref(x, w, tail)
    _check_cuda("causal_conv", x, w, tail)
    out = torch.empty_like(x)
    new_tail = torch.empty_like(tail)
    if b == 0 or s == 0:
        return out, new_tail.copy_(tail)
    run = run_length(b, s, c)
    grid = (b, -(-s // run), -(-c // BLOCK_C))
    _kernels()[0][grid](x, w, tail, out, new_tail, s, c, run, CW=cw,
                        TAIL_ROWS=max(2, 1 << (cw - 2).bit_length()),
                        BLOCK_C=BLOCK_C, num_warps=1)
    causal_conv.launches += 1
    return out, new_tail


causal_conv.launches = 0


def causal_conv_bwd(x: torch.Tensor, w: torch.Tensor, tail: torch.Tensor,
                    dout: torch.Tensor,
                    dnew_tail: torch.Tensor | None = None) -> tuple:
    """The gradient of :func:`causal_conv` for the cotangents dout (b, s,
    c) of the output and dnew_tail (b, cw - 1, c) of the new tail (None:
    zeros): (dx, dw, dtail) in the input dtype.  On CUDA tensors one call
    runs the backward kernel over the forward's grid (dx, dtail and
    per-program partials of dw, no atomics) and the reduction of the
    partials in program order, counted once; on CPU tensors it is
    ``ref.causal_conv_bwd_ref`` (the reference's rounding order)."""
    b, s, c, cw = _check("causal_conv_bwd", x, w, tail)
    if dout.shape != x.shape or (dnew_tail is not None and
                                 dnew_tail.shape != tail.shape):
        raise ValueError(f"causal_conv_bwd: dout {tuple(dout.shape)}, "
                         f"dnew_tail "
                         f"{None if dnew_tail is None else tuple(dnew_tail.shape)}")
    if x.device.type == "cpu":
        return ref.causal_conv_bwd_ref(x, w, tail, dout, dnew_tail)
    # autograd's cotangents may arrive in another layout or dtype
    dout = dout.to(x.dtype).contiguous()
    dnt = None if dnew_tail is None else dnew_tail.to(x.dtype).contiguous()
    _check_cuda("causal_conv_bwd", x, w, tail, dout,
                *([] if dnt is None else [dnt]))
    dx = torch.empty_like(x)
    dtail = torch.empty_like(tail)
    dw = torch.empty_like(w)
    if b == 0 or s == 0:
        dtail.copy_(torch.zeros_like(tail) if dnt is None else dnt)
        return dx, dw.zero_(), dtail
    run = run_length(b, s, c)
    runs = -(-s // run)
    strips = -(-c // BLOCK_C)
    parts = torch.empty((b * runs * 4, c), dtype=torch.float32,
                        device=x.device)
    _, bwd, dw_sum = _kernels()
    bwd[(b, runs, strips)](x, w, tail, dout, x if dnt is None else dnt, dx,
                           dtail, parts, s, c, run, runs, CW=cw,
                           HAS_DNT=dnt is not None, BLOCK_C=BLOCK_C,
                           num_warps=1)
    dw_sum[(-(-c // DW_BLOCK), cw)](parts, dw, b * runs, c, CW=cw,
                                    BLOCK=DW_BLOCK, num_warps=1)
    causal_conv_bwd.launches += 1
    return dx, dw, dtail


causal_conv_bwd.launches = 0

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

Training differentiates it: under grad the wrapper goes through
:class:`_SSDChunkScan`, whose backward :func:`ssd_chunk_scan_bwd` runs
the eight kernels of ``csrc/ssd_scan_bwd.cu`` on the card (the reverse
state pass over the chunks; each chunk's per-head gradients against the
states the forward kept, with the cotangent of C·Bᵀ summed over the heads
in groups; dB and dC as products of it and of the carried terms over H·P)
and the autograd of the plain version on the CPU.
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
GRID_AIM, MAX_GROUPS = 264, 16     # the backward's head groups (bwd_plan)


@functools.cache
def _fn():
    fn = build.library("ssd_scan").ssd_chunk_scan
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 12 +
                   [ctypes.c_int] * 4 + [ctypes.c_longlong] * 4 +
                   [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fn():
    """(the backward's entry, its workspace size in floats)."""
    lib = build.library("ssd_scan_bwd")
    ws = lib.ssd_chunk_scan_bwd_workspace
    ws.argtypes = [ctypes.c_int] * 6
    ws.restype = ctypes.c_longlong
    fn = lib.ssd_chunk_scan_bwd
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 19 +
                   [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4 +
                   [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, ws


def bwd_plan(b: int, s: int, H: int, L: int) -> tuple:
    """(heads a group takes, groups) of the backward's chunk kernel, which
    takes the first from here: enough groups that its blocks (one per
    64-row tile of every chunk and sequence, times the groups) reach
    ``GRID_AIM``, at most ``MAX_GROUPS``.  The cotangent of C·Bᵀ sums
    each group's heads in index order, then the groups in order (so does
    ``chip_smoke.ssd_bwd_plain``)."""
    tpc, rem = -(-L // TILE), s % L
    cols = b * ((s // L) * tpc + (-(-rem // TILE) if rem else 0))
    want = min(MAX_GROUPS, max(1, -(-GRID_AIM // cols)))
    hpg = -(-H // want)
    return hpg, -(-H // hpg)


def _check_shapes(kernel, x, B, C, dt, A, D, h0, chunk, out_state=None):
    b, s, H, P = x.shape
    N = B.shape[-1]
    if B.shape != (b, s, N) or C.shape != (b, s, N) or \
            dt.shape != (b, s, H) or A.shape != (H,) or D.shape != (H,) \
            or (h0 is not None and h0.shape != (b, H, P, N)) or \
            (out_state is not None and out_state.shape != (b, H, P, N)) \
            or chunk < 1:
        raise ValueError(f"{kernel}: shapes x {tuple(x.shape)} B "
                         f"{tuple(B.shape)} C {tuple(C.shape)} dt "
                         f"{tuple(dt.shape)} A {tuple(A.shape)} D "
                         f"{tuple(D.shape)} h0 "
                         f"{None if h0 is None else tuple(h0.shape)} chunk "
                         f"{chunk}")
    return b, s, H, P, N


def _check_cuda(kernel, x, B, C, dt, A, D, states, chunk):
    """The card's requirements on the forward's inputs (the backward's
    too): one device, dtypes, the built widths, strides, alignment."""
    b, s, H, P = x.shape
    N = B.shape[-1]
    build.require_cuda(kernel, x, B, C, dt, A, D, *states)
    if x.dtype not in build.ATTN_DTYPES or B.dtype != x.dtype or \
            C.dtype != x.dtype or dt.dtype != torch.float32 or \
            any(t.dtype != torch.float32 for t in states):
        raise ValueError(f"{kernel}: dtypes x {x.dtype} B {B.dtype} "
                         f"C {C.dtype} dt {dt.dtype} states "
                         f"{[t.dtype for t in states]}; need x, B, C all "
                         f"float32 or bfloat16, f32 dt and states")
    if P != HEAD_DIM or N not in STATES or chunk > MAX_CHUNK:
        raise ValueError(f"{kernel}: built for P {HEAD_DIM}, N in "
                         f"{STATES} and chunks up to {MAX_CHUNK}, got "
                         f"{(P, N)}, chunk {chunk}")
    if x.stride()[2:] != (P, 1) or B.stride(2) != 1 or C.stride(2) != 1 \
            or B.stride()[:2] != C.stride()[:2] or not dt.is_contiguous() \
            or not all(t.is_contiguous() for t in states):
        raise ValueError(f"{kernel}: x's (H, P) contiguous, B and C "
                         f"rows contiguous with one stride, dt and the "
                         f"states contiguous")
    # x, B and C are read four elements at a time (16 bytes of f32, 8 of
    # bf16)
    build.require_aligned(
        kernel, {"x": x.data_ptr(), "B": B.data_ptr(), "C": C.data_ptr()},
        {"x": x.stride()[:2], "B": B.stride()[:2]}, x.element_size(),
        align=4 * x.element_size())


def ssd_chunk_scan(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                   dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                   h0: Optional[torch.Tensor], chunk: int,
                   out_state: Optional[torch.Tensor] = None):
    """x (b,s,H,P); B, C (b,s,N); dt (b,s,H) f32; A, D (H,); h0
    (b,H,P,N) f32 or None.  Returns (y (b,s,H,P) f32, h_final).  Under
    grad (grad mode on, an input requiring grad) it goes through
    :class:`_SSDChunkScan`, whose backward is :func:`ssd_chunk_scan_bwd`;
    ``out_state`` is then refused (training writes no state in place)."""
    _check_shapes("ssd_chunk_scan", x, B, C, dt, A, D, h0, chunk, out_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, B, C, dt, A, D, h0)):
        if out_state is not None:
            raise ValueError("ssd_chunk_scan: out_state writes the state in "
                             "place, which autograd cannot differentiate; "
                             "run it without grad")
        return _SSDChunkScan.apply(x, B, C, dt, A, D, h0, chunk)
    y, h, _ = _forward(x, B, C, dt, A, D, h0, chunk, out_state)
    return y, h


class _SSDChunkScan(torch.autograd.Function):
    """The SSD scan with :func:`ssd_chunk_scan_bwd` as its backward; the
    inputs and, on the card, the forward's scratch (C·Bᵀ, the cumulative
    sums, the states entering the chunks: ~19 MB for mamba2-1.3b's
    training microbatch of 2 × 1023 rows) are saved for it (under remat
    the recomputed forward saves them again, so only the layer being
    differentiated holds them)."""

    @staticmethod
    def forward(ctx, x, B, C, dt, A, D, h0, chunk):
        y, h, saved = _forward(x, B, C, dt, A, D, h0, chunk)
        ctx.chunk, ctx.has_h0 = chunk, h0 is not None
        ctx.save_for_backward(x, B, C, dt, A, D,
                              *([h0] if h0 is not None else []),
                              *(saved or ()))
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, B, C, dt, A, D, *rest = ctx.saved_tensors
        h0 = rest.pop(0) if ctx.has_h0 else None
        grads = ssd_chunk_scan_bwd(x, B, C, dt, A, D, h0, ctx.chunk, dy, dh,
                                   saved=tuple(rest) or None)
        return (*grads, None)


def _forward(x, B, C, dt, A, D, h0, chunk, out_state=None):
    """The forward alone: (y, h_final, the scratch (cb, cs, the states
    entering the chunks) or None) -- the kernels on CUDA tensors, the
    plain version on CPU tensors."""
    b, s, H, P = x.shape
    N = B.shape[-1]
    if x.device.type == "cpu":
        y, h = ref.ssd_chunk_scan_ref(x, B, C, dt, A, D, h0, chunk)
        return y, (h if out_state is None else out_state.copy_(h)), None
    states = [t for t in (h0, out_state) if t is not None]
    _check_cuda("ssd_chunk_scan", x, B, C, dt, A, D, states, chunk)
    y = torch.empty((b, s, H, P), dtype=torch.float32, device=x.device)
    h_out = out_state if out_state is not None else torch.empty(
        (b, H, P, N), dtype=torch.float32, device=x.device)
    if b == 0:
        return y, h_out, None
    if s == 0:
        return y, (h_out.zero_() if h0 is None else h_out.copy_(h0)), None
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
    return y, h_out, (cb, cs, chunk_states)


ssd_chunk_scan.launches = 0


def ssd_chunk_scan_bwd(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                       dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                       h0: Optional[torch.Tensor], chunk: int,
                       dy: torch.Tensor, dh: Optional[torch.Tensor] = None,
                       saved: Optional[tuple] = None) -> tuple:
    """The gradient of :func:`ssd_chunk_scan` for the cotangents dy (b, s,
    H, P) of y and dh (b, H, P, N) of the final state (None: zeros): (dx,
    dB, dC, ddt, dA, dD, dh0), each in its input's dtype (dA and dh0 f32,
    dD accumulated in f32 and rounded once to D's dtype), dh0 None when
    h0 is.  On CUDA tensors ``saved`` is the forward's scratch (cb, cs,
    the states entering the chunks) as :class:`_SSDChunkScan` keeps it
    (:func:`_check_saved` refuses one that does not fit), and one call
    runs the eight kernels of ``csrc/ssd_scan_bwd.cu``, counted once; on
    CPU tensors it is ``ref.ssd_chunk_scan_bwd_ref``."""
    b, s, H, P, N = _check_shapes("ssd_chunk_scan_bwd", x, B, C, dt, A, D,
                                  h0, chunk)
    if dy.shape != (b, s, H, P) or (dh is not None and
                                    dh.shape != (b, H, P, N)):
        raise ValueError(f"ssd_chunk_scan_bwd: dy {tuple(dy.shape)}, dh "
                         f"{None if dh is None else tuple(dh.shape)}")
    if x.device.type == "cpu":
        return ref.ssd_chunk_scan_bwd_ref(x, B, C, dt, A, D, h0, chunk, dy,
                                          dh)
    # autograd's cotangents may arrive in another layout
    dy = dy.float().contiguous()
    dh = None if dh is None else dh.float().contiguous()
    states = [t for t in (h0, dh) if t is not None]
    _check_cuda("ssd_chunk_scan_bwd", x, B, C, dt, A, D, states + [dy],
                chunk)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((b, s, H, P), dtype=x.dtype, device=dev)
    dB = torch.empty((b, s, N), dtype=B.dtype, device=dev)
    dC = torch.empty((b, s, N), dtype=C.dtype, device=dev)
    ddt, dA, dD = torch.empty((b, s, H), **f32), torch.empty(H, **f32), \
        torch.empty(H, **f32)
    dh0 = None if h0 is None else torch.empty((b, H, P, N), **f32)
    if b == 0 or s == 0:
        for t in (dx, dB, dC, ddt, dA, dD):
            t.zero_()
        if dh0 is not None:
            dh0.copy_(torch.zeros_like(dh0) if dh is None else dh)
        return dx, dB, dC, ddt, dA.to(A.dtype), dD.to(D.dtype), dh0
    L = min(chunk, s)
    cb, cs, chunk_states = _check_saved(saved, x, b, s, H, P, N, L)
    # the kernels copy x's, B's and C's rows 16 bytes at a time
    build.require_aligned(
        "ssd_chunk_scan_bwd",
        {"x": x.data_ptr(), "B": B.data_ptr(), "C": C.data_ptr()},
        {"x": x.stride()[:2], "B": B.stride()[:2]}, x.element_size())
    fn, workspace = _bwd_fn()
    hpg = bwd_plan(b, s, H, L)[0]
    # the cotangents of the chunk states, dcs's partials, the partials of
    # dA and dD, the cotangent of C·Bᵀ (the groups' partials and their
    # sum), dB's and dC's f32 sums per share of the heads: 49.9 MB at
    # mamba2-1.3b's microbatch
    work = torch.empty(workspace(N, b, s, H, L, hpg), **f32)
    Af, Df = A.float().contiguous(), D.float().contiguous()
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = fn(build.ATTN_DTYPES[x.dtype], N, x.data_ptr(), B.data_ptr(),
            C.data_ptr(), dt.data_ptr(), Af.data_ptr(), Df.data_ptr(),
            dy.data_ptr(), ptr(dh), cb.data_ptr(), cs.data_ptr(),
            chunk_states.data_ptr(), dx.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dD.data_ptr(),
            ptr(dh0), work.data_ptr(), b, s, H, L, hpg, x.stride(0),
            x.stride(1), B.stride(0), B.stride(1), build.stream_of(x))
    build.check(rc, "ssd_chunk_scan_bwd")
    ssd_chunk_scan_bwd.launches += 1
    return dx, dB, dC, ddt, dA.to(A.dtype), dD.to(D.dtype), dh0


def _check_saved(saved, x, b, s, H, P, N, L) -> tuple:
    """The forward's scratch as the backward reads it: (cb (b, nc, lt,
    lt), cs (b, nc, H, lt), the states entering the chunks (b, nc, H, P,
    N)), f32, contiguous, on x's device, for this call's chunk length L
    (nc chunks, lt = L rounded up to whole tiles); anything else raises
    rather than being read out of bounds."""
    nc, lt = -(-s // L), -(-L // TILE) * TILE
    want = ((b, nc, lt, lt), (b, nc, H, lt), (b, nc, H, P, N))
    if saved is None or len(saved) != 3 or any(
            tuple(t.shape) != w or t.dtype != torch.float32 or
            t.device != x.device or not t.is_contiguous()
            for t, w in zip(saved, want)):
        got = None if saved is None else [
            (tuple(t.shape), t.dtype, str(t.device), t.is_contiguous())
            for t in saved]
        raise ValueError(f"ssd_chunk_scan_bwd: the forward's scratch "
                         f"(saved) must be contiguous f32 on {x.device} of "
                         f"shapes {want} for chunks of {L}; got {got}")
    return saved


ssd_chunk_scan_bwd.launches = 0

"""Grouped GEMM — the MoE experts' matmuls.

``y[r] = x[r] @ w[e(r)]``: x (M, K) holds the routed token copies sorted
by expert, ``group_sizes`` (E,) int32 says how many rows each expert
owns, in order, and w (E, K, N) holds the experts' weights; y (M, N) is
in x's dtype, accumulated in f32; rows past the groups are 0.  The
counterpart of ``jax.lax.ragged_dot`` in the reference's ``moe_ragged``
(``repro/models/moe.py:64-67``).  On CUDA tensors this launches
``csrc/grouped_gemm.cu`` (bf16 on the tensor cores, f32 scalar); the
group sizes stay on the device, so a call makes no host sync.  bf16 runs
in one of two regimes, chosen from the shapes alone (:func:`regime`):
``append`` (TMA + ``wgmma`` on 128-row tiles) for many rows per expert,
``decode`` (the experts' columns on the MMA's M side, up to 8 token rows
on its N side) for few.  Both walk the same tile list, which every block
derives on the device from the group sizes; :func:`tile_walk` is its
plain-Python copy.  On CPU tensors it computes the plain version, one
matmul per group.

Training: when grad mode is on and x or w requires grad, the call goes
through an autograd Function (:class:`_GroupedGemm`) whose forward is the
same launch and whose backward is :func:`grouped_gemm_bwd`
(``csrc/grouped_gemm_bwd.cu`` on CUDA tensors, ``ref.grouped_gemm_bwd_ref``
on CPU tensors), asked only for the gradients autograd needs.  The
reference has no backward kernel: XLA transposes ``jax.lax.ragged_dot``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref


# the bf16 regimes (the kernel's codes) and the cut-off between them
REGIMES = {"append": 0, "decode": 1}
DECODE_ROWS_PER_GROUP = 8
MAX_GROUPS = 512                  # the kernels' walk table


def regime(m: int, e: int, k: int, n: int) -> str:
    """The bf16 regime of an (M, K) x (E, K, N) call, from its shapes
    only: ``decode`` when there are at most ``DECODE_ROWS_PER_GROUP``
    rows per expert on average (ds27b's 8-slot decode, M = 48 over 72
    experts), where 128-row tiles would multiply mostly padding and the
    time is the used experts' weight bytes; else ``append``.  K and N do
    not move the cut: both regimes take any K and N that are multiples
    of 8."""
    return "decode" if m <= DECODE_ROWS_PER_GROUP * e else "append"


def tile_walk(group_sizes, m: int, bm: int, n_ct: int) -> list:
    """The kernels' tile list (``walk_init`` and ``walk_tile`` in
    ``csrc/grouped_gemm.cu``), in plain Python: tile t is (group e, first
    row, rows, column tile), e = -1 for rows past the groups (written 0).
    Each group's rows (sizes clamped to [0, rows left]) are cut into row
    tiles of ``bm`` (128 in the append regime, 8 in the decode regime, 64
    in f32), the rows past the groups likewise, and each row tile into
    ``n_ct`` column tiles, column tile fastest."""
    rt, off = [0], [0]
    for size in group_sizes:
        rows = min(max(int(size), 0), m - off[-1])
        off.append(off[-1] + rows)
        rt.append(rt[-1] + -(-rows // bm))
    n_rt = rt[-1] + -(-(m - off[-1]) // bm)
    tiles = []
    for t in range(n_rt * n_ct):
        r, ct = divmod(t, n_ct)
        if r >= rt[-1]:
            r0 = off[-1] + (r - rt[-1]) * bm
            tiles.append((-1, r0, min(bm, m - r0), ct))
            continue
        e = max(i for i in range(len(group_sizes)) if rt[i] <= r)
        r0 = off[e] + (r - rt[e]) * bm
        tiles.append((e, r0, min(bm, off[e + 1] - r0), ct))
    return tiles


# the bf16 backward's tiles (csrc/grouped_gemm_bwd.cu): BWD_BM rows by
# BWD_BN columns, reductions in slices of BWD_BK
BWD_BM, BWD_BN, BWD_BK = 128, 256, 64


def bwd_work(group_sizes, m: int, k: int, n: int, need_dx: bool = True,
             need_dw: bool = True) -> list:
    """The bf16 backward's work list (``item_at`` in
    ``csrc/grouped_gemm_bwd.cu``), in plain Python: first dW's units, one
    per (expert, 128 rows of K, 256 columns of N), each ``("dw", e, first
    K row, first column, slices)``; then dX's tiles, the forward's walk
    (:func:`tile_walk`) over dY's rows in 128-row tiles and dx's columns
    in 256-column tiles, each ``("dx", e, first row, rows, first column,
    reduction slices)`` (e = -1: rows past the groups, written 0, no
    slices).  A unit's slices walk group e's rows in order, 64 at a
    time, each ``(first row, rows taken, rows masked)``: the box the
    kernel loads holds 64 rows from the first, cut only at M, so the
    rows past the group's end and below M are the next groups' and are
    zeroed before the products."""
    items = []
    if need_dw:
        off = [0]
        for size in group_sizes:
            off.append(off[-1] + min(max(int(size), 0), m - off[-1]))
        for e in range(len(group_sizes)):
            rows = off[e + 1] - off[e]
            slices = []
            for s in range(0, rows, BWD_BK):
                taken = min(BWD_BK, rows - s)
                first = off[e] + s
                slices.append((first, taken,
                               min(first + BWD_BK, m) - first - taken))
            for k0 in range(0, k, BWD_BM):
                for n0 in range(0, n, BWD_BN):
                    items.append(("dw", e, k0, n0, slices))
    if need_dx and m > 0:
        for e, r0, rows, ct in tile_walk(group_sizes, m, BWD_BM,
                                         -(-k // BWD_BN)):
            items.append(("dx", e, r0, rows, ct * BWD_BN,
                          -(-n // BWD_BK) if e >= 0 else 0))
    return items


def bwd_grid(m: int, e: int, k: int, n: int, n_sm: int, need_dx: bool = True,
             need_dw: bool = True) -> int:
    """The bf16 backward's persistent grid, as the host sizes it from the
    shapes alone: the dX tiles the walk can hold at most (the forward's
    bound, ⌈M / 128⌉ + E + 1 row tiles) plus dW's units, at most one block
    an SM; 0 when there is nothing to do.  Block b takes items b, b +
    grid, ... of :func:`bwd_work`."""
    slots = 0
    if need_dx and m > 0:
        slots += (-(-m // BWD_BM) + e + 1) * -(-k // BWD_BN)
    if need_dw:
        slots += e * -(-k // BWD_BM) * -(-n // BWD_BN)
    return min(slots, n_sm)


@functools.cache
def _fn():
    fn = build.library("grouped_gemm").grouped_gemm
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 +
                   [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fn():
    fn = build.library("grouped_gemm_bwd").grouped_gemm_bwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 +
                   [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_shapes(kernel, x, w, group_sizes):
    m, k = x.shape
    e, k_w, n = w.shape
    if k_w != k or group_sizes.shape != (e,):
        raise ValueError(f"{kernel}: shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)} group_sizes "
                         f"{tuple(group_sizes.shape)}")
    return m, k, e, n


def _check_cuda(kernel, x, w, group_sizes, *more):
    """The kernels' contract on CUDA tensors: one device, float32 or
    bfloat16 throughout, int32 sizes, contiguous, at most ``MAX_GROUPS``
    groups; bf16 needs K and N multiples of 8 and 16-byte aligned
    pointers."""
    build.require_cuda(kernel, x, w, group_sizes, *more)
    if x.dtype not in build.ATTN_DTYPES or any(
            t.dtype != x.dtype for t in (w, *more)) \
            or group_sizes.dtype != torch.int32:
        raise ValueError(f"{kernel}: dtypes "
                         f"{[t.dtype for t in (x, w, *more)]} "
                         f"{group_sizes.dtype}; need all float32 or all "
                         f"bfloat16, and int32 sizes")
    if not all(t.is_contiguous() for t in (x, w, group_sizes, *more)):
        raise ValueError(f"{kernel}: x, w and group_sizes must be "
                         f"contiguous")
    e, k, n = w.shape
    if e > MAX_GROUPS:
        raise ValueError(f"{kernel}: at most {MAX_GROUPS} groups, got {e}")
    if x.dtype == torch.bfloat16 and (k % 8 or n % 8):
        raise ValueError(f"{kernel}: bf16 needs K and N multiples of 8, "
                         f"got {k}, {n}")


def grouped_gemm(x: torch.Tensor, w: torch.Tensor,
                 group_sizes: torch.Tensor) -> torch.Tensor:
    """x (M, K); w (E, K, N); group_sizes (E,) int32 -> y (M, N),
    differentiable in x and w (see the module's docstring)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _GroupedGemm.apply(x, w, group_sizes)
    return _forward(x, w, group_sizes)


class _GroupedGemm(torch.autograd.Function):
    """The grouped GEMM with :func:`grouped_gemm_bwd` as its backward;
    x, w and the sizes are saved for it (under remat the recomputed
    forward saves them again)."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        return _forward(x, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        dx, dw = grouped_gemm_bwd(x, w, group_sizes, dy,
                                  need_dx=ctx.needs_input_grad[0],
                                  need_dw=ctx.needs_input_grad[1])
        return dx, dw, None


def _forward(x, w, group_sizes):
    """The forward alone: the kernel on CUDA tensors, the plain version
    on CPU tensors."""
    m, k, e, n = _check_shapes("grouped_gemm", x, w, group_sizes)
    if x.device.type == "cpu":
        return ref.grouped_gemm_ref(x, w, group_sizes)
    _check_cuda("grouped_gemm", x, w, group_sizes)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    mode = regime(m, e, k, n)
    if x.dtype == torch.bfloat16:
        build.require_aligned(
            "grouped_gemm", {"x": x.data_ptr(), "w": w.data_ptr(),
                             "y": y.data_ptr()}, {}, x.element_size())
    rc = _fn()(build.ATTN_DTYPES[x.dtype], REGIMES[mode], x.data_ptr(),
               w.data_ptr(), y.data_ptr(), group_sizes.data_ptr(), e, m, k,
               n, build.sm_count(x.get_device()), build.stream_of(x))
    build.check(rc, "grouped_gemm")
    grouped_gemm.launches += 1
    return y


grouped_gemm.launches = 0


def grouped_gemm_bwd(x: torch.Tensor, w: torch.Tensor,
                     group_sizes: torch.Tensor, dy: torch.Tensor, *,
                     need_dx: bool = True, need_dw: bool = True) -> tuple:
    """The gradient of :func:`grouped_gemm` for the cotangent dy (M, N):
    (dx (M, K) in x's dtype, rows past the groups 0; dw (E, K, N) in w's
    dtype, 0 for an empty group), None for a gradient not asked for.  On
    CUDA tensors one call runs ``csrc/grouped_gemm_bwd.cu`` (bf16: one
    persistent launch over :func:`bwd_work`; f32: a dX and a dW kernel,
    either alone when only one is asked for), counted once; on CPU
    tensors it is ``ref.grouped_gemm_bwd_ref``."""
    m, k, e, n = _check_shapes("grouped_gemm_bwd", x, w, group_sizes)
    if dy.shape != (m, n):
        raise ValueError(f"grouped_gemm_bwd: dy {tuple(dy.shape)}, need "
                         f"{(m, n)}")
    if 0 in (k, n, e) or not (need_dx or need_dw):
        return (torch.zeros_like(x) if need_dx else None,
                torch.zeros_like(w) if need_dw else None)
    if x.device.type == "cpu":
        return ref.grouped_gemm_bwd_ref(x, w, group_sizes, dy, need_dx,
                                        need_dw)
    # autograd's cotangent may arrive in another layout or dtype
    dy = dy.to(x.dtype).contiguous()
    _check_cuda("grouped_gemm_bwd", x, w, group_sizes, dy)
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty_like(w) if need_dw else None
    if x.dtype == torch.bfloat16:
        build.require_aligned(
            "grouped_gemm_bwd",
            {nm: t.data_ptr() for nm, t in (("x", x), ("w", w), ("dy", dy),
                                            ("dx", dx), ("dw", dw))
             if t is not None}, {}, x.element_size())
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _bwd_fn()(build.ATTN_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(),
                   dy.data_ptr(), ptr(dx), ptr(dw), group_sizes.data_ptr(),
                   e, m, k, n, build.stream_of(x))
    build.check(rc, "grouped_gemm_bwd")
    grouped_gemm_bwd.launches += 1
    return dx, dw


grouped_gemm_bwd.launches = 0

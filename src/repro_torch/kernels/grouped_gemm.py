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


@functools.cache
def _fn():
    fn = build.library("grouped_gemm").grouped_gemm
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 +
                   [ctypes.c_int] * 5 + [ctypes.c_void_p])
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
    build.require_no_grad("grouped_gemm", build.MOE_TRAINING, x, w)
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
    if e > MAX_GROUPS:
        raise ValueError(f"grouped_gemm: at most {MAX_GROUPS} groups, got "
                         f"{e}")
    mode = regime(m, e, k, n)
    if x.dtype == torch.bfloat16:
        if k % 8 or n % 8:
            raise ValueError(f"grouped_gemm: bf16 needs K and N multiples "
                             f"of 8, got {k}, {n}")
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

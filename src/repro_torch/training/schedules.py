"""LR schedules, including MiniCPM's WSD (warmup-stable-decay): a copy of
``repro.training.schedules`` (pure Python)."""
from __future__ import annotations

import math


def wsd(step: int, *, peak_lr: float, warmup: int, stable: int,
        decay: int, final_frac: float = 0.1) -> float:
    """Warmup-Stable-Decay (arXiv:2404.06395 §4): linear warmup, long
    constant stage, short exponential-ish decay to final_frac·peak."""
    if step < warmup:
        return peak_lr * (step + 1) / warmup
    if step < warmup + stable:
        return peak_lr
    d = min(step - warmup - stable, decay)
    return peak_lr * final_frac ** (d / max(decay, 1))


def cosine(step: int, *, peak_lr: float, warmup: int, total: int,
           final_frac: float = 0.1) -> float:
    if step < warmup:
        return peak_lr * (step + 1) / warmup
    t = min((step - warmup) / max(total - warmup, 1), 1.0)
    return peak_lr * (final_frac + (1 - final_frac) *
                      0.5 * (1 + math.cos(math.pi * t)))

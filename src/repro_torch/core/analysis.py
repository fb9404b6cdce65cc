"""Bottleneck-free traffic analysis (port of ``repro.core.analysis``,
paper §4.2, Eq. 1–9).

Closed-form per-link traffic of the dual-path loading scheme, used
(a) to validate deployments (is this P/D ratio safe?), (b) by the
elastic re-configuration logic to pick a new P/D split after node
failures, and (c) as the ground truth the discrete-event simulator is
property-tested against (simulated steady-state link utilisation must
match these expressions).

Notation mirrors the paper: P/D prefill/decode node counts, g engines
(accelerators) per node, each engine paired with a compute NIC of
bandwidth B; storage NIC bandwidth per node is s·B (shared); M is the
DRAM bandwidth per node.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class ClusterSpec:
    g: int = 8             # engines per node
    B: float = 50e9        # compute-NIC bandwidth per engine [bytes/s]
    s: float = 1.0         # storage NIC bandwidth, in units of B, per node
    M: float = 500e9       # DRAM bandwidth per node [bytes/s]

    @property
    def snic_bw(self) -> float:
        return self.s * self.B


def pair_traffic(P: int, D: int, spec: ClusterSpec) -> Tuple[float, float]:
    """(T_p, T_c): per-(PE,DE)-pair traffic of the PE-read and DE-read
    paths when all storage NICs are saturated and load is balanced."""
    g, B, s = spec.g, spec.B, spec.s
    T_p = B * s / (D * g * g)
    T_c = B * s / (P * g * g)
    return T_p, T_c


def link_utilisation(P: int, D: int, spec: ClusterSpec) -> Dict[str, float]:
    """Utilisation fraction (traffic / capacity) of every constrained
    resource, Eq. 1–8.  Values ≤ 1.0 mean bottleneck-free."""
    g, B, s, M = spec.g, spec.B, spec.s, spec.M
    T_p, T_c = pair_traffic(P, D, spec)
    util = {
        # Eq.1: PE CNIC read — PE paths (3) and (5)
        "pe_cnic_read": 2 * T_p * D * g / B,
        # Eq.2: PE CNIC write — PE path (4) + DE path (5)
        "pe_cnic_write": (T_p + T_c) * D * g / B,
        # Eq.4: DE CNIC read — PE path (8) + DE paths (3)/(6)
        "de_cnic_read": (T_p + 2 * T_c) * P * g / B,
        # Eq.6: DE CNIC write — PE paths (7)/(9) + DE path (7)
        "de_cnic_write": (2 * T_p + T_c) * P * g / B,
        # DRAM, half-duplex: sum of read+write pressure
        "pe_dram": 2 * s * B / M,
        "de_dram": (3 + 2 * P / D) * B * s / M,
    }
    return util


def link_utilisation_mix(P: int, D: int, spec: ClusterSpec,
                         phi: Optional[float] = None) -> Dict[str, float]:
    """Eq. 1–8 generalised to an arbitrary *read mix* φ — the fraction
    of hit bytes entering via PE-side storage NICs (split reads make φ
    a continuous knob instead of the per-request binary 'pe'|'de').

    Aggregate load bandwidth is L(φ) = min(P·sB/φ, D·sB/(1−φ)), i.e.
    whichever side's storage NICs saturate first; the maximiser
    φ* = P/(P+D) saturates both sides simultaneously and recovers the
    paper's L = (P+D)·sB.  Per-(PE,DE)-pair traffic follows as
    T_p(φ) = φ·L/(P·D·g²) and T_c(φ) = (1−φ)·L/(P·D·g²), and every
    Eq. 1–8 expression keeps its coefficient structure — at φ=φ* this
    function is exactly ``link_utilisation`` (property-tested).

    DRAM terms, derived from the plan legs (core/loading.py):
    per PE node 2·φL/P (storage-in + buf→HBM read); per DE node
    L(3−φ)/D (storage-in and stream-out of the DE share, write-in of
    the PE share, and the full de_buf→de_hbm pass every byte makes).
    """
    g, B, s, M = spec.g, spec.B, spec.s, spec.M
    if phi is None:
        phi = P / (P + D)
    if not 0.0 <= phi <= 1.0:
        raise ValueError(f"read mix phi must be in [0, 1], got {phi}")
    sides = []
    if phi > 0:
        sides.append(P * s * B / phi)
    if phi < 1:
        sides.append(D * s * B / (1 - phi))
    L = min(sides)
    T_p = phi * L / (P * D * g * g)
    T_c = (1 - phi) * L / (P * D * g * g)
    util = {
        "pe_cnic_read": 2 * T_p * D * g / B,
        "pe_cnic_write": (T_p + T_c) * D * g / B,
        "de_cnic_read": (T_p + 2 * T_c) * P * g / B,
        "de_cnic_write": (2 * T_p + T_c) * P * g / B,
        "pe_dram": 2 * phi * L / P / M,
        "de_dram": (3 - phi) * L / D / M,
    }
    return util


def bottleneck_free_range(spec: ClusterSpec) -> Tuple[float, float]:
    """Eq. 9: s/(g−s) ≤ P/D ≤ min{(g−2s)/s, (g−s)/2s, (M/Bs−3)/2}."""
    g, s = spec.g, spec.s
    lo = s / (g - s)
    hi = min((g - 2 * s) / s,
             (g - s) / (2 * s),
             (spec.M / (spec.B * spec.s) - 3) / 2)
    return lo, hi


def is_bottleneck_free(P: int, D: int, spec: ClusterSpec,
                       tol: float = 1e-9) -> Tuple[bool, str]:
    """Check a deployment; returns (ok, binding-constraint-name)."""
    util = link_utilisation(P, D, spec)
    worst = max(util, key=util.get)
    return util[worst] <= 1.0 + tol, worst


def max_aggregate_load_bw(P: int, D: int, spec: ClusterSpec,
                          dualpath: bool = True) -> float:
    """Aggregate KV-load bandwidth available to prefill.

    Basic systems read only via PE-side storage NICs; DualPath pools all
    nodes' storage NICs (§7.3's 'equivalent available storage bandwidth'
    observation: Basic 2P1D == DualPath 1P1D == 2 SNICs etc.)."""
    nodes = P if not dualpath else P + D
    return nodes * spec.snic_bw


def safe_pd_splits(n_nodes: int, spec: ClusterSpec):
    """All (P, D) integer splits of n_nodes inside the bottleneck-free
    range — the candidate set for elastic re-configuration after a node
    failure."""
    lo, hi = bottleneck_free_range(spec)
    out = []
    for P in range(1, n_nodes):
        D = n_nodes - P
        r = P / D
        if lo - 1e-12 <= r <= hi + 1e-12:
            out.append((P, D))
    return out

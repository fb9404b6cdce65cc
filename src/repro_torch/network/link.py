"""The fluid two-class drain of one compute-network link (port of
``repro.network.link``'s closed-form part).

Two traffic classes, KV transfers and model collectives, start together
on one work-conserving link.  While both are backlogged they get fixed
shares; when one empties the other takes the whole link.  So the later
finisher always ends at ``kv_s + coll_s``, and arbitration decides only
who finishes *first*: whether model execution stalls on its collectives
(FIFO sharing) or the KV backlog absorbs the delay (the paper's
weighted-VL arbiter).
"""
from __future__ import annotations

from repro_torch.core.traffic import DEFAULT_ARBITER, VLArbiterConfig


def kv_share_when_contended(arbiter: str,
                            arb: VLArbiterConfig = DEFAULT_ARBITER) -> float:
    """Share of link bandwidth KV traffic gets while collectives are
    backlogged: the low-priority leak under the VL arbiter (1 −
    ``high_fraction()`` = 0.0059 with the §A.1 tables), an equal split
    under FIFO sharing."""
    if arbiter == "fifo":
        return 0.5
    return 1.0 - arb.high_fraction()


def drain_times(kv_s: float, coll_s: float, kv_share: float) -> tuple:
    """Completion times ``(kv_done, coll_done)`` of the two classes.

    ``kv_s`` / ``coll_s`` are each class's service time alone at full
    bandwidth (bytes over the link's rate); ``kv_share`` is KV's share
    while both are backlogged, clamped to [0, 1]."""
    kv_s = max(kv_s, 0.0)
    coll_s = max(coll_s, 0.0)
    if kv_s <= 0.0 or coll_s <= 0.0:
        return kv_s, coll_s
    kv_share = min(max(kv_share, 0.0), 1.0)
    coll_share = 1.0 - kv_share
    if coll_share <= 0.0:
        return kv_s, kv_s + coll_s
    if kv_share <= 0.0:
        return kv_s + coll_s, coll_s
    t_kv = kv_s / kv_share
    t_coll = coll_s / coll_share
    if t_coll <= t_kv:                 # collectives empty first
        return kv_s + coll_s, t_coll
    return t_kv, kv_s + coll_s         # KV empties first

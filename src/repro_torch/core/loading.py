"""Dual-path KV-Cache loading plans (port of ``repro.core.loading``,
paper §4.1, Figure 4).

A *plan* is the ordered list of transfer legs a request's KV-Cache makes
through the machine, each leg annotated with the resources it occupies
(storage NIC, compute-NIC PCIe read/write side, DRAM, inter-node network)
and its byte count.  The discrete-event simulator charges each leg to
its resources; the engine runtime executes the same legs as real buffer
movements.  Keeping the byte accounting in one place guarantees the
simulator, the engines, and the §4.2 closed-form analysis agree — this
is property-tested (tests/test_loading.py asserts the per-resource sums
match Eq. 1–8's coefficients).

Resource keys are *symbolic* (pe_/de_ prefixed); the simulator binds
them to concrete node resources:

    snic       storage NIC (half-duplex FIFO, shared per node)
    cnic_rd    compute-NIC PCIe read side (NIC pulls from DRAM/HBM)
    cnic_wr    compute-NIC PCIe write side (NIC pushes to DRAM/HBM)
    dram       host DRAM (half-duplex: reads+writes share)
    net        inter-node compute network (PE<->DE)

Layerwise legs (``layerwise=True``) stream LayerBlocks and overlap with
prefill compute; the sim models them as running concurrently with the
forward pass, matching "transfers overlap with computation".
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.traffic import TrafficClass


@dataclass(frozen=True)
class Leg:
    name: str
    nbytes: int
    resources: tuple                 # symbolic resource keys
    layerwise: bool = False          # streams per layer, overlaps compute
    phase: str = "prefill"           # 'load' | 'prefill' | 'decode_start' | 'decode'
    tclass: TrafficClass = TrafficClass.KV_TRANSFER


def pe_read_plan(hit_bytes: int, miss_bytes: int, gen_bytes: int) -> List[Leg]:
    """Figure 4a: storage→PE buffer→PE HBM→DE buffer→DE HBM."""
    full = hit_bytes + miss_bytes
    return [
        Leg("storage_to_pe_buf", hit_bytes,
            ("pe_snic", "pe_dram"), phase="load"),
        Leg("pe_buf_to_pe_hbm", hit_bytes,
            ("pe_cnic_rd", "pe_cnic_wr", "pe_dram"), layerwise=True),
        Leg("pe_hbm_to_de_buf", full,
            ("pe_cnic_rd", "net", "de_cnic_wr", "de_dram"), layerwise=True),
        Leg("de_buf_to_de_hbm", full,
            ("de_cnic_rd", "de_cnic_wr", "de_dram"), phase="decode_start"),
        Leg("persist_new_kv", miss_bytes + gen_bytes,
            ("de_cnic_rd", "de_cnic_wr", "de_dram", "de_snic"),
            phase="decode"),
    ]


def de_read_plan(hit_bytes: int, miss_bytes: int, gen_bytes: int) -> List[Leg]:
    """Figure 4b: storage→DE buffer→(stream)→PE HBM; miss KV merged back."""
    full = hit_bytes + miss_bytes
    return [
        Leg("storage_to_de_buf", hit_bytes,
            ("de_snic", "de_dram"), phase="load"),
        Leg("de_buf_to_pe_hbm", hit_bytes,
            ("de_cnic_rd", "de_dram", "net", "pe_cnic_wr"), layerwise=True),
        Leg("miss_kv_to_de_buf", miss_bytes,
            ("pe_cnic_rd", "net", "de_cnic_wr", "de_dram"), layerwise=True),
        Leg("de_buf_to_de_hbm", full,
            ("de_cnic_rd", "de_cnic_wr", "de_dram"), phase="decode_start"),
        Leg("persist_new_kv", miss_bytes + gen_bytes,
            ("de_cnic_rd", "de_cnic_wr", "de_dram", "de_snic"),
            phase="decode"),
    ]


def basic_plan(hit_bytes: int, miss_bytes: int, gen_bytes: int) -> List[Leg]:
    """The Basic baseline: PE-only storage reads, no DE buffer staging —
    KV goes storage→PE DRAM→PE HBM, then PE→DE over the compute network
    directly into DE HBM (classic PD disaggregation)."""
    full = hit_bytes + miss_bytes
    return [
        Leg("storage_to_pe_buf", hit_bytes,
            ("pe_snic", "pe_dram"), phase="load"),
        Leg("pe_buf_to_pe_hbm", hit_bytes,
            ("pe_cnic_rd", "pe_cnic_wr", "pe_dram"), layerwise=True),
        Leg("pe_hbm_to_de_hbm", full,
            ("pe_cnic_rd", "net", "de_cnic_wr"), layerwise=True),
        Leg("persist_new_kv", miss_bytes + gen_bytes,
            ("de_cnic_rd", "de_cnic_wr", "de_dram", "de_snic"),
            phase="decode"),
    ]


def oracle_plan(hit_bytes: int, miss_bytes: int, gen_bytes: int) -> List[Leg]:
    """Oracle baseline: all disk reads, D2H/H2D and inter-PD transfers
    bypassed (zero I/O overhead upper bound)."""
    return []


def split_read_plan(hit_bytes: int, miss_bytes: int, gen_bytes: int,
                    pe_bytes: int) -> List[Leg]:
    """Split read (paper §6.1 future work): one request's hit bytes are
    partitioned across *both* storage NICs — ``pe_bytes`` enter via the
    PE side (Figure 4a legs) and ``hit_bytes - pe_bytes`` via the DE
    side (Figure 4b legs), so both ``snic`` resources serve the same
    request's load phase concurrently.

    The miss/persist legs are path-independent (they occupy identical
    resources in Fig. 4a and 4b), so the per-resource byte sums of a
    split plan are the *exact* convex combination of the two pure plans
    with weight r = pe_bytes / hit_bytes — property-tested byte-for-byte
    in tests/test_loading.py.  Zero-byte legs are dropped, making the
    r=1 / r=0 endpoints structurally identical to the pure plans.
    """
    assert 0 <= pe_bytes <= hit_bytes, (pe_bytes, hit_bytes)
    de_bytes = hit_bytes - pe_bytes
    full = hit_bytes + miss_bytes
    legs = [
        # both storage NICs engaged concurrently on one request
        Leg("storage_to_pe_buf", pe_bytes,
            ("pe_snic", "pe_dram"), phase="load"),
        Leg("storage_to_de_buf", de_bytes,
            ("de_snic", "de_dram"), phase="load"),
        # PE-side share climbs into PE HBM locally
        Leg("pe_buf_to_pe_hbm", pe_bytes,
            ("pe_cnic_rd", "pe_cnic_wr", "pe_dram"), layerwise=True),
        # DE-side share streams over the compute network into PE HBM
        Leg("de_buf_to_pe_hbm", de_bytes,
            ("de_cnic_rd", "de_dram", "net", "pe_cnic_wr"), layerwise=True),
        # PE-resident KV (PE-side hit + computed miss) forwarded to DE buf
        Leg("pe_hbm_to_de_buf", pe_bytes + miss_bytes,
            ("pe_cnic_rd", "net", "de_cnic_wr", "de_dram"), layerwise=True),
        Leg("de_buf_to_de_hbm", full,
            ("de_cnic_rd", "de_cnic_wr", "de_dram"), phase="decode_start"),
        Leg("persist_new_kv", miss_bytes + gen_bytes,
            ("de_cnic_rd", "de_cnic_wr", "de_dram", "de_snic"),
            phase="decode"),
    ]
    return [leg for leg in legs if leg.nbytes > 0]


def tiered_read_plan(hit_bytes: int, miss_bytes: int, gen_bytes: int,
                     pe_snic_bytes: int, de_snic_bytes: int,
                     pe_tier_bytes: int, de_tier_bytes: int) -> List[Leg]:
    """Split read with node-local DRAM-tier hits (kvcache/tiers.py).

    The hit partitions four ways: per side, ``*_snic_bytes`` are read
    from remote storage (Fig. 4a/4b load legs) and ``*_tier_bytes`` are
    already resident in that side's DRAM tier — they skip the storage
    NIC entirely and appear as a zero-transfer ``*_tier_hit`` leg whose
    only resource is the accounting key ``{side}_tier``.  Everything
    downstream of the DRAM buffer is unchanged: tier bytes ride the same
    buf→HBM / cross-network legs as freshly-read bytes, so the plan's
    non-load resources equal ``split_read_plan`` with
    ``pe_bytes = pe_snic + pe_tier`` byte-for-byte (property-tested in
    tests/test_tiers.py), and the load legs conserve exactly:
    ``pe_snic + de_snic + pe_tier + de_tier == hit_bytes``.
    """
    assert pe_snic_bytes >= 0 and de_snic_bytes >= 0
    assert pe_tier_bytes >= 0 and de_tier_bytes >= 0
    total = pe_snic_bytes + de_snic_bytes + pe_tier_bytes + de_tier_bytes
    assert total == hit_bytes, (total, hit_bytes)
    pe_total = pe_snic_bytes + pe_tier_bytes
    de_total = de_snic_bytes + de_tier_bytes
    full = hit_bytes + miss_bytes
    legs = [
        # DRAM-tier hits: already staged in that side's buffer — no SNIC
        Leg("pe_tier_hit", pe_tier_bytes, ("pe_tier",), phase="load"),
        Leg("de_tier_hit", de_tier_bytes, ("de_tier",), phase="load"),
        # cold remainder still pays the storage NICs
        Leg("storage_to_pe_buf", pe_snic_bytes,
            ("pe_snic", "pe_dram"), phase="load"),
        Leg("storage_to_de_buf", de_snic_bytes,
            ("de_snic", "de_dram"), phase="load"),
        # downstream movement is source-agnostic (tier == warm buffer)
        Leg("pe_buf_to_pe_hbm", pe_total,
            ("pe_cnic_rd", "pe_cnic_wr", "pe_dram"), layerwise=True),
        Leg("de_buf_to_pe_hbm", de_total,
            ("de_cnic_rd", "de_dram", "net", "pe_cnic_wr"), layerwise=True),
        Leg("pe_hbm_to_de_buf", pe_total + miss_bytes,
            ("pe_cnic_rd", "net", "de_cnic_wr", "de_dram"), layerwise=True),
        Leg("de_buf_to_de_hbm", full,
            ("de_cnic_rd", "de_cnic_wr", "de_dram"), phase="decode_start"),
        Leg("persist_new_kv", miss_bytes + gen_bytes,
            ("de_cnic_rd", "de_cnic_wr", "de_dram", "de_snic"),
            phase="decode"),
    ]
    return [leg for leg in legs if leg.nbytes > 0]


def rebalance_remainder(pe_snic_bytes: int, de_snic_bytes: int,
                        from_side: str, remaining_bytes: int,
                        moved_bytes: int) -> tuple:
    """Hedged split read: re-water-fill part of one side's *remainder*
    onto the other side mid-read, byte-exactly.

    A split read started with SNIC shares ``(pe_snic_bytes,
    de_snic_bytes)``; the ``from_side`` leg has straggled with
    ``remaining_bytes`` still unserved, and the hedging policy wants to
    move ``moved_bytes`` of that remainder to the healthy side.  This is
    the pure arithmetic: the move is clamped to what is actually movable
    (never more than the remainder, never more than the side's share —
    bytes already served stay where they were served) and the new
    partition is returned.

    Invariants (property-tested in tests/test_loading.py):

    * conservation — ``new_pe + new_de == pe + de`` exactly;
    * the rebalanced fraction ``moved / remainder`` lies in [0, 1];
    * only SNIC shares move — DRAM-tier hit bytes are not an input, so a
      tier-hit leg can never be re-charged to a storage NIC.
    """
    assert from_side in ("pe", "de"), from_side
    assert pe_snic_bytes >= 0 and de_snic_bytes >= 0
    assert remaining_bytes >= 0
    src = pe_snic_bytes if from_side == "pe" else de_snic_bytes
    assert remaining_bytes <= src, (remaining_bytes, src)
    moved = max(0, min(int(moved_bytes), int(remaining_bytes)))
    if from_side == "pe":
        new = (pe_snic_bytes - moved, de_snic_bytes + moved)
    else:
        new = (pe_snic_bytes + moved, de_snic_bytes - moved)
    assert new[0] + new[1] == pe_snic_bytes + de_snic_bytes
    assert new[0] >= 0 and new[1] >= 0
    return new


def hedge_water_fill(remainder: int, severity: float,
                     healthy_backlog: int = 0) -> int:
    """How much of a straggling leg's remainder to move to the healthy
    side: the water-fill that equalises both sides' completion.

    The straggler serves at ``1/severity`` of the healthy side's rate
    (``severity`` >= 1 is the observed service-time ratio); the healthy
    side already has ``healthy_backlog`` units queued.  Moving ``x``
    equalises ``healthy_backlog + x == (remainder - x) * severity``::

        x = (severity * remainder - healthy_backlog) / (1 + severity)

    clamped to ``[0, remainder]``.  Monotone non-decreasing in
    ``severity`` (d/ds = (remainder + backlog)/(1+s)^2 > 0) and exactly
    0 when the straggler is healthy and unloaded (s=1, backlog >=
    remainder) — both property-tested in tests/test_scheduler.py.
    Units are caller's choice (bytes or tokens), as long as they match.
    """
    assert remainder >= 0 and healthy_backlog >= 0
    assert severity >= 1.0, severity
    x = (severity * remainder - healthy_backlog) / (1.0 + severity)
    return max(0, min(int(x), int(remainder)))


def hedge_water_fill_batch(remainder: np.ndarray, severity: np.ndarray,
                           healthy_backlog: np.ndarray) -> np.ndarray:
    """:func:`hedge_water_fill` over request arrays, element-exact.

    ``int(x)`` truncates toward zero and so does ``astype(int64)`` for
    the post-clamp range, so each element equals the scalar kernel
    bit-for-bit (property-tested in tests/test_vectorized.py)."""
    remainder = np.asarray(remainder, dtype=np.int64)
    x = ((severity * remainder - healthy_backlog) /
         (1.0 + np.asarray(severity, dtype=np.float64)))
    return np.maximum(0, np.minimum(x.astype(np.int64), remainder))


def resource_bytes_batch(mode: str, hit: np.ndarray, miss: np.ndarray,
                         gen: np.ndarray,
                         pe_snic: Optional[np.ndarray] = None,
                         de_snic: Optional[np.ndarray] = None,
                         pe_tier: Optional[np.ndarray] = None,
                         de_tier: Optional[np.ndarray] = None,
                         ) -> Dict[str, np.ndarray]:
    """``resource_bytes(plan_for(...))`` closed over request arrays.

    One call gives the per-resource byte ledger for a whole fleet of
    requests at once — the quantity the fleet benchmark and the
    byte-conservation property tests sum, without building ``Leg``
    objects per request.  ``mode`` is the plan family:

    * ``"dualpath"`` — the unified tiered/split algebra.  The hit
      partition ``(pe_snic, de_snic, pe_tier, de_tier)`` must sum to
      ``hit`` elementwise; pure Fig. 4a/4b paths are the degenerate
      partitions (everything on one SNIC), plain splits have zero tier
      columns, so one formula covers ``pe``/``de``/split/tiered plans.
    * ``"basic"`` / ``"oracle"`` — the baselines (partition ignored).

    Equality with the per-request ``resource_bytes(plan_for(...))``
    dict, key by key and element by element, is the contract
    (tests/test_vectorized.py checks it over randomized workloads).
    Zero-valued entries are kept: absent resource == zero bytes.
    """
    hit = np.asarray(hit, dtype=np.int64)
    miss = np.asarray(miss, dtype=np.int64)
    gen = np.asarray(gen, dtype=np.int64)
    z = np.zeros_like(hit)
    full = hit + miss
    persist = miss + gen
    if mode == "oracle":
        keys = ("pe_snic", "de_snic", "pe_dram", "de_dram", "pe_cnic_rd",
                "pe_cnic_wr", "de_cnic_rd", "de_cnic_wr", "net",
                "pe_tier", "de_tier")
        return {k: z.copy() for k in keys}
    if mode == "basic":
        return {
            "pe_snic": hit.copy(),
            "pe_dram": 2 * hit,
            "pe_cnic_rd": hit + full,
            "pe_cnic_wr": hit.copy(),
            "net": full.copy(),
            "de_cnic_wr": full + persist,
            "de_cnic_rd": persist.copy(),
            "de_dram": persist.copy(),
            "de_snic": persist.copy(),
            "pe_tier": z.copy(),
            "de_tier": z.copy(),
        }
    if mode != "dualpath":
        raise ValueError(f"mode {mode!r} (valid: dualpath, basic, oracle)")
    pe_snic = z if pe_snic is None else np.asarray(pe_snic, dtype=np.int64)
    de_snic = z if de_snic is None else np.asarray(de_snic, dtype=np.int64)
    pe_tier = z if pe_tier is None else np.asarray(pe_tier, dtype=np.int64)
    de_tier = z if de_tier is None else np.asarray(de_tier, dtype=np.int64)
    part = pe_snic + de_snic + pe_tier + de_tier
    if not np.array_equal(part, hit):
        raise ValueError("hit partition does not sum to hit_bytes")
    pe_total = pe_snic + pe_tier
    de_total = de_snic + de_tier
    fwd = pe_total + miss                 # pe_hbm_to_de_buf leg
    return {
        "pe_snic": pe_snic.copy(),
        "de_snic": de_snic + persist,
        "pe_tier": pe_tier.copy(),
        "de_tier": de_tier.copy(),
        "pe_dram": pe_snic + pe_total,
        "de_dram": de_snic + de_total + fwd + full + persist,
        "pe_cnic_rd": pe_total + fwd,
        "pe_cnic_wr": pe_total + de_total,
        "de_cnic_rd": de_total + full + persist,
        "de_cnic_wr": fwd + full + persist,
        "net": de_total + fwd,
    }


PLANS = {
    "pe": pe_read_plan,
    "de": de_read_plan,
    "basic": basic_plan,
    "oracle": oracle_plan,
}


def plan_for(read_path: str, read_split: float, hit_bytes: int,
             miss_bytes: int, gen_bytes: int,
             tier: Optional[tuple] = None) -> List[Leg]:
    """The legs a scheduled request actually executes.

    ``read_path``/``read_split`` come straight from the scheduler
    (core/scheduler.py): ``read_split`` is the fraction of hit bytes
    read on the ``read_path`` side; 1.0 means a pure Fig. 4a/4b plan,
    anything below means a split plan.  The simulator, the engines and
    the tests all dispatch through here so the byte accounting cannot
    diverge between them.

    ``tier`` — optional explicit hit partition
    ``(pe_snic, de_snic, pe_tier, de_tier)`` in bytes (from
    ``Request.hit_bytes_partition``) for requests whose hit is partly
    served by a node-local DRAM tier; it overrides the
    ``read_split``-derived partition and must sum to ``hit_bytes``.
    """
    if tier is not None:
        return tiered_read_plan(hit_bytes, miss_bytes, gen_bytes, *tier)
    if read_path not in PLANS:
        raise ValueError(
            f"read_path {read_path!r} (valid: {sorted(PLANS)}); did the "
            f"scheduler choose a path for this request yet?")
    if read_split >= 1.0 or read_path not in ("pe", "de"):
        return PLANS[read_path](hit_bytes, miss_bytes, gen_bytes)
    pe_frac = read_split if read_path == "pe" else 1.0 - read_split
    pe_bytes = int(hit_bytes * pe_frac)
    return split_read_plan(hit_bytes, miss_bytes, gen_bytes, pe_bytes)


def resource_bytes(plan: List[Leg]) -> dict:
    """Aggregate bytes per symbolic resource — the quantity the §4.2
    analysis constrains.  Used by tests to pin the plan against Eq. 1–8."""
    out: dict = {}
    for leg in plan:
        for r in leg.resources:
            out[r] = out.get(r, 0) + leg.nbytes
    return out

"""Trace audit: cross-validate span sums against conservation ledgers
(port of ``repro.obs.audit``).

A trace that silently drops or double-counts records is worse than no
trace — attribution built on it lies.  The audit makes the recorder
correctness tooling: every byte the runtimes' own conservation
counters saw must reappear, exactly, as trace records.

* :func:`audit_sim` — per-node storage-NIC spans (tagged ``read`` /
  ``weights`` / ``blob`` / ``persist`` / ``prefetch``) must sum to the
  simulator's ``_FifoNic`` byte counters exactly (the span is emitted at
  the completion event that bumps the counter, with the same float, in
  the same order, so even float addition agrees); hedge events must
  reproduce ``hedged_reads`` / ``hedge_moved_tokens``.
* :func:`audit_serving` — per-side storage-read and tier-hit event
  bytes must match ``read_bytes_by_side`` / ``dram_bytes_by_side``;
  persist-event bytes must equal the store's ``bytes_written``
  (exactly-once persists; requires a fully-drained run — pass
  ``check_persists=False`` for runs cut off mid-flight); hedge events
  must reproduce ``hedged_reads`` / ``hedge_moved_tokens``.

All checks raise :class:`TraceAuditError` on the first mismatch and
return the tallied sums on success.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict


class TraceAuditError(AssertionError):
    """A trace record sum disagrees with a runtime conservation
    ledger."""


def _expect(what: str, got, want) -> None:
    if got != want:
        raise TraceAuditError(
            f"trace audit: {what}: trace says {got!r}, ledger says "
            f"{want!r}")


def _hedge_check(tracer, hedged_reads: int,
                 hedge_moved_tokens: int) -> Dict[str, int]:
    n = 0
    moved = 0
    for _, _, _, args in tracer.iter_events("hedge"):
        n += 1
        moved += args["moved_tokens"]
    _expect("hedge event count vs hedged_reads", n, hedged_reads)
    _expect("hedge moved-token sum vs hedge_moved_tokens", moved,
            hedge_moved_tokens)
    return {"hedge_events": n, "hedge_moved_tokens": moved}


def audit_sim(sim, tracer) -> dict:
    """Validate a traced :class:`repro_torch.sim.simulator.Sim` run."""
    by_node: Dict[int, Dict[str, float]] = defaultdict(
        lambda: defaultdict(float))
    for track, _, _, _, args in tracer.iter_spans("snic/", "nic_xfer"):
        node = int(track.split("node", 1)[1])
        by_node[node][args["tag"]] += args["nbytes"]
    for node, nic in sorted(sim.snic.items()):
        tags = by_node.get(node, {})
        reads = tags.get("read", 0.0) + tags.get("weights", 0.0) + \
            tags.get("blob", 0.0)
        _expect(f"node{node} read span bytes", reads, nic.read_bytes)
        _expect(f"node{node} persist span bytes",
                tags.get("persist", 0.0), nic.write_bytes)
        _expect(f"node{node} prefetch span bytes",
                tags.get("prefetch", 0.0), nic.prefetch_bytes)
        unknown = set(tags) - {"read", "weights", "blob", "persist",
                               "prefetch"}
        if unknown:
            raise TraceAuditError(
                f"trace audit: node{node} has spans with unknown "
                f"tags {sorted(unknown)}")
    out = {"snic_bytes_by_node": {n: dict(t)
                                  for n, t in sorted(by_node.items())}}
    out.update(_hedge_check(tracer, sim.hedged_reads,
                            sim.hedge_moved_tokens))
    return out


def audit_serving(system, tracer, check_persists: bool = True) -> dict:
    """Validate a traced
    :class:`repro_torch.serving.system.ServingSystem` run."""
    read_by_side: Dict[str, int] = defaultdict(int)
    for _, _, _, args in tracer.iter_events("storage_read"):
        read_by_side[args["side"]] += args["nbytes"]
    for side, want in system.read_bytes_by_side.items():
        _expect(f"{side}-side storage_read event bytes",
                read_by_side.get(side, 0), want)

    dram_by_side: Dict[str, int] = defaultdict(int)
    for _, _, _, args in tracer.iter_events("tier_hit"):
        dram_by_side[args["side"]] += args["nbytes"]
    for side, want in system.dram_bytes_by_side.items():
        _expect(f"{side}-side tier_hit event bytes",
                dram_by_side.get(side, 0), want)

    out = {"read_bytes_by_side": dict(read_by_side),
           "dram_bytes_by_side": dict(dram_by_side)}

    if check_persists:
        persist = 0
        for _, _, _, args in tracer.iter_events("persist"):
            persist += args["nbytes"]
        _expect("persist event bytes vs store.bytes_written (exactly-"
                "once persists; needs a fully-drained run)",
                persist, system.store.bytes_written)
        out["persist_bytes"] = persist

    out.update(_hedge_check(tracer, system.hedged_reads,
                            system.hedge_moved_tokens))
    return out

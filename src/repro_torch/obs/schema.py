"""Canonical metric-name schema (port of ``repro.obs.schema``).

Every headline metric of a results dict is registered here with a kind,
a unit and the runtimes that emit it; the registry holds every key the
reference registers, for its simulator and its serving runtime alike.
``ServingSystem.stats()`` passes through :func:`conforming` before it
returns, so an unregistered key is a hard error where it is emitted;
:func:`orphans` names registered keys a dict does not emit.

Naming rules (enforced on registration and by ``MetricsRegistry``):

* lower_snake_case, ``[a-z][a-z0-9_]*``;
* unit suffixes where a unit applies: ``*_s`` seconds, ``*_bytes``,
  ``*_tokens``, ``*_ratio``;
* counts carry no suffix (``finished_rounds``, ``engine_deaths``).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, Set

SIM = "sim"
SERVING = "serving"

NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")


@dataclass(frozen=True)
class MetricSpec:
    name: str
    kind: str                      # counter | gauge | summary | mixed
    unit: str                      # s | bytes | tokens | count | ratio | mixed
    runtimes: FrozenSet[str]
    description: str = ""


REGISTRY: Dict[str, MetricSpec] = {}

_KINDS = ("counter", "gauge", "summary", "mixed")
_UNITS = ("s", "bytes", "tokens", "count", "ratio", "mixed")


def register(name: str, kind: str, unit: str, runtimes: Iterable[str],
             description: str = "") -> MetricSpec:
    if not NAME_RE.match(name):
        raise ValueError(f"metric name {name!r} violates the naming "
                         f"rule {NAME_RE.pattern}")
    if kind not in _KINDS:
        raise ValueError(f"{name}: unknown kind {kind!r}")
    if unit not in _UNITS:
        raise ValueError(f"{name}: unknown unit {unit!r}")
    spec = MetricSpec(name, kind, unit, frozenset(runtimes), description)
    prev = REGISTRY.get(name)
    if prev is not None and prev != spec:
        raise ValueError(f"metric {name!r} re-registered with a "
                         f"different spec")
    REGISTRY[name] = spec
    return spec


def registered_keys(runtime: str) -> Set[str]:
    """Every metric name ``runtime`` is expected to emit."""
    return {n for n, s in REGISTRY.items() if runtime in s.runtimes}


def conforming(d: dict, runtime: str) -> dict:
    """Validate that ``d`` (a results/stats dict) emits only registered
    names for ``runtime``; returns ``d`` unchanged.  Called at the end
    of ``ServingSystem.stats()`` so an unreviewed key cannot ship."""
    unknown = set(d) - registered_keys(runtime)
    if unknown:
        raise KeyError(
            f"{runtime} emits metric keys not registered in "
            f"repro_torch.obs.schema: {sorted(unknown)} — register them "
            f"(name, kind, unit) before emitting")
    return d


def orphans(d: dict, runtime: str) -> Set[str]:
    """Registered-for-``runtime`` names missing from ``d`` — dead
    registrations, or metrics a runtime does not emit (yet)."""
    return registered_keys(runtime) - set(d)


# ---------------------------------------------------------------------------
# the registry: every key Sim.results() / ServingSystem.stats() emits
# ---------------------------------------------------------------------------

_BOTH = (SIM, SERVING)

# --- shared latency summary (serving/events.latency_summary + sim) --------
register("finished_rounds", "counter", "count", _BOTH,
         "rounds with done_t stamped")
register("ttft_mean", "summary", "s", _BOTH, "time to first token, mean")
register("ttft_p99", "summary", "s", _BOTH, "time to first token, p99")
register("ttst_mean", "summary", "s", _BOTH, "time to second token, mean")
register("tpot_mean", "summary", "s", _BOTH, "time per output token, mean")
register("tpot_p99", "summary", "s", _BOTH, "time per output token, p99")

# --- simulator-only workload/latency columns ------------------------------
register("finished_agents", "counter", "count", (SIM,),
         "trajectories run to completion")
register("jct_mean", "summary", "s", (SIM,), "job completion time, mean")
register("jct_max", "summary", "s", (SIM,), "job completion time, max")
register("sim_time", "gauge", "s", (SIM,), "modelled clock at exit")
register("prompt_tokens", "counter", "tokens", (SIM,),
         "prefill tokens processed")
register("gen_tokens", "counter", "tokens", _BOTH,
         "decode tokens generated")
register("snic_hit_read_bytes", "counter", "bytes", (SIM,),
         "demand hit bytes that paid a storage NIC")
register("dram_hit_ratio", "gauge", "ratio", (SIM,),
         "tier hits / (tier hits + SNIC hit reads)")
register("tier_evictions", "counter", "count", (SIM,),
         "tier entries evicted")
register("net_collective_delay_s", "summary", "s", (SIM,),
         "collective completion beyond uncontended service")
register("net_collective_bytes", "counter", "bytes", (SIM,),
         "model-collective bytes on the shared link")
register("net_kv_bytes", "counter", "bytes", (SIM,),
         "KV-transfer bytes on the shared link")
register("net_contended_joins", "counter", "count", (SIM,),
         "flows that joined a contended link")

# --- serving-only columns --------------------------------------------------
register("store_reads", "counter", "bytes", (SERVING,),
         "bytes read from the remote KV store")
register("store_writes", "counter", "bytes", (SERVING,),
         "bytes written to the remote KV store")
register("read_bytes_pe_side", "counter", "bytes", (SERVING,),
         "storage read bytes on the PE side")
register("read_bytes_de_side", "counter", "bytes", (SERVING,),
         "storage read bytes on the DE side")
register("split_reads", "counter", "count", (SERVING,),
         "requests whose hit was read by both sides' NICs")
register("trie_blocks", "counter", "count", (SERVING,),
         "blocks registered in the prefix trie")
register("prefill_tokens", "counter", "tokens", (SERVING,),
         "prefill tokens processed")
register("decode_steps", "counter", "count", (SERVING,),
         "slot-batched decode steps executed")
register("wall_s", "gauge", "s", (SERVING,), "modelled wall clock at exit")
register("doorbells", "counter", "count", (SERVING,),
         "doorbell rings across all TrafficManagers")
register("submitted_seconds", "counter", "s", (SERVING,),
         "modelled submission overhead")
register("net_congestion", "gauge", "ratio", (SERVING,),
         "last tick's collective share of CNIC traffic")
register("paced_flushes", "counter", "count", (SERVING,),
         "flushes that deferred KV WRs under congestion")
register("deferred_wrs", "counter", "count", (SERVING,),
         "KV WRs deferred by congestion pacing")
register("dram_bytes_pe_side", "counter", "bytes", (SERVING,),
         "tier-served bytes on the PE side")
register("dram_bytes_de_side", "counter", "bytes", (SERVING,),
         "tier-served bytes on the DE side")
register("tier_miss_bytes", "counter", "bytes", (SERVING,),
         "demand reads through the tier's backing store")

# --- shared subsystem columns ---------------------------------------------
register("dram_hit_bytes", "counter", "bytes", _BOTH,
         "hit bytes served from a DRAM tier (no SNIC)")
register("tier_prefetch_bytes", "counter", "bytes", _BOTH,
         "bytes staged ahead of demand")
register("tier_evicted_bytes", "counter", "bytes", _BOTH,
         "bytes evicted from DRAM tiers")
register("collective_stall_s", "summary", "s", _BOTH,
         "step time lost waiting on collectives")
register("transfer_backlog_s", "summary", "s", _BOTH,
         "KV completion beyond uncontended service")
register("role_changes", "counter", "count", _BOTH,
         "completed PE<->DE role flips")
register("role_changes_by_direction", "mixed", "mixed", _BOTH,
         "flip counts keyed by direction")
register("reconfig_drain_s", "summary", "s", _BOTH,
         "admission-stop-to-flip seconds, total")
register("reconfig_weight_bytes", "counter", "bytes", _BOTH,
         "weight-shard bytes reloaded by flips")
register("tier_handoff_bytes", "counter", "bytes", _BOTH,
         "tier-resident bytes kept across flips")
register("n_pe_final", "gauge", "count", _BOTH, "PEs at exit")
register("n_de_final", "gauge", "count", _BOTH, "DEs at exit")
register("engine_deaths", "counter", "count", _BOTH,
         "fail-stopped engines")
register("recovered_rounds", "counter", "count", _BOTH,
         "rounds re-homed after an engine death")
register("hedged_reads", "counter", "count", _BOTH,
         "read legs hedged to the healthy side")
register("hedge_moved_tokens", "counter", "tokens", _BOTH,
         "tokens re-water-filled by hedges")

# --- online SLO layer (core/config.SloConfig) -----------------------------
register("admitted_rounds", "counter", "count", _BOTH,
         "arrivals passed by the admission gate (== submissions when "
         "admission control is off)")
register("deferred_rounds", "counter", "count", _BOTH,
         "admission-gate deferrals (one arrival may defer repeatedly)")
register("rejected_rounds", "counter", "count", _BOTH,
         "arrivals shed after exhausting admission deferrals")
register("prefill_chunks", "counter", "count", _BOTH,
         "partial (chunked) prefill batch items executed")
register("latency_by_class", "mixed", "mixed", _BOTH,
         "per-SLO-class latency summaries (interactive | batch)")

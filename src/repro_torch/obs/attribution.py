"""Critical-path attribution: where did each request's TTFT go? (port
of ``repro.obs.attribution``)

Decomposes the window from a request's submission to its first token
into per-resource waiting seconds, from the spans the runtimes record
on the request's ``req/<rid>`` track:

* **storage** — storage-NIC read legs (``read_leg`` spans in the sim,
  the ``reading`` lifecycle span in serving);
* **compute** — prefill steps and the first decode block
  (``prefill`` / ``decode_first``);
* **net** — compute-network PD transfers (``pd_transfer``);
* **drain** — elastic-reconfiguration drain windows (``drain`` spans
  on the global ``reconfig`` track) overlapping the request, counted
  only where no request-level span explains the time;
* **queue** — the residual: time covered by none of the above
  (admission queues, scheduler waits, tick granularity).

The decomposition is a *partition*: the window is swept over the
breakpoints of every contributing interval and each segment is
assigned to exactly one category by the priority order above, so the
five components sum to the measured TTFT **exactly** (floating-point
addition aside).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

#: category -> span names feeding it, in attribution priority order.
CATEGORY_SPANS = (
    ("storage_s", ("read_leg", "reading")),
    ("compute_s", ("prefill", "decode_first")),
    ("net_s", ("pd_transfer",)),
)
#: all categories in output order (drain + residual appended).
CATEGORIES = tuple(c for c, _ in CATEGORY_SPANS) + ("drain_s", "queue_s")

FIRST_TOKEN = "first_token"


def _clip(ivs: List[Tuple[float, float]], t0: float,
          t1: float) -> List[Tuple[float, float]]:
    out = []
    for a, b in ivs:
        a, b = max(a, t0), min(b, t1)
        if b > a:
            out.append((a, b))
    return out


def _covered(ivs: List[Tuple[float, float]], t: float) -> bool:
    return any(a <= t < b for a, b in ivs)


def attribute_ttft(tracer, rid: Optional[int] = None) -> Dict[int, dict]:
    """Per-request TTFT decomposition from ``tracer``'s records.

    Returns ``{rid: {"ttft_s", "t0", "storage_s", "compute_s",
    "net_s", "drain_s", "queue_s"}}`` for every request with a
    recorded ``first_token`` event (restricted to ``rid`` if given).
    The five category values partition ``ttft_s``.
    """
    # gather per-request spans and first-token stamps ------------------
    by_rid: Dict[int, List[tuple]] = defaultdict(list)
    t_first: Dict[int, float] = {}
    t_sub: Dict[int, float] = {}
    for track, name, t0, t1, args in tracer.iter_spans("req/"):
        r = int(track.split("/", 1)[1])
        by_rid[r].append((name, t0, t1))
        t_sub[r] = min(t_sub.get(r, t0), t0)
    for track, name, t, args in tracer.iter_events(FIRST_TOKEN):
        if track.startswith("req/"):
            t_first[int(track.split("/", 1)[1])] = t
    drains = [(t0, t1) for _, _, t0, t1, _ in
              tracer.iter_spans("reconfig", "drain")]

    out: Dict[int, dict] = {}
    for r in sorted(t_first):
        if rid is not None and r != rid:
            continue
        if r not in t_sub:
            continue
        w0, w1 = t_sub[r], t_first[r]
        if w1 <= w0:
            continue
        # clip each category's intervals to the TTFT window ------------
        cat_ivs: List[Tuple[str, List[Tuple[float, float]]]] = []
        for cat, names in CATEGORY_SPANS:
            ivs = [(a, b) for nm, a, b in by_rid[r] if nm in names]
            cat_ivs.append((cat, _clip(ivs, w0, w1)))
        cat_ivs.append(("drain_s", _clip(list(drains), w0, w1)))
        # priority sweep over all breakpoints --------------------------
        pts = {w0, w1}
        for _, ivs in cat_ivs:
            for a, b in ivs:
                pts.add(a)
                pts.add(b)
        cuts = sorted(pts)
        acc = {c: 0.0 for c in CATEGORIES}
        for a, b in zip(cuts, cuts[1:]):
            mid = 0.5 * (a + b)
            for cat, ivs in cat_ivs:
                if _covered(ivs, mid):
                    acc[cat] += b - a
                    break
            else:
                acc["queue_s"] += b - a
        rec = {"ttft_s": w1 - w0, "t0": w0}
        rec.update(acc)
        out[r] = rec
    return out


def bottleneck_report(per_request: Dict[int, dict]) -> dict:
    """Aggregate a per-request decomposition into an arm-level report:
    mean seconds and TTFT fraction per category, the dominant category
    (``bottleneck``), and the worst residual-vs-measured mismatch
    (``max_decomp_err_s`` — ~0 by construction; the smoke gate pins
    it)."""
    n = len(per_request)
    if n == 0:
        nan = float("nan")
        rep = {"n": 0, "ttft_mean_s": nan, "bottleneck": "none",
               "max_decomp_err_s": nan}
        for c in CATEGORIES:
            rep[f"{c.removesuffix('_s')}_mean_s"] = nan
            rep[f"{c.removesuffix('_s')}_frac"] = nan
        return rep
    tot = {c: 0.0 for c in CATEGORIES}
    ttft_tot = 0.0
    max_err = 0.0
    for rec in per_request.values():
        ttft_tot += rec["ttft_s"]
        parts = 0.0
        for c in CATEGORIES:
            tot[c] += rec[c]
            parts += rec[c]
        max_err = max(max_err, abs(parts - rec["ttft_s"]))
    rep = {"n": n, "ttft_mean_s": ttft_tot / n,
           "bottleneck": max(CATEGORIES, key=lambda c: tot[c])
           .removesuffix("_s"),
           "max_decomp_err_s": max_err}
    for c in CATEGORIES:
        base = c.removesuffix("_s")
        rep[f"{base}_mean_s"] = tot[c] / n
        rep[f"{base}_frac"] = (tot[c] / ttft_tot if ttft_tot > 0
                               else float("nan"))
    return rep

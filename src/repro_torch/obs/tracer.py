"""Flight recorder: spans, events and counters on the modelled clock
(port of ``repro.obs.tracer``).

* **No cost when off** — every hook in the runtime is guarded by ``if
  tracer is not None``; with ``tracer=None`` the runtime runs the exact
  untraced code.
* **Deterministic** — records carry only the runtime's *modelled* clock
  (``VirtualClock.now``, never ``time.time()``), are appended in event
  order, and the export sorts with a stable per-record sequence
  tie-breaker, so the same workload, seed and FaultSchedule give a
  byte-identical JSON trace.
* **Perfetto-compatible export** — :meth:`Tracer.to_chrome_trace` emits
  the Chrome trace-event format (``ph: X/i/C/M``): one thread track per
  engine, NIC, tier or request, and counter tracks for queue depths and
  tier occupancy.

Track names are hierarchical strings (``"tier/node0"``, ``"req/12"``):
the first path component becomes the Perfetto process, the full name the
thread, both numbered in first-seen order.
"""
from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional

#: timestamp unit of the Chrome trace format (microseconds)
_US = 1e6


class Tracer:
    """Append-only recorder of spans, instant events and counters.

    ``now_fn`` (bound by the runtime via :meth:`bind_clock`) supplies
    the modelled time for records whose call site does not pass an
    explicit timestamp — the seam components (scheduler, traffic
    manager, tier, controller) have no clock of their own.
    """

    def __init__(self, now_fn: Optional[Callable[[], float]] = None):
        self._now = now_fn
        # (seq, track, name, t0, t1, args) — t1 < 0 marks an instant
        self.spans: List[tuple] = []
        self.counters: List[tuple] = []    # (seq, track, t, values)
        self._seq = 0

    # ------------------------------------------------------------------
    # clock binding
    # ------------------------------------------------------------------
    def bind_clock(self, now_fn: Callable[[], float]) -> "Tracer":
        """Attach the owning runtime's modelled clock (``loop.now`` /
        ``clock.now``).  Never a wall clock: determinism depends on it."""
        self._now = now_fn
        return self

    @property
    def now(self) -> float:
        if self._now is None:
            raise RuntimeError("Tracer has no clock bound; the owning "
                               "runtime must call bind_clock() first")
        return self._now()

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------
    def span(self, track: str, name: str, t0: float, t1: float,
             **args) -> None:
        """A complete span [t0, t1] on ``track`` (Chrome ``ph: X``)."""
        self.spans.append((self._seq, track, name, float(t0), float(t1),
                           args))
        self._seq += 1

    def event(self, track: str, name: str, t: Optional[float] = None,
              **args) -> None:
        """An instant event (Chrome ``ph: i``) at ``t`` (default: the
        bound clock's now)."""
        tt = self.now if t is None else float(t)
        self.spans.append((self._seq, track, name, tt, -1.0, args))
        self._seq += 1

    def counter(self, track: str, t: Optional[float] = None,
                **values) -> None:
        """A counter sample (Chrome ``ph: C``): one numeric series per
        keyword, rendered as a stacked counter track in Perfetto."""
        tt = self.now if t is None else float(t)
        self.counters.append((self._seq, track, tt, values))
        self._seq += 1

    # ------------------------------------------------------------------
    # queries (attribution / audit consume these, not the raw tuples)
    # ------------------------------------------------------------------
    def iter_spans(self, track_prefix: Optional[str] = None,
                   name: Optional[str] = None):
        """Yield ``(track, name, t0, t1, args)`` for complete spans,
        optionally filtered; recording order."""
        for _, track, nm, t0, t1, args in self.spans:
            if t1 < 0:
                continue
            if track_prefix is not None and \
                    not track.startswith(track_prefix):
                continue
            if name is not None and nm != name:
                continue
            yield track, nm, t0, t1, args

    def iter_events(self, name: Optional[str] = None):
        """Yield ``(track, name, t, args)`` for instant events."""
        for _, track, nm, t0, t1, args in self.spans:
            if t1 >= 0:
                continue
            if name is not None and nm != name:
                continue
            yield track, nm, t0, args

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def _track_ids(self) -> Dict[str, tuple]:
        """track name -> (pid, tid), assigned in first-seen order."""
        pids: Dict[str, int] = {}
        tids: Dict[str, tuple] = {}
        for rec in sorted(self.spans + self.counters,
                          key=lambda r: r[0]):
            track = rec[1]
            if track in tids:
                continue
            group = track.split("/", 1)[0]
            pid = pids.setdefault(group, len(pids) + 1)
            tids[track] = (pid, len(tids) + 1)
        return tids

    def to_chrome_trace(self) -> dict:
        """The Chrome trace-event representation (a JSON-ready dict)."""
        tids = self._track_ids()
        out: List[dict] = []
        for track, (pid, tid) in tids.items():
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0,
                        "args": {"name": track.split("/", 1)[0]}})
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": track}})
        recs = []
        for seq, track, name, t0, t1, args in self.spans:
            pid, tid = tids[track]
            if t1 >= 0:
                recs.append((t0, seq, {
                    "ph": "X", "name": name, "cat": track,
                    "ts": round(t0 * _US, 3),
                    "dur": round(max(t1 - t0, 0.0) * _US, 3),
                    "pid": pid, "tid": tid, "args": args}))
            else:
                recs.append((t0, seq, {
                    "ph": "i", "name": name, "cat": track, "s": "t",
                    "ts": round(t0 * _US, 3),
                    "pid": pid, "tid": tid, "args": args}))
        for seq, track, t, values in self.counters:
            pid, tid = tids[track]
            recs.append((t, seq, {
                "ph": "C", "name": track, "ts": round(t * _US, 3),
                "pid": pid, "tid": tid, "args": values}))
        recs.sort(key=lambda r: (r[0], r[1]))
        out.extend(r[2] for r in recs)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export_json(self, path: str) -> str:
        """Write the Perfetto-loadable trace to ``path``.  Sorted keys
        and fixed separators keep the bytes deterministic."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, sort_keys=True,
                      separators=(",", ":"))
            f.write("\n")
        return path

    def export_bytes(self) -> bytes:
        """The exported trace as bytes (what export_json writes) — the
        determinism tests compare these directly."""
        return (json.dumps(self.to_chrome_trace(), sort_keys=True,
                           separators=(",", ":")) + "\n").encode()

    # ------------------------------------------------------------------
    # fault-window annotations (sim/faults.py)
    # ------------------------------------------------------------------
    def annotate_faults(self, faults) -> None:
        """Record a FaultSchedule's slowdown windows as spans on the
        ``faults`` track (one sub-track per resource) and its engine
        deaths as instant events, so every chaos run's injected
        degradations are visible alongside the request lifecycles."""
        if faults is None:
            return
        for w in faults.windows:
            self.span(f"faults/{w.resource}", "fault_window",
                      w.t0, w.t1, factor=w.factor,
                      node=w.node if w.node is not None else "all")
        for d in faults.deaths:
            self.event("faults/deaths", "engine_death_scheduled",
                       t=d.t, engine=list(d.engine))

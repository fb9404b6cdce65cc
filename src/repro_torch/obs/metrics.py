"""Typed metric instruments under the schema's naming rules (port of
``repro.obs.metrics``).

:class:`MetricsRegistry` is a small, deterministic instrument store —
counters, gauges and histograms — whose names are validated against
:mod:`repro_torch.obs.schema`'s naming rule at creation time.  The runtimes'
headline dicts remain plain dicts (validated by
:func:`repro_torch.obs.schema.conforming`); this module serves ad-hoc
instrumentation in benchmarks and tests, where a histogram's
deterministic percentiles and a ``snapshot()`` that always renders the
same keys beat hand-rolled lists.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

from repro_torch.obs.schema import NAME_RE


def _check_name(name: str) -> str:
    if not NAME_RE.match(name):
        raise ValueError(f"metric name {name!r} violates the naming "
                         f"rule {NAME_RE.pattern}")
    return name


class Counter:
    """Monotonically increasing value; ``inc`` rejects negatives."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = _check_name(name)
        self.value = 0.0

    def inc(self, by: float = 1.0) -> None:
        if by < 0:
            raise ValueError(f"{self.name}: counters only increase "
                             f"(got {by})")
        self.value += by


class Gauge:
    """A point-in-time value; set freely."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = _check_name(name)
        self.value = float("nan")

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Sample accumulator with deterministic summary statistics.

    Percentiles use the nearest-rank method on the sorted samples —
    no interpolation, no numpy, so the summary is bit-stable across
    platforms.  Empty histograms summarise to NaN (the same contract
    as ``serving/events.latency_summary``).
    """

    __slots__ = ("name", "samples")

    def __init__(self, name: str):
        self.name = _check_name(name)
        self.samples: List[float] = []

    def observe(self, v: float) -> None:
        self.samples.append(float(v))

    @property
    def count(self) -> int:
        return len(self.samples)

    def mean(self) -> float:
        if not self.samples:
            return float("nan")
        return sum(self.samples) / len(self.samples)

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile, ``q`` in [0, 100]."""
        if not self.samples:
            return float("nan")
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile {q} outside [0, 100]")
        s = sorted(self.samples)
        rank = max(1, math.ceil(q / 100.0 * len(s)))
        return s[rank - 1]

    def summary(self) -> Dict[str, float]:
        return {
            "count": float(self.count),
            "mean": self.mean(),
            "p50": self.percentile(50.0),
            "p99": self.percentile(99.0),
            "max": self.percentile(100.0),
        }


class MetricsRegistry:
    """Namespace of instruments; one instance per run/arm.

    ``counter``/``gauge``/``histogram`` are get-or-create, so call
    sites need no pre-declaration, but a name may not change kind
    mid-run (that is exactly the drift the schema exists to stop).
    """

    def __init__(self):
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls):
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name)
            self._instruments[name] = inst
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, requested {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> Dict[str, object]:
        """Flat, name-sorted dict of current values: scalars for
        counters/gauges, summary dicts for histograms."""
        out: Dict[str, object] = {}
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            if isinstance(inst, Histogram):
                out[name] = inst.summary()
            else:
                out[name] = inst.value  # type: ignore[union-attr]
        return out

    def get(self, name: str) -> Optional[object]:
        return self._instruments.get(name)

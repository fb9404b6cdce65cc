"""Flight-recorder observability layer (port of ``repro.obs``).

* :mod:`repro_torch.obs.tracer` — spans, events and counters on the
  *modelled* clock, exported as Chrome-trace JSON (open in Perfetto);
* :mod:`repro_torch.obs.schema` — the metric-name registry
  ``ServingSystem.stats()`` and ``Sim.results()`` are validated against;
* :mod:`repro_torch.obs.metrics` — counters, gauges and histograms under
  the schema's naming rules;
* :mod:`repro_torch.obs.attribution` — critical-path decomposition of
  each request's TTFT into per-resource waiting seconds;
* :mod:`repro_torch.obs.audit` — cross-validation of trace byte sums
  against the serving runtime's and the simulator's conservation
  ledgers.

Every hook in the runtimes is guarded by ``if tracer is not None``, so
with no tracer attached they run the untraced arithmetic.
"""
from repro_torch.obs.attribution import attribute_ttft, bottleneck_report
from repro_torch.obs.audit import TraceAuditError, audit_serving, audit_sim
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.schema import conforming, orphans, registered_keys
from repro_torch.obs.tracer import Tracer

__all__ = [
    "Tracer", "conforming", "orphans", "registered_keys",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "attribute_ttft", "bottleneck_report",
    "audit_sim", "audit_serving", "TraceAuditError",
]

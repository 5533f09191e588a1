"""Unified observability (torch port of ``repro.obs``): span tracing,
mergeable metrics, exposition.

- ``metrics``: process-wide registry of counters/gauges/fixed-bucket
  histograms whose snapshots merge across processes (fleet view).
- ``trace``: per-request span tracing with cross-process trace ids and
  Chrome-trace/Perfetto JSON export.
- ``export``: stdlib HTTP endpoint (Prometheus text + JSON + /health)
  and snapshot files next to checkpoints.
- ``health``: rule engine over registry series — structured
  ``HealthEvent`` log + per-process ``ok``/``degraded``/``critical``
  verdicts that merge across a fleet.
- ``profile``: optional ``torch.profiler`` hooks around the solve.
- ``recorder``: bounded flight recorder — request digests, journal
  tail, cadenced state fingerprints — flushed to atomic incident
  bundles on health-verdict escalations.
- ``forensics``: offline bundle replay, fingerprint verification and
  first-bad-event bisection (``python -m repro_torch.obs.forensics``).
"""

from repro_torch.obs.export import (prometheus_text, start_metrics_server,
                                    write_snapshot)
from repro_torch.obs.forensics import IncidentBundle, analyze, load_bundle
from repro_torch.obs.health import (
    HealthEvent,
    HealthMonitor,
    HealthRule,
    default_rules,
    merge_health,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_buckets,
    merge,
    quantile,
    registry,
)
from repro_torch.obs.profile import ProfileHooks
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.trace import Span, Tracer

__all__ = [
    "Counter",
    "FlightRecorder",
    "Gauge",
    "HealthEvent",
    "HealthMonitor",
    "HealthRule",
    "Histogram",
    "IncidentBundle",
    "MetricsRegistry",
    "ProfileHooks",
    "Span",
    "Tracer",
    "analyze",
    "default_buckets",
    "default_rules",
    "load_bundle",
    "merge",
    "merge_health",
    "prometheus_text",
    "quantile",
    "registry",
    "start_metrics_server",
    "write_snapshot",
]

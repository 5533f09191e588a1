"""Metrics exposition: stdlib HTTP endpoint + snapshot files (the port's
copy of ``repro/obs/export.py``).

``start_metrics_server`` serves the live registry at ``/metrics``
(Prometheus text exposition) and ``/metrics.json`` (the raw snapshot)
from a daemon thread — no dependencies beyond the stdlib, safe to run
beside the serving loop.  With a ``health`` callable it also serves
``/health``: the JSON verdict + recent-event report produced by
``obs.health.HealthMonitor`` (fleet-merged when the callable merges).
``write_snapshot`` drops the same JSON next to checkpoints so a run
leaves a scrapeable record even without the endpoint.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["prometheus_text", "start_metrics_server", "write_snapshot"]


def _prom_name(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def prometheus_text(snapshot: dict) -> str:
    """Render a registry snapshot in Prometheus text exposition format."""
    lines: list[str] = []
    for name, v in sorted(snapshot.get("counters", {}).items()):
        n = _prom_name(name)
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n} {v}")
    for name, v in sorted(snapshot.get("gauges", {}).items()):
        n = _prom_name(name)
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {v}")
    for name, h in sorted(snapshot.get("histograms", {}).items()):
        n = _prom_name(name)
        lines.append(f"# TYPE {n} histogram")
        acc = 0
        for bound, c in zip(h["bounds"], h["counts"]):
            acc += c
            lines.append(f'{n}_bucket{{le="{bound:g}"}} {acc}')
        acc += h["counts"][-1]
        lines.append(f'{n}_bucket{{le="+Inf"}} {acc}')
        lines.append(f"{n}_sum {h['sum']}")
        lines.append(f"{n}_count {h['count']}")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    registry: MetricsRegistry  # set on the subclass by start_metrics_server
    extra_snapshots = None  # optional callable -> list of foreign snapshots
    health = None  # optional callable -> wire-safe health report dict

    def do_GET(self) -> None:  # noqa: N802 (stdlib API)
        from repro_torch.obs.metrics import merge

        if self.path.startswith("/health"):
            if self.health is None:
                self.send_response(404)
                self.end_headers()
                return
            body = json.dumps(type(self).health()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        snap = self.registry.snapshot()
        if self.extra_snapshots is not None:
            snap = merge([snap, *type(self).extra_snapshots()])
        if self.path.startswith("/metrics.json"):
            if self.health is not None:
                # the structured health report (verdict + active rules +
                # recent HealthEvents) rides the JSON payload so scrapers
                # see the events, not just the numeric verdict gauge
                snap = {**snap, "health": type(self).health()}
            body = json.dumps(snap).encode()
            ctype = "application/json"
        elif self.path.startswith("/metrics"):
            body = prometheus_text(snap).encode()
            ctype = "text/plain; version=0.0.4"
        else:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a) -> None:  # keep the serving loop's stdout clean
        pass


def start_metrics_server(
    registry: MetricsRegistry,
    port: int = 0,
    host: str = "127.0.0.1",
    extra_snapshots=None,
    health=None,
) -> tuple[ThreadingHTTPServer, int]:
    """Serve ``registry`` over HTTP from a daemon thread.

    Returns ``(server, bound_port)`` — port 0 binds an ephemeral port.
    ``extra_snapshots`` is an optional zero-arg callable returning
    foreign snapshots (e.g. the dispatcher's last worker pongs) merged
    into every response, so one endpoint exposes the whole fleet.
    ``health`` is an optional zero-arg callable returning a wire-safe
    health report (e.g. ``HealthMonitor.report`` or the dispatcher's
    fleet-merged view), served as JSON at ``/health``.
    """
    handler = type(
        "_BoundHandler",
        (_Handler,),
        {"registry": registry,
         "extra_snapshots": staticmethod(extra_snapshots)
         if extra_snapshots is not None else None,
         "health": staticmethod(health) if health is not None else None},
    )
    srv = ThreadingHTTPServer((host, port), handler)
    srv.daemon_threads = True
    t = threading.Thread(target=srv.serve_forever, daemon=True, name="metrics-http")
    t.start()
    return srv, srv.server_address[1]


def write_snapshot(path: str, snapshot: dict, *, health=None) -> None:
    """Atomically write a snapshot JSON (rides next to checkpoints).

    ``health``: optional wire-safe health report dict (e.g.
    ``HealthMonitor.report()`` or a fleet-merged view) embedded under a
    ``"health"`` key — the structured event log would otherwise die with
    the process. ``obs.merge`` ignores unknown keys, so an embedded
    report never perturbs later snapshot merges.
    """
    if health is not None:
        snapshot = {**snapshot, "health": health}
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(snapshot, f, indent=1)
    os.replace(tmp, path)

"""Tiny HTTP server exposing the scheduler's observability surface:

- /metrics          Prometheus text exposition (labeled series, # HELP)
- /healthz          liveness probe
- /traces           recent scheduling cycle traces as JSON
- /traces/export    lifecycle spans as Chrome/Perfetto trace-event JSON
                    (load in ui.perfetto.dev or chrome://tracing)
- /flightrecorder   the black-box engine-event ring as JSON

The reference explicitly disables metrics (MetricsBindAddress "",
reference pkg/yoda/scheduler.go:55); SURVEY §5 lists observability as a
must-add. Stdlib-only, runs on a daemon thread next to the scheduler;
every handler reads a snapshot, so a scrape mid-drain never blocks (or is
blocked by) the engine.
"""

from __future__ import annotations

import json
import threading
from dataclasses import asdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .obs import export_chrome_trace


def serve(metrics, traces=None, host: str = "127.0.0.1", port: int = 10251,
          spans=None, flight=None):
    """Start serving in a daemon thread; returns (server, thread). Use
    port=0 to pick a free port (server.server_address[1]).

    `spans` is a SpanRing, an iterable of SpanRings, or any object with a
    ``rings()`` method yielding them (the multi-profile/fleet merged
    views); `flight` is a FlightRecorder or an object with snapshot()."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/metrics":
                body = metrics.render_prometheus().encode()
                ctype = "text/plain; version=0.0.4"
            elif self.path == "/healthz":
                body = b"ok"
                ctype = "text/plain"
            elif self.path == "/traces" and traces is not None:
                body = json.dumps(
                    [asdict(t) for t in traces.recent(100)]).encode()
                ctype = "application/json"
            elif self.path == "/traces/export" and spans is not None:
                rings_fn = getattr(spans, "rings", None)
                if rings_fn is not None:
                    rings = rings_fn()
                elif hasattr(spans, "chrome_events"):
                    rings = [spans]
                else:
                    rings = list(spans)
                body = json.dumps(export_chrome_trace(rings)).encode()
                ctype = "application/json"
            elif self.path == "/flightrecorder" and flight is not None:
                body = json.dumps(flight.snapshot()).encode()
                ctype = "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            return

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread

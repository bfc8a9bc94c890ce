"""Shared HTTP plumbing for reader-side tiles (copy of the HTTP half of
the JAX package's disco/httpd.py).

The metric tile follows the reference's shape (ref:
src/disco/metrics/fd_metric_tile.c): the server renders straight from
shared memory on a daemon thread while the tile loop stays idle, so the
endpoint survives any other tile's death. This module holds the route
table, the ephemeral-port bind and the clean shutdown.

Request counting is thread-safe (`Counter`): ThreadingHTTPServer runs
each request on its own thread, so a bare `+= 1` would lose counts under
concurrent scrapes.

Where the copy differs from the reference: no WebSocket half (the
reference's `ws_routes`, upgrade, broadcast and per-client queues over
disco/ws.py serve the gui tile, ROADMAP.md queue A item 9).
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils import log


class Counter:
    """Lock-guarded monotone counter (handler threads bump, the tile
    loop reads)."""

    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def bump(self) -> int:
        with self._lock:
            self._v += 1
            return self._v

    @property
    def value(self) -> int:
        return self._v


class TileHttpServer:
    """ThreadingHTTPServer on a daemon thread over a GET route table.

    routes: {path: handler}; a handler takes no arguments and returns
    (status, content_type, body_bytes). A handler's exception becomes a
    500 (a rendering bug must not kill the serving thread). `requests`
    counts every handled request, thread-safely."""

    def __init__(self, routes: dict, port: int = 0,
                 bind_addr: str = "127.0.0.1"):
        self.routes = dict(routes)
        self.requests = Counter()
        plumbing = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                # route on the bare path: a ?query must not 404 an
                # exact-match table
                path = self.path.split("?", 1)[0]
                handler = plumbing.routes.get(path)
                if handler is None:
                    plumbing.requests.bump()
                    self.send_error(404)
                    return
                try:
                    status, ctype, body = handler()
                except Exception as e:   # noqa: BLE001 — keep serving
                    # the endpoint is the alerting surface: a renderer
                    # that keeps failing needs its cause in the log
                    log.warning(f"http {self.path}: render failed: "
                                f"{e!r}")
                    status, ctype, body = (
                        500, "text/plain", b"render failed\n")
                plumbing.requests.bump()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):   # keep tile stdout quiet
                pass

        self.server = ThreadingHTTPServer((bind_addr, int(port)), Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(
            target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()

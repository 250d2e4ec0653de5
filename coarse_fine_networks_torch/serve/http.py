"""HTTP front end of the video inference tier (counterpart of
``coarse_fine_networks_tpu/serve/http.py``, the same protocol).

A thin, dependency-free network surface over :class:`.router.ModelRouter`
on the standard library's ``ThreadingHTTPServer``: the handler threads only
decode requests and encode results; batching, caching, routing and the
model run on the routers' scheduler threads.

* ``POST /v1/score`` — the body is a raw ``.npz`` with ``clips (T, H, W,
  3)`` float32 and optionally ``fine_clips``; query parameters ``model``
  and ``video_id`` select the variant and enable the fine-feature cache,
  ``priority=<int>`` raises scheduling precedence.  The response is an
  ``.npz`` with ``probs (4·T, n_classes)`` float32.
* ``GET /v1/models`` — JSON list of the registered variants.
* ``GET /v1/stats`` — JSON per-variant queue, batch and cache health.
* ``GET /healthz`` — 200 while serving, 503 once draining.

An unknown model or route maps to 404, a malformed body or input to 400,
overload to 429 and a timed-out request to 504.
"""

from __future__ import annotations

import io
import json
import threading
from concurrent.futures import CancelledError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from .router import ModelRouter, UnknownModelError
from .scheduler import ServerOverloadedError


class InferenceHTTPServer:
    """Serve a :class:`ModelRouter` over HTTP.

    Args:
      router: a started (or startable) router.
      host/port: bind address; ``port=0`` picks a free port.
      result_timeout_s: how long a request waits for its batched result
        before it gets 504.
    """

    def __init__(self, router: ModelRouter, host: str = "127.0.0.1",
                 port: int = 8000, result_timeout_s: float = 120.0):
        self.router = router
        self.result_timeout = result_timeout_s
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet; /v1/stats has the numbers
                pass

            def _reply(self, code: int, body: bytes,
                       ctype: str = "application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, obj):
                self._reply(code, json.dumps(obj).encode())

            def do_GET(self):
                path = urlparse(self.path).path
                if path == "/healthz":
                    if outer.router.stopped:
                        self._json(503, {"status": "draining"})
                    else:
                        self._json(200, {"status": "ok"})
                elif path == "/v1/models":
                    self._json(200, {"models": outer.router.models})
                elif path == "/v1/stats":
                    self._json(200, outer.router.stats())
                else:
                    self._json(404, {"error": f"no route {path}"})

            def do_POST(self):
                url = urlparse(self.path)
                if url.path != "/v1/score":
                    self._json(404, {"error": f"no route {url.path}"})
                    return
                q = parse_qs(url.query)
                model = q.get("model", [None])[0]
                video_id = q.get("video_id", [None])[0]
                try:
                    priority = int(q.get("priority", ["0"])[0])
                    n = int(self.headers.get("Content-Length", "0"))
                    with np.load(io.BytesIO(self.rfile.read(n))) as z:
                        clips = z["clips"]
                        fine = (z["fine_clips"] if "fine_clips" in z.files
                                else None)
                except Exception as e:  # noqa: BLE001 — any bad body is 400
                    self._json(400, {"error": f"bad request: {e}"})
                    return
                try:
                    kw = {}
                    if video_id is not None:
                        kw["video_id"] = video_id
                    if priority:
                        kw["priority"] = priority
                    fut = outer.router.submit(clips, fine, model=model, **kw)
                    probs = fut.result(timeout=outer.result_timeout)
                except UnknownModelError as e:
                    self._json(404, {"error": f"unknown model {e}"})
                    return
                except ServerOverloadedError as e:
                    self._json(429, {"error": str(e)})
                    return
                except (TimeoutError, CancelledError) as e:
                    self._json(504, {"error": f"timed out: {e}"})
                    return
                except (ValueError, RuntimeError) as e:
                    self._json(400, {"error": str(e)})
                    return
                buf = io.BytesIO()
                np.savez(buf, probs=np.asarray(probs, np.float32))
                self._reply(200, buf.getvalue(),
                            ctype="application/octet-stream")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "InferenceHTTPServer":
        self.router.start()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Drain: stop accepting connections, then stop the router."""
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=30)
        self.router.stop()

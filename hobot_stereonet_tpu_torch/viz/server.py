"""Live browser display: MJPEG-over-HTTP server (stdlib only).

Counterpart of ``hobot_stereonet_tpu/viz/server.py``; JPEG through PIL,
imported when a frame is published.

The reference's top display layers are a render node that republishes
[left | depth-colormap] JPEG composites plus an external ``websocket``
package feeding a browser (SURVEY.md L4/L5; launch wiring at
``hobot_stereonet_demo.launch.py:85-94``, browser view per ``README.md:61-63``).
Here both collapse into one in-process server: results are rendered with
:mod:`.colormap` and published as a ``multipart/x-mixed-replace`` MJPEG
stream any browser can display directly — no ROS, no websocket bridge.

Endpoints:
  ``/``           minimal HTML page wrapping the stream
  ``/stream``     MJPEG stream (multipart/x-mixed-replace)
  ``/frame.jpg``  latest composite as a single JPEG
  ``/metrics``    JSON engine-metrics snapshot (when a provider is attached)
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

_PAGE = b"""<!doctype html>
<html><head><title>hobot_stereonet_tpu_torch</title>
<style>body{background:#111;margin:0;text-align:center}
img{max-width:100%;height:auto}h1{color:#ddd;font:14px monospace}</style>
</head><body><h1>hobot_stereonet_tpu_torch &mdash; live stereo depth</h1>
<img src="/stream" alt="stream"></body></html>
"""


def encode_jpeg(rgb: np.ndarray, quality: int = 85) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


class DisplayServer:
    """Thread-backed MJPEG server.  ``publish(rgb)`` from any thread; each
    connected client receives every frame published after it connects."""

    def __init__(self, port: int = 8080, host: str = "0.0.0.0",
                 quality: int = 85,
                 metrics_fn: Optional[Callable[[], dict]] = None):
        self._quality = quality
        self._metrics_fn = metrics_fn
        self._cond = threading.Condition()
        self._jpeg: Optional[bytes] = None
        self._seq = 0
        self._stopping = False

        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet: metrics go to /metrics
                pass

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self._send(200, "text/html", _PAGE)
                elif self.path == "/frame.jpg":
                    jpeg = outer.latest_jpeg()
                    if jpeg is None:
                        self._send(503, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/jpeg", jpeg)
                elif self.path == "/metrics":
                    snap = outer._metrics_fn() if outer._metrics_fn else {}
                    self._send(200, "application/json",
                               json.dumps(snap).encode())
                elif self.path == "/stream":
                    self._stream()
                else:
                    self._send(404, "text/plain", b"not found")

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _stream(self):
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame",
                )
                self.end_headers()
                seen = -1
                try:
                    while True:
                        with outer._cond:
                            outer._cond.wait_for(
                                lambda: outer._seq != seen or outer._stopping,
                                timeout=5.0,
                            )
                            if outer._stopping:
                                return
                            if outer._seq == seen or outer._jpeg is None:
                                continue
                            jpeg, seen = outer._jpeg, outer._seq
                        self.wfile.write(
                            b"--frame\r\nContent-Type: image/jpeg\r\n"
                            + f"Content-Length: {len(jpeg)}\r\n\r\n".encode()
                        )
                        self.wfile.write(jpeg)
                        self.wfile.write(b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    return  # client went away

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "DisplayServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="display-http"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        self._httpd.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self._httpd.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def publish(self, rgb: np.ndarray) -> None:
        jpeg = encode_jpeg(np.ascontiguousarray(rgb), self._quality)
        with self._cond:
            self._jpeg = jpeg
            self._seq += 1
            self._cond.notify_all()

    def latest_jpeg(self) -> Optional[bytes]:
        with self._cond:
            return self._jpeg


def publish_result(server: DisplayServer, result) -> None:
    """Render a :class:`~..runtime.engine.StereoResult` to the reference's
    composite layout (left view stacked over the colorized map) and publish.
    Falls back to the colormap alone when the engine didn't keep the left
    view."""
    from .colormap import colorize_disparity, render_result

    if result.left_rgb is not None:
        server.publish(render_result(result.left_rgb, result.disparity,
                                     depth_m=result.depth_m))
    else:
        server.publish(colorize_disparity(result.disparity))

"""Live trajectory viewer: a local HTTP endpoint during online runs.

A copy of rvio_tpu/utils/live_viewer.py (stdlib and numpy) over the
port's ``trajectory_svg``.  Headless stand-in for the reference's rviz visualization (reference:
src/rvio/System.cc:386-434 publishes tf/odometry/path for rviz,
config/rvio_rviz.rviz) — serves the current trajectory/landmark SVG over
a dependency-free ``http.server`` thread so a browser on the same host
shows the run live:

    from rvio_tpu_torch.utils.live_viewer import LiveViewer
    drv = OnlineDriver(cfg)     # rvio_tpu_torch.runtime, on the card
    viewer = LiveViewer(lambda: drv.poses, port=8642)
    viewer.start()          # open http://localhost:8642/
    ... drv.spin(...) ...
    viewer.stop()

The page polls ``/traj.svg`` once a second; the handler snapshots the
pose source on every request (the source callable must be cheap and
thread-safe — a list append from the consumer thread is).
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

from rvio_tpu_torch.utils.visualize import trajectory_svg

_PAGE = b"""<!doctype html>
<html><head><title>rvio_tpu live</title></head>
<body style="font-family:sans-serif;margin:12px">
<h3 style="margin:4px 0">rvio_tpu live trajectory</h3>
<div id="meta" style="color:#666;font-size:13px">waiting...</div>
<img id="traj" src="/traj.svg" width="640" height="640"/>
<script>
setInterval(function () {
  document.getElementById('traj').src = '/traj.svg?t=' + Date.now();
  fetch('/meta').then(r => r.text()).then(
    t => document.getElementById('meta').textContent = t);
}, 1000);
</script></body></html>
"""


class LiveViewer:
    """Serve the current trajectory as SVG at http://localhost:<port>/.

    ``poses_source``: zero-arg callable returning the pose rows —
    either a list of ``(t, p (3,), q (4,))`` tuples (the online driver's
    ``poses`` attribute) or an (T, 3) position array.
    ``landmarks_source``: optional callable returning an (N, 3) cloud.
    """

    def __init__(self, poses_source: Callable, port: int = 8642,
                 landmarks_source: Optional[Callable] = None,
                 axes=(0, 1)):
        self._poses = poses_source
        self._landmarks = landmarks_source
        self._axes = axes
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def _snapshot(self):
        rows = self._poses()
        if rows is None or len(rows) == 0:
            return None
        if isinstance(rows, np.ndarray):
            return np.asarray(rows, float).reshape(-1, 3)
        return np.asarray([np.asarray(r[1], float) for r in list(rows)])

    def start(self) -> "LiveViewer":
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, "text/html", _PAGE)
                elif path == "/traj.svg":
                    p = viewer._snapshot()
                    if p is None:
                        self._send(200, "image/svg+xml",
                                   b'<svg xmlns="http://www.w3.org/2000/svg"'
                                   b' width="640" height="640"/>')
                        return
                    lm = (viewer._landmarks()
                          if viewer._landmarks is not None else None)
                    svg = trajectory_svg(p, landmarks=lm, axes=viewer._axes)
                    self._send(200, "image/svg+xml", svg.encode())
                elif path == "/meta":
                    p = viewer._snapshot()
                    n = 0 if p is None else len(p)
                    last = ("-" if p is None else
                            np.array2string(p[-1], precision=2))
                    self._send(200, "text/plain",
                               f"poses: {n}   last p_Gk: {last}".encode())
                else:
                    self._send(404, "text/plain", b"not found")

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolves port=0
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

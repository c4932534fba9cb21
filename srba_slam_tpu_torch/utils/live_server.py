"""Live map server: browser equivalent of the reference's live 3D window
(stdlib only; the port's own copy of ``srba_slam_tpu/utils/live_server.py``).

The reference opens an interactive CDisplayWindow3D and refreshes it every
keyframe (reference src/CSRBAStereoSLAMEstimator.cpp:1262-1338). The target
environments here are headless, so liveness is served over HTTP instead:
``start_live_server(out_dir)`` spins up a stdlib HTTP server (daemon
thread, zero dependencies) rooted at the run's output directory, writes the
live viewer page (utils/html_viewer.write_live_viewer), and the estimator's
per-keyframe snapshot (`_live_viz_snapshot`) keeps ``live_map.json``
current — the page polls it once a second and redraws. Enabled from the CLI
with ``--serve [PORT]``.

Everything the directory accumulates during the run (live_map.png,
out_kf_poses.txt, the final map_viewer.html, ...) is browsable too.
"""

from __future__ import annotations

import http.server
import os
import threading

LIVE_PAGE = "live_viewer.html"


class _QuietHandler(http.server.SimpleHTTPRequestHandler):
    def log_message(self, *args):  # no per-request console spam
        pass

    def end_headers(self):
        # the page re-fetches live_map.json each second; never let the
        # browser cache a stale map
        self.send_header("Cache-Control", "no-store")
        super().end_headers()

    def do_GET(self):
        if self.path in ("/", ""):
            self.path = "/" + LIVE_PAGE
        return super().do_GET()


def start_live_server(out_dir: str, port: int = 0):
    """Serve ``out_dir`` on ``port`` (0 = ephemeral). Writes the live viewer
    page into the directory first. Returns (server, actual_port); the server
    runs on a daemon thread — call ``server.shutdown()`` to stop it, or let
    process exit reap it."""
    from srba_slam_tpu_torch.utils.html_viewer import write_live_viewer

    os.makedirs(out_dir, exist_ok=True)
    write_live_viewer(os.path.join(out_dir, LIVE_PAGE))

    def handler(*args, **kw):
        return _QuietHandler(*args, directory=out_dir, **kw)

    srv = http.server.ThreadingHTTPServer(("", port), handler)
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name="srba-live-server").start()
    return srv, srv.server_address[1]

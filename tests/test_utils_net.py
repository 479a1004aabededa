"""Coverage for the observability + network seams: timer semantics
(timer.h:42-77 / bench_common.h:102-121 analogs) and the HTTP sender
(network.c:66-122 analog) against a local HTTP server."""

import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import jax.numpy as jnp
import numpy as np

from seal_embedded_jax.io import network
from seal_embedded_jax.utils import timing


def test_timer_accumulates_and_resets():
    t = timing.Timer()
    t.start()
    time.sleep(0.01)
    t.stop()
    first = t.read_us()
    assert first >= 9_000  # >= 9ms in us
    t.start()
    t.stop()
    assert t.read_us() >= first  # accumulates
    t.reset()
    assert t.read_us() == 0.0


def test_bench_stats_curr_avg_min_max():
    s = timing.BenchStats([0.002, 0.001, 0.004])
    assert s.curr == 0.004 and s.min == 0.001 and s.max == 0.004
    assert abs(s.avg - 0.007 / 3) < 1e-12
    out = s.summary_us()
    assert set(out) == {"curr", "avg", "min", "max"}
    assert out["min"] == 1000.0


def test_bench_fn_runs_device_fn():
    f = lambda x: jnp.sum(x * 2)  # noqa: E731
    stats = timing.bench_fn(f, jnp.arange(128), iters=3, warmup=1)
    assert len(stats.times_s) == 3 and stats.min > 0


def test_http_sender_posts_components():
    received = []

    class H(BaseHTTPRequestHandler):
        def do_POST(self):
            ln = int(self.headers["Content-Length"])
            received.append(self.rfile.read(ln))
            self.send_response(200)
            self.end_headers()
            self.wfile.write(b"ok")

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), H)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        send = network.http_sender(
            f"http://127.0.0.1:{srv.server_port}/ct")
        payload = np.arange(16, dtype="<u4").tobytes()
        assert send(payload) == len(payload)
        assert send(b"second") == 6
    finally:
        srv.shutdown()
    assert received == [payload, b"second"]

"""Timers and profiling helpers.

The reference's microsecond timer layer (device/lib/timer.{h,c}, gated by
SE_ENABLE_TIMERS) re-imagined for an accelerator: wall-clock timers around
block_until_ready, a benchmark helper reporting curr/avg/min/max over N
runs exactly like the reference bench harness (bench/bench_common.h:102-121),
and a context manager hooking the JAX profiler for kernel-level traces.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import jax


@dataclasses.dataclass
class Timer:
    """start/stop/read accumulator (timer.h:42-77 semantics)."""
    elapsed: float = 0.0
    _t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        assert self._t0 is not None, "timer not started"
        self.elapsed += time.perf_counter() - self._t0
        self._t0 = None

    def reset(self):
        self.elapsed = 0.0
        self._t0 = None

    def read_us(self) -> float:
        return self.elapsed * 1e6


@dataclasses.dataclass
class BenchStats:
    """curr/avg/min/max over runs (bench_common.h:102-121)."""
    times_s: list[float]

    @property
    def curr(self):
        return self.times_s[-1]

    @property
    def avg(self):
        return sum(self.times_s) / len(self.times_s)

    @property
    def min(self):
        return min(self.times_s)

    @property
    def max(self):
        return max(self.times_s)

    def summary_us(self) -> dict:
        return {k: round(getattr(self, k) * 1e6, 1)
                for k in ("curr", "avg", "min", "max")}


def bench_fn(fn: Callable, *args, iters: int = 10, warmup: int = 1) -> BenchStats:
    """Time a device function over `iters` runs (device-synchronized)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return BenchStats(times)


@contextlib.contextmanager
def profile_trace(logdir: str = "seal_trace"):
    """JAX profiler trace (xplane) around a region — the device-side
    equivalent of the reference's per-phase timers."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def print_config(parms, extra: dict | None = None) -> str:
    """Configuration banner (util_print.h:713 print_config equivalent)."""
    lines = [
        "=== seal_embedded_jax configuration ===",
        f"degree (n):        {parms.degree}",
        f"logn:              {parms.logn}",
        f"nprimes:           {parms.nprimes}",
        f"moduli:            {list(parms.moduli)}",
        f"scale:             {parms.scale}",
        f"slot count:        {parms.slot_count}",
        f"backend:           {jax.default_backend()}",
        f"devices:           {jax.device_count()}",
    ]
    for k, v in (extra or {}).items():
        lines.append(f"{k+':':19s}{v}")
    banner = "\n".join(lines)
    print(banner)
    return banner

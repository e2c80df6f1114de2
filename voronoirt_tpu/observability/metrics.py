"""Observability: per-phase timings, throughput metrics, profiler traces.

Reference parity (SURVEY.md §5 "Tracing / profiling"): the reference
wraps each Lambda iteration in @time (lambda_iteration.jl:161,254),
whole runs in @timed, and stores total wall time in the HDF5 `time`
dataset.  Here: a structured PhaseTimer whose report feeds the output
store, plus jax.profiler hooks for device traces.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict


class PhaseTimer:
    """Accumulates wall-clock per named phase.

    with timer.phase("sweep"): ...
    timer.report() -> {"sweep": {"total_s": ..., "count": ..., "mean_s": ...}}
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._t0 = time.time()

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.time()
        try:
            yield
        finally:
            self.totals[name] += time.time() - t0
            self.counts[name] += 1

    def add(self, name, seconds):
        self.totals[name] += seconds
        self.counts[name] += 1

    def report(self):
        out = {}
        for name, tot in self.totals.items():
            c = self.counts[name]
            out[name] = {"total_s": tot, "count": c, "mean_s": tot / c}
        out["_wall_s"] = time.time() - self._t0
        return out

    def dump(self, path):
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=1)


def throughput(n_points, n_angles, n_lambda, n_iterations, seconds):
    """grid-points * rays / s (the BASELINE.md north-star metric)."""
    return n_points * n_angles * n_lambda * n_iterations / seconds


@contextlib.contextmanager
def device_trace(log_dir):
    """jax.profiler trace context (view with TensorBoard/XProf)."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_memory(device=None):
    """{"peak_bytes_in_use", "bytes_limit", "bytes_in_use"} of a device
    (default: the first), from its allocator's memory_stats()."""
    import jax
    d = device if device is not None else jax.devices()[0]
    stats = d.memory_stats() or {}
    return {k: stats.get(k) for k in ("peak_bytes_in_use", "bytes_limit",
                                      "bytes_in_use")}


class CompileClock:
    """Sums XLA backend-compile seconds and counts persistent-cache hits
    while active (jax.monitoring events), to split compile time out of a
    timed phase.

        with CompileClock() as cc:
            ...
        cc.seconds, cc.compiles, cc.cache_hits
    """

    _COMPILE = "/jax/core/compile/backend_compile_duration"
    _HIT = "/jax/compilation_cache/cache_hits"

    def __init__(self):
        self.seconds = 0.0
        self.compiles = 0
        self.cache_hits = 0

    def _on_duration(self, event, duration, **_):
        if event == self._COMPILE:
            self.seconds += duration
            self.compiles += 1

    def _on_event(self, event, **_):
        if event == self._HIT:
            self.cache_hits += 1

    def __enter__(self):
        from jax import monitoring
        monitoring.register_event_duration_secs_listener(self._on_duration)
        monitoring.register_event_listener(self._on_event)
        return self

    def __exit__(self, *exc):
        from jax import monitoring
        monitoring.unregister_event_duration_listener(self._on_duration)
        monitoring.unregister_event_listener(self._on_event)
        return False


def nan_guard(name, *arrays):
    """Host-side NaN watchdog mirroring the reference's convergence NaN
    check (lambda_iteration.jl:310-312)."""
    import numpy as np
    for i, a in enumerate(arrays):
        bad = ~np.isfinite(np.asarray(a))
        if bad.any():
            raise FloatingPointError(
                f"{name}: array {i} has {bad.sum()} non-finite values")

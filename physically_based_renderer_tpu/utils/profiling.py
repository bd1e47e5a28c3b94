"""Profiling + observability.

Reference has a frame-time overlay only (`src/gltf_viewer/ui/
PerformanceOverlay.cpp:15-21`).  Here: wall-clock section timers, a rays/s
reporter (the overlay analog for a headless renderer), and jax.profiler
trace capture for real device timelines (SURVEY.md section 5).
"""

from __future__ import annotations

import contextlib
import json
import logging
import time

logger = logging.getLogger("pbr")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s",
        datefmt="%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


@contextlib.contextmanager
def timed(name: str, sync: bool = True):
    """Wall-clock section timer; blocks on outstanding device work when
    sync=True so the number means something under async dispatch."""
    import jax
    t0 = time.perf_counter()
    yield
    if sync:
        try:
            jax.effects_barrier()
        except Exception:
            pass
    logger.info("%s: %.3fs", name, time.perf_counter() - t0)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a jax.profiler trace (view with tensorboard/xprof)."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class RaysPerSecond:
    """Running rays/s meter — the PerformanceOverlay analog."""

    def __init__(self):
        self.rays = 0.0
        self.seconds = 0.0

    def add(self, rays: float, seconds: float) -> None:
        self.rays += float(rays)
        self.seconds += float(seconds)

    @property
    def value(self) -> float:
        return self.rays / self.seconds if self.seconds else 0.0

    def report(self) -> str:
        return json.dumps({"rays": self.rays, "seconds": self.seconds,
                           "rays_per_s": self.value})

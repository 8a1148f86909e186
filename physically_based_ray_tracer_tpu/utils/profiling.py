"""Profiling helpers.

The reference's observability is a frame-time EMA on screen
(Core/Renderer.cpp:467-474, SURVEY.md §5: "no hierarchical profiler, no
trace export"). Replacement: ``jax.profiler`` traces viewable in
TensorBoard/Perfetto + named-scope annotation of pipeline stages.
"""

from __future__ import annotations

import contextlib
import os
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace for everything inside the block.

    View with: tensorboard --logdir <log_dir> (Profile tab) or upload the
    .trace.json.gz to ui.perfetto.dev.
    """
    os.makedirs(log_dir, exist_ok=True)
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named scope that shows up in profiler traces (use as decorator/ctx)."""
    return jax.profiler.TraceAnnotation(name)


@contextlib.contextmanager
def stopwatch(label: str, sink=print):
    """Host-side wall timing with device sync at exit."""
    t0 = time.perf_counter()
    yield
    sink(f"{label}: {(time.perf_counter() - t0) * 1e3:.2f} ms")

"""Tracing hooks for the CLI's ``--profile``.

Counterpart of ``ray_tracing_extended_tpu/utils/profiling.py``:
``trace(logdir)`` records a region with ``torch.profiler`` (CPU and, where
there is a card, CUDA activity) and writes a Chrome trace into ``logdir``;
``annotate(name)`` is a named span inside it. The JAX module's
``debug_mode`` (JAX's NaN checker) has no port yet (ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a region: ``with profiling.trace('prof'): render()``. Writes
    ``logdir/trace.json`` (open it in chrome://tracing or Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named profiler span for host-side phases."""
    return torch.profiler.record_function(name)

"""Tracing and debugging hooks.

Counterpart of ``ray_tracing_extended_tpu/utils/profiling.py``:
``trace(logdir)`` records a region with ``torch.profiler`` (CPU and, where
there is a card, CUDA activity) and writes a Chrome trace into ``logdir``
(the CLI's ``--profile``); ``annotate(name)`` is a named span inside it;
``debug_mode()`` checks every launch's outputs for NaN and Inf, and can
synchronise after each launch (``check_launch``, called by ``render.py``
and ``progressive.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
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


@dataclasses.dataclass
class DebugChecks:
    """What ``check_launch`` does after a launch (``debug_mode`` sets it)."""

    nans: bool = False
    sync: bool = False


DEBUG = DebugChecks()


@contextlib.contextmanager
def debug_mode(nans: bool = True, disable_jit: bool = False):
    """A sanitizer for renders: inside the context every launch of the
    entry points (``render_frame_with_stats``,
    ``render_frames_and_accumulate``, and the band launches of
    ``render_progressive(mesh=...)``) has its image and accumulator checked
    for NaN and Inf; the first non-finite value raises FloatingPointError
    naming the launch's frames and the pixel. The JAX package's switch
    checks every jitted computation; a renderer without gradients is
    checked on what each launch writes.

    ``disable_jit=True`` keeps the JAX name and does the nearest thing the
    port has: ``torch.cuda.synchronize()`` after every launch, so that a
    launch's fault surfaces at that launch and not at a later read.

    The JAX docstring warns that its Pallas kernel makes NaNs on purpose
    (sqrt of a negative sphere discriminant encodes "no root"; comparisons
    discard them), so JAX's checker false-positives in interpret mode. The
    CUDA kernel does the same inside its registers, but those values are
    never written: a check of the outputs cannot see them. Each check is a
    reduction over the outputs and a read back to the host, only inside
    the context; outside it the launches are unchanged."""
    prev = dataclasses.replace(DEBUG)
    DEBUG.nans, DEBUG.sync = nans, disable_jit
    try:
        yield DEBUG
    finally:
        DEBUG.nans, DEBUG.sync = prev.nans, prev.sync


def check_launch(frame0, n_frames: int, outputs: dict, row0: int = 0) -> None:
    """After a launch of frames ``frame0 .. frame0 + n_frames - 1``:
    synchronise its device under ``debug_mode(disable_jit=True)``, and
    under ``debug_mode(nans=True)`` raise FloatingPointError at the first
    non-finite value of ``outputs`` (name -> (H, W, 3) tensor), naming the
    frames and the pixel: row ``y`` (row 0 the bottom; ``row0`` is a band's
    first row) and column ``x``."""
    if not (DEBUG.nans or DEBUG.sync):
        return
    if DEBUG.sync:
        for t in outputs.values():
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
    if not DEBUG.nans:
        return
    for name, t in outputs.items():
        bad = ~torch.isfinite(t)
        if bool(bad.any()):
            first = int(torch.nonzero(bad.reshape(-1))[0])
            _, w, ch = t.shape
            y, rest = divmod(first, w * ch)
            x, c = divmod(rest, ch)
            f0 = int(frame0)
            frames = (f"frame {f0}" if n_frames == 1 else
                      f"frames {f0}-{f0 + n_frames - 1} (one launch)")
            raise FloatingPointError(
                f"debug_mode: non-finite {name} ({t[y, x, c].item()}) at "
                f"pixel y={y + row0}, x={x} (channel {c}) of {frames}; "
                f"{int(bad.sum())} non-finite values in all"
            )


def annotate(name: str):
    """Named profiler span for host-side phases."""
    return torch.profiler.record_function(name)

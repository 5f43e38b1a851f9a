"""Tracing and debugging hooks.

Counterpart of ``ray_tracing_extended_tpu/utils/profiling.py``:
``trace(logdir)`` records a region with ``torch.profiler`` (CPU and, where
there is a card, CUDA activity) and writes a Chrome trace into ``logdir``
(the CLI's ``--profile``); ``annotate(name)`` is a named span inside it;
``debug_mode()`` checks every launch's outputs for NaN and Inf, and can
synchronise after each launch (``check_launch``, called by ``render.py``
and ``progressive.py``).

The program's spans, opened through ``annotate`` at its layers'
boundaries, are named ``<layer>.<part>`` by the constants below. A span
is a ``torch.profiler.record_function`` while a profiler records, so it
lands in the Chrome trace as a ``user_annotation`` event on the clock of
the card's kernels and copies; with no profiler running ``annotate``
returns one shared context that does nothing (about a tenth of a
``record_function``'s cost). A span never synchronises the device and
reads nothing back. Spans nest by time on the host thread; a frame's (or
a K-frame chunk's) spans lie inside its ``driver.step``:

- ``driver.resume``: a ``render_progressive`` call's checkpoint
  fingerprint, load and copy to the device (with a checkpoint path);
- ``driver.step``: one frame, chunk or mesh step of its loop, from the
  loop's top through its metrics line and checkpoint;
- ``driver.fold``: a per-frame step's fold into the average, its launch
  check and the running variance's update;
- ``driver.wait``: the read of the step's segment count, which waits for
  its device work;
- ``driver.stats``: with a metrics logger, a frame's bounce histogram and
  variance read back (two more waits) and the line's extras;
- ``driver.log``: the metrics line;
- ``driver.checkpoint``: a checkpoint written;
- ``wrapper.launch``: ``render_frames_mega``'s dispatch, the host side of
  a launch (the plain version's whole render on the CPU), one a band;
- ``wrapper.tables``: the launch's tables looked up (the camera's and the
  environment's parameters, the visit order);
- ``wrapper.table_build``, ``wrapper.visit_build``: a scene's tables, and
  a camera's visit order, built on a cache miss;
- ``refill.phase1``, ``refill.lane_pass``, ``refill.phase2``: the launches
  of an adaptive-refill call on the card (the lane pass only with more
  than one pixel a lane), so that a trace tells refill's two
  ``render_adaptive`` launches apart;
- ``scene.bvh_build``: one LBVH build in ``SceneBuilder.build`` (the
  tree it gave is in ``accel/bvh.LBVH_BUILDS``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import torch

DRIVER_RESUME = "driver.resume"
DRIVER_STEP = "driver.step"
DRIVER_FOLD = "driver.fold"
DRIVER_WAIT = "driver.wait"
DRIVER_STATS = "driver.stats"
DRIVER_LOG = "driver.log"
DRIVER_CHECKPOINT = "driver.checkpoint"
WRAPPER_LAUNCH = "wrapper.launch"
WRAPPER_TABLES = "wrapper.tables"
WRAPPER_TABLE_BUILD = "wrapper.table_build"
WRAPPER_VISIT_BUILD = "wrapper.visit_build"
REFILL_PHASE1 = "refill.phase1"
REFILL_LANE_PASS = "refill.lane_pass"
REFILL_PHASE2 = "refill.phase2"
SCENE_BVH_BUILD = "scene.bvh_build"
SPANS = (DRIVER_RESUME, DRIVER_STEP, DRIVER_FOLD, DRIVER_WAIT, DRIVER_STATS,
         DRIVER_LOG, DRIVER_CHECKPOINT, WRAPPER_LAUNCH, WRAPPER_TABLES,
         WRAPPER_TABLE_BUILD, WRAPPER_VISIT_BUILD, REFILL_PHASE1,
         REFILL_LANE_PASS, REFILL_PHASE2, SCENE_BVH_BUILD)

# what ``annotate`` returns while no profiler records
NO_SPAN = contextlib.nullcontext()


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
    """A named span (one of ``SPANS``): ``with annotate(DRIVER_STEP): ...``.
    A ``torch.profiler.record_function`` while a profiler records, else
    ``NO_SPAN``."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return NO_SPAN

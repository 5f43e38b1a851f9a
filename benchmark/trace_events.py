"""Reads a ``torch.profiler`` Chrome trace of the benchmark's window.

``load`` keeps the device operations (kernels, copies, sets), the host's
operations and the window's span (``benchmark.window``, opened before the
call and closed at its last metrics line). The helpers measure on the
device's timeline inside that span: the union of the operations (busy
time), the render kernels by name, and the gaps between operations, each
named by what the host was doing when it began.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "benchmark.window"
# the port's render kernels (csrc/megakernel.cu): phase 1 and the exact
# path, refill's phase 2 over a lane list, and the lane pass
RENDER = re.compile(r"\b(render_kernel|render_adaptive|render_listed|"
                    r"refill_lanes)\b")


def load(path) -> dict:
    """-> ``{"device": [(start, end, name)], "host": [(start, end, name)],
    "window": (start, end)}``, times in microseconds, device operations
    sorted by start."""
    data = json.loads(Path(path).read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    device, host, window = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        start = float(e["ts"])
        end = start + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((start, end, e.get("name", "")))
        elif cat in HOST_CATS:
            if cat == "user_annotation" and e.get("name") == WINDOW:
                window = (start, end)
            else:
                host.append((start, end, e.get("name", "")))
    device.sort()
    return {"device": device, "host": host, "window": window}


def _clip(events, window):
    lo, hi = window
    return [(max(s, lo), min(e, hi), n) for s, e, n in events
            if e > lo and s < hi]


def union(intervals) -> list:
    """Merged (start, end) of sorted intervals."""
    out = []
    for s, e, *_ in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy(data) -> tuple[float, float]:
    """-> (seconds the device ran an operation inside the window, the
    window's seconds)."""
    if data["window"] is None:
        return 0.0, 0.0
    merged = union(_clip(data["device"], data["window"]))
    lo, hi = data["window"]
    return sum(e - s for s, e in merged) / 1e6, (hi - lo) / 1e6


def render_kernels(data) -> list:
    """The render kernels' (start, end, name) inside the window."""
    if data["window"] is None:
        return []
    return [ev for ev in _clip(data["device"], data["window"])
            if RENDER.search(ev[2])]


def _short(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."


def breakdown(data, top: int = 10) -> dict:
    """The device operations that took most time inside the window, and
    its longest idle gaps, each named by the innermost host operation
    running when it began."""
    if data["window"] is None:
        return {"device_ops": [], "idle_gaps": []}
    ops = {}
    for s, e, n in _clip(data["device"], data["window"]):
        ops[n] = ops.get(n, 0.0) + (e - s) / 1e6
    device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = data["window"]
    merged = union(_clip(data["device"], data["window"]))
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    named = []
    for length, start in gaps:
        inner = None
        for s, e, n in data["host"]:
            if s <= start < e and (inner is None or s >= inner[0]):
                inner = (s, n)
        named.append([_short(inner[1]) if inner else "host (no operation)",
                      length / 1e6])
    return {"device_ops": [[_short(n), v] for n, v in device_ops],
            "idle_gaps": named}

"""``frame_ms_p95``: the 95th percentile (nearest rank) of every frame
interval in the window, on the benchmark's clock: from the call's start
to the first metrics line, then between consecutive lines, each divided
by the frames of its line."""

import math


def intervals_ms(t0, stamps, batched):
    edges = [t0] + list(stamps)
    return [(b - a) * 1e3 / k for a, b, k in zip(edges, edges[1:], batched)]


def percentile(values, q):
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def read(ctx):
    ms = intervals_ms(ctx["t0"], ctx["stamps"], ctx["batched"])
    return percentile(ms, 0.95) if ms else None

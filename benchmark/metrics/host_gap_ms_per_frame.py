"""``host_gap_ms_per_frame``: the traced window less the render kernels'
device time, over its frames: the mean of each frame's interval less its
kernel's time, the host's share of a viewer's frame."""

import trace_events


def read(ctx):
    if ctx["trace"] is None or ctx["trace"]["window"] is None:
        return None
    kernels = trace_events.render_kernels(ctx["trace"])
    if not kernels:
        return None
    lo, hi = ctx["trace"]["window"]
    kernel_us = sum(e - s for s, e, _ in kernels)
    return (hi - lo - kernel_us) / 1e3 / ctx["frames"]

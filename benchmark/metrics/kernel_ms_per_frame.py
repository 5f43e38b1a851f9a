"""``kernel_ms_per_frame``: the device time of the render kernels
(``render_kernel``, ``render_adaptive``, ``render_listed``,
``refill_lanes``) in the traced window, over its frames."""

import trace_events


def read(ctx):
    if ctx["trace"] is None:
        return None
    kernels = trace_events.render_kernels(ctx["trace"])
    if not kernels:
        return None
    return sum(e - s for s, e, _ in kernels) / 1e3 / ctx["frames"]

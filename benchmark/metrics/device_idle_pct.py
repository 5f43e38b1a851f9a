"""``device_idle_pct``: the share of the traced window in which no
operation ran on the card (the union of kernels, copies and sets from the
``torch.profiler`` trace), in percent."""

import trace_events


def read(ctx):
    if ctx["trace"] is None:
        return None
    busy, window = trace_events.busy(ctx["trace"])
    if busy <= 0.0 or window <= 0.0:
        return None
    return 100.0 * (1.0 - busy / window)

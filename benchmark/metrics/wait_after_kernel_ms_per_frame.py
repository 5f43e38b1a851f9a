"""``wait_after_kernel_ms_per_frame``: the host held in the program's
``driver.wait`` spans (the read of a step's segment count) after the
step's render kernel has ended, inside the traced window, over its frames.

The spans and the kernels lie on one clock in the trace. For each wait
[s, e], k is the latest end of a render kernel at or before e, and the
wait counts e - max(s, k): the fold's device operations, the count's copy
and the sync's return, which the host waits for behind the kernel."""

import bisect

import trace_events

SPAN = "driver.wait"


def read(ctx):
    data = ctx["trace"]
    if data is None:
        return None
    ends = sorted(e for _, e, _ in trace_events.render_kernels(data))
    if not ends:
        return None
    waits = [(s, e) for s, e, n in trace_events._clip(data["host"],
                                                      data["window"])
             if n == SPAN]
    if not waits:
        return None
    total = 0.0
    for s, e in waits:
        i = bisect.bisect_right(ends, e)
        k = ends[i - 1] if i else s
        total += e - max(s, k)
    return total / 1e3 / ctx["frames"]

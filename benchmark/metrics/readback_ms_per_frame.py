"""``readback_ms_per_frame``: the host's time reading a frame's statistics
back, the program's ``driver.stats`` spans (the bounce histogram's copy,
the running variance's mean and the metrics line's extras, two waits on
the card) inside the traced window, over its frames."""

import trace_events

SPAN = "driver.stats"


def read(ctx):
    data = ctx["trace"]
    # a trace without the card's render kernels has no frame to split
    if data is None or not trace_events.render_kernels(data):
        return None
    spans = [(s, e) for s, e, n in trace_events._clip(data["host"],
                                                      data["window"])
             if n == SPAN]
    if not spans:
        return None
    return sum(e - s for s, e in spans) / 1e3 / ctx["frames"]

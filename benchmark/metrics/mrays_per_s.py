"""``mrays_per_s``: the live path segments of every frame in the window
(the kernel's own counters, as the metrics lines carry them) over the
window's seconds, in millions."""


def read(ctx):
    return ctx["segments"] / ctx["window_s"] / 1e6

"""``megakernel_roofline``: the least time the render kernels' work needs
on the card, over their device time in the traced window, in percent.

The work is the closest-hit work the window's rays need: the reference
counts, on its stratified sample of (pixel, frame) pairs, the FP32
operations each segment's closest hit takes under an exact scan gated by
boxes with the final distance as its bound (``reference.ops_per_segment``:
16 a sphere, 12 a box, 34 a triangle), and the mean times the window's
segments is the total. The bytes are each launch's image written once,
its accumulator read once with more than one frame a launch, and its scene
read once. The least time is the larger of operations over the card's
published FP32 rate and bytes over its memory bandwidth (``peaks.json``).
"""

import json

import trace_events


def read(ctx):
    if ctx["trace"] is None or not ctx["counts"]["segments"]:
        return None
    kernels = trace_events.render_kernels(ctx["trace"])
    if not kernels:
        return None
    peaks = json.loads((ctx["root"] / "peaks.json").read_text())
    ops = ctx["counts"]["ops"] / ctx["counts"]["segments"] * ctx["segments"]
    cfg, batch = ctx["cfg"], ctx["batch"]
    launches = -(-ctx["frames"] // batch)
    per_launch = cfg.width * cfg.height * 12 * (2 if batch > 1 else 1)
    nbytes = launches * (per_launch + ctx["scene_bytes"])
    least = max(ops / peaks["fp32_flops"], nbytes / peaks["hbm_bytes_per_s"])
    kernel_s = sum(e - s for s, e, _ in kernels) / 1e6
    return 100.0 * least / kernel_s

"""``bvh_roofline``: the least time of the window's closest-hit work on the
card, over the render kernels' device time in the traced window, in
percent, where the work is counted through a fixed BVH
(``bvh_yardstick.py``) and not the program's own tree.

The reference traces ``PAIRS`` (pixel, frame) pairs drawn at random with
the yardstick as its ``ops_per_segment`` (12 FP32 operations the root's
box, 24 each internal node entered within the segment's final distance, 34
each triangle of each leaf entered); the mean a segment times the window's
segments is the work. The bytes, the card's peaks and the least time follow
``megakernel_roofline``: each launch's image written once, its accumulator
read once with more than one frame a launch, and its scene read once;
operations over the published FP32 rate or bytes over the memory bandwidth
(``peaks.json``), whichever is larger.
"""

import json

import numpy as np
import torch

import bvh_yardstick
import reference
import trace_events

PAIRS = 1 << 14
SEED = 20260816  # the sample's pairs; the work is the same from seed to seed
PAIR_ELEMENTS = 1 << 25  # elements of the reference's largest temporary


def mean_ops(ctx, device) -> float:
    """The yardstick's mean work a segment over the cell's scene."""
    sc = ctx["cell"]["config"]["scene"]
    scene, cam, _ = reference.json_scene(ctx["root"] / sc["file"])
    cfg = ctx["cfg"]
    tracer = bvh_yardstick.YardstickTracer(
        scene, cam, cfg.width, cfg.height, cfg.max_bounce, cfg.spp, device,
        clamp=ctx["cell"]["config"]["render"]["saturate"])
    rng = np.random.default_rng(SEED)
    pix = torch.as_tensor(rng.integers(0, cfg.width * cfg.height, PAIRS))
    frame = torch.as_tensor(rng.integers(1, 1 << 16, PAIRS))
    counts = {"ops": 0.0, "segments": 0}
    block = max(256, PAIR_ELEMENTS // max(len(scene.tri_pos), 1))
    tracer.render_lanes(pix, frame, block, counts)
    return counts["ops"] / max(counts["segments"], 1)


def read(ctx):
    if ctx["trace"] is None or not ctx["segments"]:
        return None
    kernels = trace_events.render_kernels(ctx["trace"])
    if not kernels:
        return None
    peaks = json.loads((ctx["root"] / "peaks.json").read_text())
    device = "cuda" if torch.cuda.is_available() else "cpu"
    ops = mean_ops(ctx, device) * ctx["segments"]
    cfg, batch = ctx["cfg"], ctx["batch"]
    launches = -(-ctx["frames"] // batch)
    per_launch = cfg.width * cfg.height * 12 * (2 if batch > 1 else 1)
    nbytes = launches * (per_launch + ctx["scene_bytes"])
    least = max(ops / peaks["fp32_flops"], nbytes / peaks["hbm_bytes_per_s"])
    kernel_s = sum(e - s for s, e, _ in kernels) / 1e6
    return 100.0 * least / kernel_s

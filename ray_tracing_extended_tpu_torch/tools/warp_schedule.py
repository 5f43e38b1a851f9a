"""The exact kernel's warp schedules, counted on the plain version.

``kernels.megakernel.warp_schedule_counts`` over a band of whole warp rows
and one launch's frames: the loop over samples and bounces, the slot loop
with one warp a tile, the slot loop of resident warps that take their
tiles from a queue, and the slot loop of the kernel's blocks, whose warps
test a sphere cluster on the block's rays that entered it. Prints one JSON
line: each schedule's slots, live lanes a slot and scan steps, and the
ratios between them (segment maps left out). The queue runs on
``--resident-warps`` warps, or on the card by default on the band's share
of the warps a resident grid of the instantiation holds there
(``PathTraceKernel.resident_warps``)::

    python -m ray_tracing_extended_tpu_torch.tools.warp_schedule \\
        --device cpu --rows 528 544 --frame 1 --frames 4 --resident-warps 55
    python -m ray_tracing_extended_tpu_torch.tools.warp_schedule \\
        --scene scenes/chess.json --rows 352 368 --frame 1 --frames 4

With ``--refill PPL PHASES`` it counts a refill frame's launches instead
(``kernels.megakernel.refill_warp_counts``): the whole frame under those
lane knobs (``--paired``: its lanes paired by the default refill's segment
map of the same frame, as ``render_progressive`` pairs each batch by the
last), phase 1's warp-slots, and phase 2's over the band's grid and over
the lane pass's list, each with its live share::

    python -m ray_tracing_extended_tpu_torch.tools.warp_schedule \
        --device cpu --refill 2 1 --paired --width 256 --height 128 \
        --tile-size 64 --frames 1

The counts are the same on any device; only the plain version's speed is
not.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def main(argv=None) -> int:
    from ..kernels import megakernel as mk
    from ..utils.device import resolve_device
    from .profile_mega import load

    p = argparse.ArgumentParser(prog="warp_schedule",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--scene", default="preset:rtiow")
    p.add_argument("--rows", type=int, nargs=2, default=(528, 544))
    p.add_argument("--frame", type=int, default=1)
    p.add_argument("--frames", type=int, default=4, help="frames a launch (K)")
    p.add_argument("--resident-warps", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--refill", type=int, nargs=2, default=None,
                   metavar=("PPL", "PHASES"),
                   help="count a refill frame under these lane knobs")
    p.add_argument("--paired", action="store_true",
                   help="with --refill: pair each lane's pixels by cost")
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--spp", type=int)
    p.add_argument("--tile-size", type=int, help="the refill tile's side")
    args = p.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    scene, cam, cfg = load(args.scene, dev, width=args.width,
                           height=args.height, spp=args.spp,
                           mega_tile_size=args.tile_size)
    if args.refill:
        return refill_counts(args, scene, cam, cfg)
    rows = tuple(args.rows)
    warps = args.resident_warps
    if warps is None:
        if dev.type != "cuda":
            raise SystemExit("--resident-warps: no card to read the grid from")
        warps = mk.band_resident_warps(
            mk.KERNEL.resident_warps(scene, cfg), cfg, rows)
    t0 = time.perf_counter()
    out = mk.warp_schedule_counts(scene, cam, cfg, rows=rows,
                                  frame=args.frame, n_frames=args.frames,
                                  resident_warps=warps)
    for name in (*mk.SCHEDULES, mk.BLOCK_SCHEDULE):
        out[name].pop("segment_map")
    print(json.dumps(dict(
        scene=args.scene, width=cfg.width, height=cfg.height, spp=cfg.spp,
        max_bounce=cfg.max_bounce, rows=list(rows), frame=args.frame,
        frames=args.frames, seconds=time.perf_counter() - t0, **out)),
          flush=True)
    return 0


def refill_counts(args, scene, cam, cfg) -> int:
    """``--refill``: one K-frame refill launch of the whole frame (from a
    zero accumulator with more than one frame), its warps counted."""
    import torch

    from ..kernels import megakernel as mk

    ppl, phases = args.refill
    ad = dataclasses.replace(cfg, adaptive_spp=True)
    knobbed = dataclasses.replace(ad, mega_pixels_per_lane=ppl,
                                  mega_phases=phases)
    acc = None
    if args.frames > 1:
        acc = torch.zeros((cfg.height, cfg.width, 3), device=scene.device)
    t0 = time.perf_counter()
    costs = None
    if args.paired:
        costs = mk.render_frames_mega(scene, cam, ad, args.frame, args.frames,
                                      accum=acc)[2]
    one = {}
    segs = mk.render_frames_mega(scene, cam, knobbed, args.frame, args.frames,
                                 accum=acc, phase_one=one,
                                 pair_costs=costs)[2]
    counts = mk.refill_warp_counts(one["segs"], segs, one.get("lane_list"))
    if "phase_2_list" in counts:
        counts["list_over_grid"] = (counts["phase_2_list"]["warp_slots"]
                                    / max(counts["phase_2"]["warp_slots"], 1))
    print(json.dumps(dict(
        scene=args.scene, width=cfg.width, height=cfg.height, spp=cfg.spp,
        max_bounce=cfg.max_bounce, tile=mk.refill_tile_size(scene, knobbed),
        pixels_per_lane=ppl, phases=phases, paired=args.paired,
        frame=args.frame, frames=args.frames,
        seconds=time.perf_counter() - t0, **counts)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

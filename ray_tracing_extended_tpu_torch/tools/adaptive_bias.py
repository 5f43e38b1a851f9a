"""Adaptive-spp estimator bias: a paired measurement.

Counterpart of the repo's ``tools/adaptive_bias.py``, with the same steps
and output keys. For each frame f it renders the same frame with exact spp
and with refill (``adaptive_spp``). The two share their random streams: a
pixel's first ``spp`` samples are draw for draw the same, so the frame's
image-mean delta d_f = mean(refill_f) - mean(exact_f) is what the refill
samples add. An unbiased refill would give E[d_f] = 0; stopping a pixel's
sampling when its group is done is expected to favour short paths a
little. Reports mean(d_f) with its t-statistic over F frames, and the
relative bias mean(d) / mean(exact) with its 95% CI.

The port's refill groups pixels by the TPU kernel's tiles
(``kernels/megakernel.refill_tile_size``: 128 x 128 on both scenes) and
lanes (``--pixels-per-lane``, ``--phases``: the config's
``mega_pixels_per_lane`` and ``mega_phases``, 1 by default), as the JAX
package does; ``against_reference`` sets a scene's line beside the
reference's interval, measured by the JAX tool on a TPU v5e
(``ray_tracing_extended_tpu/utils/config.py:50-53``). Runs on the card by
default; on the CPU (the plain version's two phases over the same tiles)
at small sizes::

    python -m ray_tracing_extended_tpu_torch.tools.adaptive_bias
    python -m ray_tracing_extended_tpu_torch.tools.adaptive_bias \\
        --pixels-per-lane 2
    python -m ray_tracing_extended_tpu_torch.tools.adaptive_bias \\
        --device cpu --width 32 --height 24 --frames 4 --phases 2

Prints one JSON line a step: ``init`` (the device), one a scene (RTIOW
480x270, 4 bounces, 16 spp; Cornell 256x256, 8 bounces, 16 spp, unless
``--width``/``--height``/``--spp`` say otherwise; refill on the tiles of
``--tile-size`` and under ``--pixels-per-lane`` and ``--phases`` where
given; the lines' keys are the JAX tool's), ``done``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch


# The reference's relative bias and 95% half-width, its tools/adaptive_bias.py
# on a TPU v5e (its utils/config.py:50-53), over the same 32 frames of the
# same scenes and sizes.
REFERENCE = {"rtiow": (0.00198, 0.00013), "cornell": (-0.00048, 0.00084)}


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def run_scene(name, scene, cam, cfg, frames=32) -> dict:
    """The paired measurement over frames 1..``frames`` -> its line."""
    from ..render import render_frame_with_stats

    cfg_ad = dataclasses.replace(cfg, adaptive_spp=True)
    d, me = [], []
    t0 = time.time()
    for f in range(1, frames + 1):
        img_e, _ = render_frame_with_stats(scene, cam, cfg, f)
        img_a, _ = render_frame_with_stats(scene, cam, cfg_ad, f)
        a = float(img_a.mean())
        e = float(img_e.mean())
        d.append(a - e)
        me.append(e)
    d = np.asarray(d)
    me = np.asarray(me)
    mean_d = float(d.mean())
    se_d = float(d.std(ddof=1) / np.sqrt(len(d)))
    line = dict(
        step=name, frames=frames,
        mean_exact=float(me.mean()),
        mean_delta=mean_d, se_delta=se_d,
        t_stat=round(mean_d / max(se_d, 1e-30), 2),
        rel_bias=float(mean_d / me.mean()),
        rel_ci95=float(1.96 * se_d / me.mean()),
        wall_s=round(time.time() - t0, 1),
    )
    emit(**line)
    return line


def against_reference(line: dict) -> dict:
    """A scene's line (``run_scene``) beside the reference's interval
    (``REFERENCE``): both, whether the two 95% intervals overlap, and
    whether this one holds 0."""
    ref, half = REFERENCE[line["step"]]
    return dict(rel_bias=line["rel_bias"], rel_ci95=line["rel_ci95"],
                reference_rel_bias=ref, reference_rel_ci95=half,
                overlaps_reference=abs(line["rel_bias"] - ref)
                <= line["rel_ci95"] + half,
                contains_zero=abs(line["rel_bias"]) <= line["rel_ci95"])


def main(argv=None) -> int:
    from ..models.presets import cornell_box_scene, rtiow_final_scene
    from ..utils.device import resolve_device

    p = argparse.ArgumentParser(prog="adaptive_bias")
    p.add_argument("--device", default="cuda")
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--width", type=int, help="both scenes' width")
    p.add_argument("--height", type=int, help="both scenes' height")
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--tile-size", type=int,
                   help="the refill tile's side (mega_tile_size), for how "
                   "the bias follows the group")
    p.add_argument("--pixels-per-lane", type=int, choices=(1, 2, 4, 8),
                   help="a refill lane's pixels (mega_pixels_per_lane)")
    p.add_argument("--phases", type=int, choices=(1, 2),
                   help="refill's slot phases (mega_phases)")
    args = p.parse_args(argv)
    if args.frames < 2:
        raise SystemExit("--frames must be at least 2 (a standard error)")
    dev = resolve_device(args.device)

    def size(w, h):
        return dict(width=args.width or w, height=args.height or h)

    t0 = time.time()
    emit(step="init", device=torch.cuda.get_device_name(dev)
         if dev.type == "cuda" else str(dev))
    for name, make, w, h, mb in (("rtiow", rtiow_final_scene, 480, 270, 4),
                                 ("cornell", cornell_box_scene, 256, 256, 8)):
        scene, cam, cfg = make(**size(w, h), max_bounce=mb, spp=args.spp,
                               device=dev)
        cfg = dataclasses.replace(cfg, mega_tile_size=args.tile_size,
                                  mega_pixels_per_lane=args.pixels_per_lane,
                                  mega_phases=args.phases)
        run_scene(name, scene, cam, cfg, args.frames)
    emit(step="done", total_wall_s=round(time.time() - t0, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

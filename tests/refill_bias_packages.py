"""Refill's bias in both packages on the CPU: the JAX kernel (interpret
mode) against the port's plain version, frame by frame.

For each frame f it renders RTIOW with exact spp and with refill
(``adaptive_spp``) in each package and takes the image-mean delta d_f =
mean(refill_f) - mean(exact_f), paired as ``tools/adaptive_bias.py`` pairs
them. Prints one JSON line a frame (both packages' deltas and their
difference) and a summary: each package's relative bias mean(d) /
mean(exact) with its 95% interval over the frames, and the per-frame
difference of the two deltas (port minus JAX), its mean and standard
error. The refill tile is ``--tile-size`` on both sides (the config's
``mega_tile_size``; ``RTX_MEGA_TS`` is unset here), the lane knobs
``--pixels-per-lane`` and ``--phases`` (``mega_pixels_per_lane``,
``mega_phases``). Imports both packages, as the tests do; one intra-op
torch thread::

    JAX_PLATFORMS=cpu python tests/refill_bias_packages.py \\
        --width 160 --height 90 --frames 16 --tile-size 32 \\
        --pixels-per-lane 2 --phases 1
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import sys
import time

os.environ.pop("RTX_MEGA_TS", None)
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from ray_tracing_extended_tpu.kernels.megakernel import (  # noqa: E402
    render_frame_mega,
)
from ray_tracing_extended_tpu.models import presets as jpresets  # noqa: E402
from ray_tracing_extended_tpu_torch.interop import (  # noqa: E402
    camera_from_arrays,
    scene_from_arrays,
)
from ray_tracing_extended_tpu_torch.kernels import (  # noqa: E402
    megakernel as tmk,
)


def summary(d: np.ndarray, exact: np.ndarray) -> dict:
    se = float(d.std(ddof=1) / np.sqrt(len(d)))
    return dict(mean_delta=float(d.mean()), se_delta=se,
                rel_bias=float(d.mean() / exact.mean()),
                rel_ci95=float(1.96 * se / exact.mean()))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="refill_bias_packages")
    p.add_argument("--width", type=int, default=160)
    p.add_argument("--height", type=int, default=90)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--max-bounce", type=int, default=4)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--tile-size", type=int, default=32)
    p.add_argument("--pixels-per-lane", type=int, default=1)
    p.add_argument("--phases", type=int, default=1)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    js, jc, cfg = jpresets.rtiow_final_scene(
        width=args.width, height=args.height, spp=args.spp,
        max_bounce=args.max_bounce)
    cfg = dataclasses.replace(cfg, mega_tile_size=args.tile_size,
                              mega_pixels_per_lane=args.pixels_per_lane,
                              mega_phases=args.phases)
    ad = dataclasses.replace(cfg, adaptive_spp=True)
    scene = scene_from_arrays(js, device="cpu")
    cam = camera_from_arrays(jc, device="cpu")
    setting = dict(width=args.width, height=args.height, spp=args.spp,
                   max_bounce=args.max_bounce, tile_size=args.tile_size,
                   pixels_per_lane=args.pixels_per_lane, phases=args.phases)
    print(json.dumps(dict(step="init", **setting)), flush=True)
    rows = []
    t0 = time.time()
    for f in range(1, args.frames + 1):
        means = {}
        for tag, c in (("exact", cfg), ("refill", ad)):
            means[f"jax_{tag}"] = float(np.asarray(render_frame_mega(
                js, jc, c, jnp.uint32(f), interpret=True)[0]).mean())
            means[f"port_{tag}"] = float(tmk.render_frames_plain(
                scene, cam, c, f)[0].mean())
        row = dict(frame=f, **means,
                   jax_delta=means["jax_refill"] - means["jax_exact"],
                   port_delta=means["port_refill"] - means["port_exact"])
        row["port_minus_jax"] = row["port_delta"] - row["jax_delta"]
        rows.append(row)
        print(json.dumps(dict(step="frame", **row,
                              wall_s=round(time.time() - t0, 1))), flush=True)
    col = {k: np.asarray([r[k] for r in rows]) for k in rows[0]}
    diff = col["port_minus_jax"]
    print(json.dumps(dict(
        step="summary", **setting, frames=args.frames,
        jax=summary(col["jax_delta"], col["jax_exact"]),
        port=summary(col["port_delta"], col["port_exact"]),
        port_minus_jax=dict(mean=float(diff.mean()),
                            se=float(diff.std(ddof=1) / np.sqrt(len(diff)))),
        delta_range=[float(min(col["jax_delta"].min(), col["port_delta"].min())),
                     float(max(col["jax_delta"].max(),
                               col["port_delta"].max()))],
        wall_s=round(time.time() - t0, 1))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

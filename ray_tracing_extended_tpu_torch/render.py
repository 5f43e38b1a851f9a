"""Frame rendering entry points (RayTracingManager.OnRenderImage).

Mirrors ``ray_tracing_extended_tpu/render.py``: the same public functions
with the same signatures and return shapes (``render_block``, the plain
path's pixel-block step, lives beside the kernel it mirrors). Row 0 of an image is the
BOTTOM and the pixel index is ``y * width + x``. Segment totals are int64
0-d tensors (the JAX package returns uint32).

The scene's device picks the path: on the CPU the plain PyTorch path
(``ops/`` and ``accel/bvh.py``, the counterpart of the JAX package's XLA
path, and for ``adaptive_spp`` of the TPU kernel's slot machine), on a
CUDA device the hand-written kernel (``kernels/megakernel.py``), in
exact-spp, adaptive-refill (``cfg.adaptive_spp``) and fast-scatter
(``cfg.fast_scatter``) modes, with its scene tables staged in each block's
shared memory, or, for a scene whose tables pass it (``MAX_SHARED_BYTES``,
about 9,000 spheres), read in place from global memory: the same
arithmetic and the same image (``table_route``). Nothing falls back to
the plain path on the card. ``cfg.intersector``
keeps the JAX package's meaning: ``"auto"`` and ``"bvh"`` traverse the
BVHs a scene has, ``"bruteforce"`` scans, ``"mega"`` takes the kernel's
choice (``kernels/megakernel.py`` ``plain_intersector`` on the CPU,
``geometry`` on the card, which traverses a triangle BVH and always scans
spheres). Scenes load from JSON files with
``scene.json_scene.load_json_scene``; ``progressive.render_progressive``
drives these functions frame after frame. Inside
``utils.profiling.debug_mode`` each call checks what its launch wrote.
"""

from __future__ import annotations

import torch

from .kernels.megakernel import render_block, render_frames_mega
from .models.geometry import Scene
from .ops.camera import Camera
from .utils.config import RenderConfig
from .utils.profiling import check_launch

__all__ = [
    "render_and_accumulate",
    "render_block",
    "render_frame",
    "render_frame_with_stats",
    "render_frames_and_accumulate",
]


def _check_supported(cfg: RenderConfig) -> None:
    if cfg.intersector not in ("auto", "bruteforce", "mega", "bvh"):
        raise ValueError(f"unknown intersector {cfg.intersector!r}")


def render_frame_with_stats(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    frame,
    bounce_stats: bool = False,
):
    """Render one frame -> ``((H, W, 3) f32 linear radiance, total live ray
    segments)``, the Mrays/s numerator. With ``bounce_stats`` a third
    element holds the (max_bounce + 1,) int32 live-path counts per bounce
    index. On CUDA, and with ``adaptive_spp``, the counts cover real pixels
    only; the plain exact-spp path, like the JAX package's XLA path, also
    counts its padding lanes."""
    _check_supported(cfg)
    img, segs, _, hist = render_frames_mega(
        scene, camera, cfg, frame, collect_stats=bounce_stats
    )
    check_launch(frame, 1, {"image": img})
    if bounce_stats:
        return img, segs, hist
    return img, segs


def render_frame(scene: Scene, camera: Camera, cfg: RenderConfig, frame):
    """Render one frame -> (H, W, 3) f32 linear radiance."""
    img, _ = render_frame_with_stats(scene, camera, cfg, frame)
    return img


def render_frames_and_accumulate(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    accum: torch.Tensor,
    frame0,
    n_frames: int = 1,
    pair_costs=None,
    segs_map: bool = False,
):
    """``n_frames`` progressive steps -> ``(accum', total segments)``, plus
    the (H, W) int32 per-pixel segment counts when ``segs_map`` (real
    counts on both paths; the JAX package's XLA path returns zeros there).

    Frame ``frame0 + k`` folds into the running average with weight
    ``1 / (frame0 + k + 1)``, clamped per ``cfg.clamp_accumulate``. On CUDA
    all frames are one kernel launch. ``pair_costs``, an (H, W) cost map (a
    previous call's ``segs_map``), pairs a refill lane's pixels by cost
    where a lane has more than one (``cfg.mega_pixels_per_lane``), as on
    the TPU; under exact spp it only reorders lanes there, and the image is
    the same for any cost map, so it is not read."""
    _check_supported(cfg)
    img, segs, seg_map, _ = render_frames_mega(
        scene, camera, cfg, frame0, n_frames, accum=accum,
        pair_costs=pair_costs,
    )
    check_launch(frame0, n_frames, {"accumulator": img})
    if segs_map:
        return img, segs, seg_map
    return img, segs


def render_and_accumulate(
    scene: Scene, camera: Camera, cfg: RenderConfig, accum, frame
):
    """One progressive step: render frame ``frame`` and fold it into the
    running average (RayTracingManager.cs:69-84)."""
    return render_frames_and_accumulate(scene, camera, cfg, accum, frame)[0]

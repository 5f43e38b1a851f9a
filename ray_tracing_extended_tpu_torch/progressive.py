"""Progressive multi-frame renderer: the frame loop of the reference's
OnRenderImage (RayTracingManager.cs:49-93) with checkpoint/resume and
metrics.

Counterpart of ``ray_tracing_extended_tpu/progressive.py``
(``render_progressive``). Per frame (or per fused chunk of ``batch``
frames): render on the scene's device, or over a mesh of devices
(``parallel/sharding.py``), fold into the running average with the
reference's 1/(frame + 1) weight, optionally checkpoint (atomically) and
emit one JSONL metrics line. The host waits for the device when it reads
a frame's or chunk's segment count; with a metrics logger a single frame
waits twice more, to read back its bounce histogram and its running
variance. Under a profiler each step's parts are named spans
(``utils/profiling.py``).
"""

from __future__ import annotations

import hashlib
import os
import time

import torch

from .models.geometry import Scene
from .ops.accumulate import accumulate
from .ops.camera import Camera
from .parallel import sharding
from .render import render_frame_with_stats, render_frames_and_accumulate
from .utils import checkpoint as ckpt
from .utils.config import RenderConfig
from .utils.metrics import FrameMetrics, MetricsLogger
from .utils.profiling import (
    DRIVER_CHECKPOINT,
    DRIVER_FOLD,
    DRIVER_LOG,
    DRIVER_RESUME,
    DRIVER_STATS,
    DRIVER_STEP,
    DRIVER_WAIT,
    annotate,
    check_launch,
)


def _layout(scene: Scene):
    """(shape, dtype) of each of a scene's arrays, in field order."""
    return [(tuple(t.shape), t.dtype) for t in ckpt.tree_leaves(scene)]


def _same_cam(a: Camera, b: Camera) -> bool:
    pairs = zip(ckpt.tree_leaves(a), ckpt.tree_leaves(b))
    return all(torch.equal(x, y) for x, y in pairs)


def render_progressive(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    frames: int,
    checkpoint_path=None,
    checkpoint_every: int = 0,
    resume: bool = False,
    metrics: MetricsLogger | None = None,
    cameras=None,
    scenes=None,
    mesh=None,
    batch: int = 1,
    reset_on_move: bool = False,
):
    """Accumulate ``frames`` frames and return the (H, W, 3) f32 average, a
    tensor on the scene's device.

    ``batch``: frames fused per launch (static camera only), through
    ``render_frames_and_accumulate``: one kernel launch a chunk on the
    card, the same estimator and fold as the per-frame loop; one metrics
    line per chunk, without ``alive_frac`` and ``accum_var``.

    ``cameras``: an optional per-frame camera sequence (fly-throughs). Each
    frame still folds with the reference weighting, which keeps averaging
    into the previous cameras' history (the reference's ghosting).

    ``scenes``: an optional per-frame scene sequence (animation), each with
    the first's array shapes and dtypes (build them by re-posing one
    ``SceneBuilder``). Needs ``batch=1``.

    ``reset_on_move`` (needs ``cameras``): when the camera differs from the
    previous frame's, the average restarts, so the result is the average of
    the trailing run of identical cameras, folded with run-relative
    weights; on resume the run's start is found by scanning back.

    ``checkpoint_path``: write the average and the next frame index every
    ``checkpoint_every`` frames and at the end; with ``resume``, continue
    from an existing checkpoint, rendering ``frames`` more. A checkpoint of
    another scene, camera path, animation or config is refused.

    ``mesh``: a ``parallel.sharding.Mesh`` (``make_mesh``); every step
    renders over it, bands of rows over ``tiles`` and ``spp_size`` frame
    seeds over ``spp`` (``_render_progressive_sharded``), and the result
    lies on ``mesh.devices[0, 0]``. With one ``spp`` row the result is the
    single-device render's bit for bit. An ``spp`` mesh folds its frames'
    mean once a step, which is the reference's weighting only without the
    per-frame clamp: it needs HDR mode (``clamp_accumulate=False``).
    ``batch`` > 1 composes with a ``tiles``-only mesh and a static
    camera; per-frame ``scenes`` are single-device only.
    """
    if reset_on_move and cameras is None:
        raise ValueError("reset_on_move requires a cameras sequence")
    if scenes is not None:
        if mesh is not None:
            raise ValueError(
                "per-frame scenes are single-device only (the sharded path "
                "renders spp_size frame seeds of one scene a step)"
            )
        if batch > 1:
            raise ValueError(
                "batch > 1 fuses frames into one launch over a single "
                "scene; per-frame scenes need batch=1"
            )
        layout0 = _layout(scenes[0])
        for i, sc in enumerate(scenes[1:], 1):
            if _layout(sc) != layout0:
                raise ValueError(
                    f"scenes[{i}] differs in array shapes or dtypes from "
                    "scenes[0]; animated scenes must keep object counts "
                    "fixed (pad with never-hit primitives)"
                )
    if batch > 1 and cameras is not None:
        raise ValueError(
            "batch > 1 fuses frames into one launch under a single "
            "camera; per-frame cameras need batch=1"
        )
    if mesh is not None:
        if batch > 1 and mesh.shape["spp"] != 1:
            raise ValueError(
                "batch > 1 composes with the 'tiles' band split only; use "
                "an spp_parallel=1 mesh (the in-kernel K-frame fold is "
                "sequential and cannot merge across 'spp' rows)"
            )
        return _render_progressive_sharded(
            scene, camera, cfg, frames, mesh,
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every, resume=resume,
            metrics=metrics, cameras=cameras, batch=batch,
            reset_on_move=reset_on_move,
        )
    dev = (scenes[0] if scenes is not None else scene).device
    start_frame = 0
    accum = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                        device=dev)
    fingerprint = None
    if checkpoint_path is not None:
        with annotate(DRIVER_RESUME):
            # the whole camera path and animation are part of the
            # fingerprint
            fingerprint = ckpt.state_hash(
                scene, cameras if cameras is not None else camera, cfg
            )
            if scenes is not None:
                hs = hashlib.sha256()
                for sc in scenes:
                    hs.update(ckpt.hash_tree(sc).encode())
                fingerprint += ":scenes:" + hs.hexdigest()[:16]
            if reset_on_move:
                # run-relative weights are another accumulation scheme
                fingerprint += ":reset_on_move"
            if resume and os.path.exists(checkpoint_path):
                accum_np, start_frame = ckpt.load(checkpoint_path, fingerprint)
                accum = torch.from_numpy(accum_np).to(dev)
    end = start_frame + frames
    for name, seq in (("cameras", cameras), ("scenes", scenes)):
        if seq is not None and len(seq) < end:
            raise ValueError(
                f"{name} covers {len(seq)} frames; rendering frames "
                f"[{start_frame}, {end}) needs {end}"
            )

    def save(accum, frame):
        with annotate(DRIVER_CHECKPOINT):
            ckpt.save(checkpoint_path, accum, frame, fingerprint)

    if batch > 1:
        # each chunk's per-pixel counts pair the next one's refill lanes by
        # cost, as the JAX package chains them
        cmap = None
        f = start_frame
        while f < end:
            with annotate(DRIVER_STEP):
                k = min(batch, end - f)
                t0 = time.perf_counter()
                accum, segs, cmap = render_frames_and_accumulate(
                    scene, camera, cfg, accum, f, k, pair_costs=cmap,
                    segs_map=True
                )
                with annotate(DRIVER_WAIT):
                    segs = int(segs)  # one host sync per chunk
                wall = time.perf_counter() - t0
                f += k
                if metrics is not None:
                    with annotate(DRIVER_LOG):
                        metrics.log(FrameMetrics(
                            frame=f - 1, wall_s=wall, rays=segs,
                            pixels=cfg.num_pixels, spp=cfg.spp * k,
                            extra={"batched_frames": k},
                        ))
                if (checkpoint_path is not None and checkpoint_every
                        and f // checkpoint_every
                        > (f - k) // checkpoint_every):
                    save(accum, f)
        if checkpoint_path is not None:
            save(accum, end)
        return accum

    # seg0: the first frame of the current same-camera run (reset_on_move);
    # on resume, scan back so a mid-run checkpoint keeps exact weights
    seg0 = start_frame
    if reset_on_move:
        while seg0 > 0 and _same_cam(cameras[seg0 - 1], cameras[seg0]):
            seg0 -= 1

    # Welford running second moment across frames: var(mean) ~= mean(M2) /
    # (n (n - 1)), the Monte-Carlo convergence signal
    want_stats = metrics is not None
    m2 = torch.zeros_like(accum) if want_stats else None
    for f in range(start_frame, end):
        with annotate(DRIVER_STEP):
            cam = cameras[f] if cameras is not None else camera
            sc = scenes[f] if scenes is not None else scene
            if (reset_on_move and f > start_frame
                    and not _same_cam(cameras[f - 1], cam)):
                seg0 = f
                if want_stats:
                    m2 = torch.zeros_like(accum)
            t0 = time.perf_counter()
            out = render_frame_with_stats(sc, cam, cfg, f,
                                          bounce_stats=want_stats)
            cur, segs = out[0], out[1]
            with annotate(DRIVER_FOLD):
                prev = accum
                # reset_on_move folds with run-relative weights (a fresh
                # render of the run); otherwise the reference's global
                # 1/(f + 1)
                wf = (f - seg0) if reset_on_move else f
                accum = accumulate(accum, cur, wf, clamp=cfg.clamp_accumulate)
                check_launch(f, 1, {"accumulator": accum})
                # Welford step, skipped on a weight-1 restart: M2 is 0 at
                # n = 1, and the stale prev would corrupt the restarted
                # signal
                if want_stats and not (reset_on_move and f == seg0):
                    m2 = m2 + (cur - prev) * (cur - accum)
            with annotate(DRIVER_WAIT):
                segs = int(segs)  # waits for the frame
            wall = time.perf_counter() - t0
            if metrics is not None:
                with annotate(DRIVER_STATS):
                    counts = out[2].cpu().tolist()
                    paths = max(int(counts[0]), 1)
                    extra = {"alive_frac": [round(c / paths, 4)
                                            for c in counts]}
                    # frames covered by m2: since the last camera move
                    # (reset mode) or since this invocation started
                    n = ((f - max(seg0, start_frame) + 1) if reset_on_move
                         else (f - start_frame + 1))
                    if n >= 2:
                        extra["accum_var"] = float(m2.mean()) / (n * (n - 1))
                with annotate(DRIVER_LOG):
                    metrics.log(FrameMetrics(
                        frame=f, wall_s=wall, rays=segs,
                        pixels=cfg.num_pixels, spp=cfg.spp, extra=extra,
                    ))
            if (checkpoint_path is not None and checkpoint_every
                    and (f + 1) % checkpoint_every == 0):
                save(accum, f + 1)

    if checkpoint_path is not None:
        save(accum, end)
    return accum


def _render_progressive_sharded(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    frames: int,
    mesh: sharding.Mesh,
    checkpoint_path=None,
    checkpoint_every: int = 0,
    resume: bool = False,
    metrics: MetricsLogger | None = None,
    cameras=None,
    batch: int = 1,
    reset_on_move: bool = False,
):
    """The progressive driver over a mesh: step ``s`` renders the frame
    seeds ``s * spp_size .. (s + 1) * spp_size - 1`` over the mesh
    (``sharding.render_frame_mega_bands``) and folds their mean with the
    weight 1 / (s + 1), which is the flat average of every frame so far.
    The average stays in band layout on the mesh's devices; it is gathered
    for a checkpoint and at the end.

    ``frames`` counts steps and ``cameras`` holds one camera a step: a
    step's frame seeds share its camera. ``reset_on_move`` restarts the
    average at a step whose camera differs from the step before.
    Checkpoints hold the cropped image and the next step, under the JAX
    package's fingerprint, so a checkpoint of either package resumes in
    the other.

    ``batch`` > 1 (a ``tiles``-only mesh, a static camera): each chunk is
    one K-frame launch a band (``sharding.render_frames_mega_sharded``),
    the single-device batched sequence bit for bit. The band layout does
    not depend on the chunk's size, so a short last chunk renders as any
    other."""
    spp_size = mesh.shape["spp"]
    if spp_size > 1 and cfg.clamp_accumulate:
        raise ValueError(
            "spp-sharded progressive accumulation folds spp_size frames "
            "per step, which is not bit-equal under the reference's "
            "per-frame clamp; use HDR mode (clamp_accumulate=False) or "
            "an spp=1 mesh"
        )
    start = 0
    accum = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32)
    fingerprint = None
    if checkpoint_path is not None:
        with annotate(DRIVER_RESUME):
            fingerprint = ckpt.state_hash(
                scene, cameras if cameras is not None else camera, cfg
            )
            if reset_on_move:
                fingerprint += ":reset_on_move"
            if resume and os.path.exists(checkpoint_path):
                accum_np, start = ckpt.load(checkpoint_path, fingerprint)
                accum = torch.from_numpy(accum_np)
    end = start + frames
    if cameras is not None and len(cameras) < end:
        raise ValueError(
            f"cameras covers {len(cameras)} steps; rendering steps "
            f"[{start}, {end}) needs {end} (one camera a step: each step "
            f"renders {spp_size} frame seeds under it)"
        )
    bands = sharding.image_to_bands(accum, cfg, mesh)
    rows = sharding._bands(cfg, mesh)
    shape = dict(mesh.shape)

    def save(bands, step):
        with annotate(DRIVER_CHECKPOINT):
            ckpt.save(checkpoint_path,
                      sharding.mega_bands_to_image(bands, cfg), step,
                      fingerprint)

    if batch > 1:
        # chained cost maps as on one device, from a zeros map, as the JAX
        # package's sharded render_progressive starts them
        cmap = [torch.zeros(b.shape[:2], dtype=torch.int32, device=b.device)
                for b in bands]
        s = start
        while s < end:
            with annotate(DRIVER_STEP):
                k = min(batch, end - s)
                t0 = time.perf_counter()
                bands, segs, cmap = sharding.render_frames_mega_sharded(
                    scene, camera, cfg, s, bands, k, mesh, pair_costs=cmap
                )
                for band, (y0, _) in zip(bands, rows):
                    check_launch(s, k, {"accumulator": band}, row0=y0)
                with annotate(DRIVER_WAIT):
                    segs = int(segs)  # one host sync per chunk
                wall = time.perf_counter() - t0
                s += k
                if metrics is not None:
                    with annotate(DRIVER_LOG):
                        metrics.log(FrameMetrics(
                            frame=s - 1, wall_s=wall, rays=segs,
                            pixels=cfg.num_pixels, spp=cfg.spp * k,
                            extra={"batched_frames": k, "mesh": shape},
                        ))
                if (checkpoint_path is not None and checkpoint_every
                        and s // checkpoint_every
                        > (s - k) // checkpoint_every):
                    save(bands, s)
        if checkpoint_path is not None:
            save(bands, end)
        return sharding.mega_bands_to_image(bands, cfg)

    seg0 = start
    if reset_on_move:
        while seg0 > 0 and _same_cam(cameras[seg0 - 1], cameras[seg0]):
            seg0 -= 1
    for s in range(start, end):
        with annotate(DRIVER_STEP):
            cam = cameras[s] if cameras is not None else camera
            if (reset_on_move and s > start
                    and not _same_cam(cameras[s - 1], cam)):
                seg0 = s
            t0 = time.perf_counter()
            images, segs = sharding.render_frame_mega_bands(
                scene, cam, cfg, s * spp_size, mesh
            )
            with annotate(DRIVER_FOLD):
                ws = (s - seg0) if reset_on_move else s
                bands = [accumulate(acc, img, ws, clamp=cfg.clamp_accumulate)
                         for acc, img in zip(bands, images)]
                for band, img, (y0, _) in zip(bands, images, rows):
                    check_launch(s * spp_size, spp_size,
                                 {"image": img, "accumulator": band}, row0=y0)
            with annotate(DRIVER_WAIT):
                segs = int(segs)  # one host sync per step
            wall = time.perf_counter() - t0
            if metrics is not None:
                with annotate(DRIVER_LOG):
                    metrics.log(FrameMetrics(
                        frame=s, wall_s=wall, rays=segs,
                        pixels=cfg.num_pixels, spp=cfg.spp * spp_size,
                        extra={"mesh": shape},
                    ))
            if (checkpoint_path is not None and checkpoint_every
                    and (s + 1) % checkpoint_every == 0):
                save(bands, s + 1)
    if checkpoint_path is not None:
        save(bands, end)
    return sharding.mega_bands_to_image(bands, cfg)

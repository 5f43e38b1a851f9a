"""Multi-GPU rendering: the frame split into bands of rows over a mesh of
devices, and frame seeds over its second axis.

Counterpart of ``ray_tracing_extended_tpu/parallel/sharding.py``, with its
public names. A mesh is a ``(spp, tiles)`` grid of devices:

  * ``tiles``: the frame splits into horizontal bands of rows, one a column
    of the mesh, each rendered by the kernel's band launch
    (``kernels/megakernel.render_frames_mega(rows=...)``). A pixel's seed
    and camera ray are the whole frame's, so the bands stitch into the
    single-device image bit for bit, with adaptive refill too: there every
    band starts on a row of refill tiles, so it holds whole tiles, the
    whole frame's. No data moves between devices while they render.
  * ``spp``: each row of the mesh renders the same band with the frame
    seed ``frame + row``; their mean (summed in row order, divided once)
    merges them, the JAX module's one ``pmean``.

One process drives every device of the mesh, as the JAX module drives
``jax.devices()`` from one controller. Each band's scene, camera and
accumulator live on the band's device (``mesh.devices[0, t]``; a row's
frames are copied there for the mean), and a launch returns before the
device is done, so one host thread keeps every card busy. Bands stay on
their devices across steps; ``blocks_to_image`` and ``mega_bands_to_image``
gather them, for a checkpoint or the final image. A device may be listed
more than once (``make_mesh(["cuda:0"] * 4)``, or ``"cpu"`` eight times):
the analogue of JAX's virtual CPU devices.

The band layout, which is also the port's block layout: a list of
``tiles`` tensors, band ``t`` holding rows ``min(t * bh, H) .. min((t + 1) *
bh, H)`` of the frame on ``mesh.devices[0, t]``, ``bh`` being
``mega_band_height``. It has no padding rows: a band past the frame's last
row holds none and launches nothing. The band height depends on the
frame's height, the mesh and, with refill, the config's tile size only,
not on the scene or the batch. (The JAX module's depends on the TPU
kernel's tile size for the launch, which differs between batched and
single-frame launches, so a 1-frame tail chunk of a batched render
recomputes it and raises.)
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..kernels.megakernel import (
    BLOCK_Y,
    _tensor_leaves,
    refill_band_rows,
    render_frames_mega,
)
from ..models.geometry import Scene
from ..ops import vecmath as vm
from ..ops.accumulate import accumulate
from ..ops.camera import Camera
from ..utils.config import RenderConfig
from ..utils.device import resolve_device

__all__ = [
    "Mesh",
    "blocks_to_image",
    "image_to_bands",
    "init_accum_blocks",
    "init_accum_mega_bands",
    "make_mesh",
    "mega_band_height",
    "mega_bands_to_image",
    "render_frame_mega_bands",
    "render_frame_mega_sharded",
    "render_frame_sharded",
    "render_frames_mega_sharded",
    "render_step_sharded",
]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ``(spp, tiles)`` grid of devices: ``devices`` is an object array of
    ``torch.device``; ``shape`` maps each axis name to its size, as a
    ``jax.sharding.Mesh``'s does."""

    devices: np.ndarray

    @property
    def shape(self) -> dict:
        spp, tiles = self.devices.shape
        return {"spp": spp, "tiles": tiles}


def _device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices: Sequence | None = None, spp_parallel: int = 1) -> Mesh:
    """A ``(spp, tiles)`` mesh over ``devices`` (default: every visible
    card; raises where there is none): ``spp_parallel`` rows of devices
    render their own frame seeds of each band, and the rest split the
    frame into bands. A device may be listed more than once."""
    if devices is None:
        resolve_device("cuda")
        devices = range(torch.cuda.device_count())
    devices = [_device(d) for d in devices]
    n = len(devices)
    if spp_parallel < 1 or n == 0 or n % spp_parallel != 0:
        raise ValueError(
            f"spp_parallel={spp_parallel} does not divide device count {n}"
        )
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(spp_parallel, n // spp_parallel))


def mega_band_height(
    scene: Scene | None, cfg: RenderConfig, mesh: Mesh,
    batched: bool = False, paired: bool = False,
) -> int:
    """Rows a band: ``ceil(H / tiles)`` rounded up to whole rows of the
    kernel's blocks (``BLOCK_Y``), or with refill of its refill tiles
    (``refill_band_rows``, a multiple of every scene's tile side, as the
    JAX module makes its bands TS-aligned), so that every band starts on
    one. ``scene``, ``batched`` and ``paired`` are taken for the JAX
    module's signature and not read."""
    del scene, batched, paired
    per_band = -(-cfg.height // mesh.shape["tiles"])
    align = refill_band_rows(cfg) if cfg.adaptive_spp else BLOCK_Y
    return -(-per_band // align) * align


def _bands(cfg: RenderConfig, mesh: Mesh) -> list[tuple[int, int]]:
    """Each band's rows ``(y0, y1)``, ``y0 == y1`` past the last row."""
    bh, h = mega_band_height(None, cfg, mesh), cfg.height
    return [(min(t * bh, h), min((t + 1) * bh, h))
            for t in range(mesh.shape["tiles"])]


def _placed(obj, dev: torch.device):
    """``obj`` (a scene or a camera) on ``dev``: itself where it lies there,
    else a copy made once a device and kept on ``obj`` while none of its
    tensors is replaced or written to, so that a scene's kernel tables are
    built once a device too."""
    leaves = list(_tensor_leaves(obj))
    if leaves[0].device == dev:
        return obj
    key = tuple((id(t), t._version) for t in leaves)
    cache = obj.__dict__.setdefault("_replicas", {})
    if cache.get("key") != key:
        cache.clear()
        cache["key"] = key
    if dev not in cache:
        cache[dev] = obj.to(dev)
    return cache[dev]


def _render_band(scene, camera, cfg, frame0, n_frames, accum, rows, dev,
                 pair_costs=None):
    """``render_frames_mega`` over the band ``rows`` on ``dev`` -> ``(image
    or accum', total segments, per-pixel segments)``; a band with no row
    launches nothing. ``pair_costs``: the band's rows of a cost map."""
    y0, y1 = rows
    if y0 == y1:
        img = (torch.zeros((0, cfg.width, 3), dtype=torch.float32, device=dev)
               if accum is None else accum)
        return (img, torch.zeros((), dtype=torch.int64, device=dev),
                torch.zeros((0, cfg.width), dtype=torch.int32, device=dev))
    img, segs, seg_map, _ = render_frames_mega(
        _placed(scene, dev), _placed(camera, dev), cfg, frame0, n_frames,
        accum=accum, rows=rows,
        pair_costs=None if pair_costs is None else pair_costs.to(dev),
    )
    return img, segs, seg_map


def _total(values, dev: torch.device) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for v in values:
        total = total + v.to(dev)
    return total


def _mean(images: list[torch.Tensor]) -> torch.Tensor:
    """The mean of a band's spp rows on the first row's device: summed in
    row order, then one IEEE division (``vm.div``)."""
    dev = images[0].device
    total = images[0]
    for img in images[1:]:
        total = total + img.to(dev)
    return total if len(images) == 1 else vm.div(total, float(len(images)))


def _frames(scene, camera, cfg, frame, mesh):
    """Every device's frame ``frame + row`` of its band -> the rows' images
    of each band (launched first, merged after), and the segment total of
    every launch."""
    k = mesh.shape["spp"]
    outs = [
        [_render_band(scene, camera, cfg, (int(frame) + r) & 0xFFFFFFFF, 1,
                      None, rows, mesh.devices[r, t]) for r in range(k)]
        for t, rows in enumerate(_bands(cfg, mesh))
    ]
    images = [[img for img, _, _ in col] for col in outs]
    segs = _total([s for col in outs for _, s, _ in col], mesh.devices[0, 0])
    return images, segs


def render_frame_mega_bands(
    scene: Scene, camera: Camera, cfg: RenderConfig, frame, mesh: Mesh
):
    """``render_frame_mega_sharded`` without the gather -> ``(band layout
    of the frame's image, total segments on mesh.devices[0, 0])``."""
    images, segs = _frames(scene, camera, cfg, frame, mesh)
    return [_mean(col) for col in images], segs


def render_frame_mega_sharded(
    scene: Scene, camera: Camera, cfg: RenderConfig, frame, mesh: Mesh
):
    """One frame over the mesh -> ``((H, W, 3) image, total live segments)``,
    both on ``mesh.devices[0, 0]``: band ``t`` on the devices of column
    ``t``, mesh row ``r`` rendering frame ``frame + r``, then the mean over
    the rows. With one row the image is the single-device frame's bit for
    bit; with ``k`` rows it is ``vm.div(frame_0 + ... + frame_{k-1}, k)``."""
    bands, segs = render_frame_mega_bands(scene, camera, cfg, frame, mesh)
    return mega_bands_to_image(bands, cfg), segs


def init_accum_mega_bands(
    scene: Scene | None, cfg: RenderConfig, mesh: Mesh,
    batched: bool = False, paired: bool = False,
) -> list[torch.Tensor]:
    """A zero accumulator in band layout (the module's docstring). The
    flags are the JAX signature's and change nothing here."""
    del scene, batched, paired
    return [torch.zeros((y1 - y0, cfg.width, 3), dtype=torch.float32,
                        device=mesh.devices[0, t])
            for t, (y0, y1) in enumerate(_bands(cfg, mesh))]


def image_to_bands(image: torch.Tensor, cfg: RenderConfig,
                   mesh: Mesh) -> list[torch.Tensor]:
    """An (H, W, 3) image in band layout, each band copied to its device."""
    return [image[y0:y1].to(mesh.devices[0, t], torch.float32).contiguous()
            for t, (y0, y1) in enumerate(_bands(cfg, mesh))]


def mega_bands_to_image(accum_bands, cfg: RenderConfig) -> torch.Tensor:
    """Gather a band layout into the (H, W, 3) image on the first band's
    device."""
    dev = accum_bands[0].device
    image = torch.cat([b.to(dev) for b in accum_bands])
    if image.shape[0] != cfg.height:
        raise ValueError(f"bands hold {image.shape[0]} rows, not {cfg.height}")
    return image


def _check_layout(bands, cfg: RenderConfig, mesh: Mesh, what: str) -> None:
    rows = _bands(cfg, mesh)
    want = [((y1 - y0, cfg.width, 3), mesh.devices[0, t])
            for t, (y0, y1) in enumerate(rows)]
    got = [(tuple(b.shape), b.device) for b in bands]
    if got != want:
        raise ValueError(
            f"{what} is not this mesh's band layout: got {got}, want {want} "
            "(init_accum_mega_bands or image_to_bands make it)"
        )


def render_frames_mega_sharded(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    frame0,
    accum_bands,
    n_frames: int,
    mesh: Mesh,
    pair_costs=None,
):
    """``n_frames`` frames from ``frame0`` folded into ``accum_bands`` (band
    layout), one launch a band -> ``(accum_bands', total segments on
    mesh.devices[0, 0], per-pixel segment counts in band layout)``. Each
    band equals those rows of the single-device K-frame launch bit for bit,
    with ``pair_costs`` too: None, or a cost map in band layout (a previous
    call's per-pixel counts), which pairs a refill lane's pixels by cost
    where a lane has more than one (``render_frames_mega``; a refill band
    holds whole tiles). A ``tiles``-only mesh: the in-kernel K-frame fold
    is sequential and cannot merge across ``spp`` rows."""
    if mesh.shape["spp"] != 1:
        raise ValueError(
            "render_frames_mega_sharded composes the K-frame batch with the "
            "'tiles' band split only; spp_parallel must be 1 (the in-kernel "
            "sequential fold of K frames cannot merge across 'spp' rows)"
        )
    _check_layout(accum_bands, cfg, mesh, "accum_bands")
    costs = [None] * len(accum_bands) if pair_costs is None else pair_costs
    outs = [
        _render_band(scene, camera, cfg, frame0, n_frames, acc, rows,
                     mesh.devices[0, t], c)
        for t, (rows, acc, c) in enumerate(zip(_bands(cfg, mesh),
                                               accum_bands, costs))
    ]
    return ([o[0] for o in outs], _total([o[1] for o in outs],
                                          mesh.devices[0, 0]),
            [o[2] for o in outs])


def _step(scene, camera, cfg, accum, seed0, count0, mesh):
    """Render frames ``seed0 + row`` and fold them into ``accum`` (band
    layout) as the frames ``count0 .. count0 + k - 1`` of the average."""
    _check_layout(accum, cfg, mesh, "accum")
    k = mesh.shape["spp"]
    images, _ = _frames(scene, camera, cfg, seed0, mesh)
    out = []
    for acc, col in zip(accum, images):
        if cfg.clamp_accumulate and k > 1:
            # parity mode clamps every frame (Accumulate.shader:50): fold
            # the k frames one at a time
            for i, img in enumerate(col):
                acc = accumulate(acc, img.to(acc.device), count0 + i, clamp=True)
        else:
            # k frames of equal weight fold at once with k / (count0 + k)
            kt = torch.tensor(float(k), dtype=torch.float32)
            w = (kt / (torch.tensor(float(count0), dtype=torch.float32) + kt)
                 ).to(acc.device)
            acc = acc * (1.0 - w) + _mean(col) * w
            if cfg.clamp_accumulate:
                acc = vm.saturate(acc)
        out.append(acc)
    return out


def render_step_sharded(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    accum,
    frame,
    mesh: Mesh,
):
    """One progressive step over the mesh: mesh row ``r`` renders frame
    ``frame + r`` of every band, and the ``k`` rows' frames fold into the
    running average ``accum`` (band layout, ``init_accum_blocks``) ->
    ``accum'``. Their mean folds with weight ``k / (frame + k)``, which is
    folding them one at a time when nothing clamps between; in parity mode
    (``cfg.clamp_accumulate``) with ``k > 1`` they fold one at a time, each
    clamped, as the reference does."""
    return _step(scene, camera, cfg, accum, int(frame), int(frame), mesh)


def init_accum_blocks(cfg: RenderConfig, mesh: Mesh) -> list[torch.Tensor]:
    """A zero accumulator for ``render_step_sharded``. The port's block
    layout is its band layout (``init_accum_mega_bands``): the JAX module
    shards flat pixel blocks of its XLA path over ``tiles``, the port
    renders every band with the kernel's band launch."""
    return init_accum_mega_bands(None, cfg, mesh)


def blocks_to_image(accum_blocks, cfg: RenderConfig) -> torch.Tensor:
    """Gather the block (band) layout into the (H, W, 3) image."""
    return mega_bands_to_image(accum_blocks, cfg)


def render_frame_sharded(
    scene: Scene, camera: Camera, cfg: RenderConfig, frame, mesh: Mesh
) -> torch.Tensor:
    """Frame ``frame`` over the mesh, without accumulation -> the (H, W, 3)
    image on ``mesh.devices[0, 0]``: the mean of the frame seeds
    ``frame * k .. frame * k + k - 1`` (``k`` mesh rows), clamped per
    ``cfg.clamp_accumulate`` as a first step of ``render_step_sharded``
    would be. (The JAX module folds it with the weight of step ``frame``,
    which scales any frame but the first by ``1 / (frame + 1)``.)"""
    k = mesh.shape["spp"]
    out = _step(scene, camera, cfg, init_accum_blocks(cfg, mesh),
                int(frame) * k, 0, mesh)
    return blocks_to_image(out, cfg)
